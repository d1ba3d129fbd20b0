"""The cascaded SSML tagger: stage-A / stage-B inference.

Parity with the reference's Qwen cascade:

- instruction format ``### Task:\\n…\\n### Text:\\n…\\n### SSML:\\n…`` with
  the loss masked over the prompt;
- stage A: plain text → text with ``<break/>`` markers;
- stage B: placeholder template (``_%``/``_ms``) → fully valued SSML;
- greedy KV-cache generation for evaluation (``models.llm_eval`` metrics).

The tokenizer is the hermetic WordPiece (``<break/>``, ``###`` etc. survive
as multi-piece sequences; exactness of surface reconstruction is what the
evaluation measures). Stage training (``train_stage`` of the JAX package)
comes with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .llm import DecoderLM, greedy_generate
from .tokenizer import WordPieceTokenizer

TASK_A = "Insert <break/> tags where a speaker would pause."
TASK_B = "Fill prosody values into the SSML template."


def format_example(task: str, x: str, y: str | None) -> str:
    """### Task/### Text/### SSML instruction format."""
    prompt = f"### Task:\n{task}\n### Text:\n{x}\n### SSML:\n"
    return prompt + (y if y is not None else "")


@dataclass
class CascadeBatch:
    ids: np.ndarray  # [B, L]
    loss_mask: np.ndarray  # [B, L] 1.0 on completion tokens


def build_batches(
    pairs: list[dict],
    tokenizer: WordPieceTokenizer,
    task: str,
    max_len: int,
    x_key: str = "x",
    y_key: str = "y",
) -> CascadeBatch:
    B = len(pairs)
    ids = np.full((B, max_len), tokenizer.pad_id, np.int32)
    mask = np.zeros((B, max_len), np.float32)
    for i, p in enumerate(pairs):
        prompt_ids = tokenizer.encode(format_example(task, p[x_key], None))[:-1]  # drop [SEP]
        full_ids = prompt_ids + tokenizer.encode(p[y_key])[1:]  # drop [CLS], keep [SEP]
        full_ids = full_ids[:max_len]
        ids[i, : len(full_ids)] = full_ids
        mask[i, min(len(prompt_ids), max_len) : len(full_ids)] = 1.0
    return CascadeBatch(ids=ids, loss_mask=mask)


def generate(
    model: DecoderLM,
    tokenizer: WordPieceTokenizer,
    task: str,
    x: str,
    max_new: int = 128,
    device="cuda",
) -> str:
    """One stage: prompt → greedy continuation up to ``[SEP]`` → text. The
    model must be on ``device``."""
    prompt_ids = tokenizer.encode(format_example(task, x, None))[:-1]
    prompt_ids = prompt_ids[-(model.cfg.max_len - max_new) :]
    toks = greedy_generate(model, np.asarray([prompt_ids], np.int32), max_new, eos_id=tokenizer.sep_id, device=device)
    out_ids = toks[0, len(prompt_ids) :].tolist()
    if tokenizer.sep_id in out_ids:
        out_ids = out_ids[: out_ids.index(tokenizer.sep_id)]
    return tokenizer.decode(out_ids)


def run_cascade(model_a: DecoderLM, model_b: DecoderLM, tokenizer: WordPieceTokenizer, text: str, device="cuda") -> str:
    """Full two-stage inference: text → breaks → valued SSML."""
    with_breaks = generate(model_a, tokenizer, TASK_A, text, device=device)
    return generate(model_b, tokenizer, TASK_B, with_breaks, device=device)
