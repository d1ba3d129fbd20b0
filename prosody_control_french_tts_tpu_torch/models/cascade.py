"""The cascaded SSML tagger: stage-A / stage-B LoRA fine-tuning + inference.

Parity with the reference's Qwen cascade:

- instruction format ``### Task:\\n…\\n### Text:\\n…\\n### SSML:\\n…`` with
  the loss masked over the prompt;
- stage A: plain text → text with ``<break/>`` markers;
- stage B: placeholder template (``_%``/``_ms``) → fully valued SSML;
- LoRA-only updates, gradient accumulation (``models.training``);
- greedy KV-cache generation for evaluation (``models.llm_eval`` metrics).

The tokenizer is the hermetic WordPiece (``<break/>``, ``###`` etc. survive
as multi-piece sequences; exactness of surface reconstruction is what the
evaluation measures).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .llm import DecoderLM, LLMConfig, greedy_generate
from .tokenizer import WordPieceTokenizer
from .training import init_train, make_train_step

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


def train_stage(
    pairs: list[dict],
    tokenizer: WordPieceTokenizer,
    task: str = TASK_A,
    cfg: LLMConfig | None = None,
    epochs: int = 5,  # the reference's epoch count
    batch_size: int = 4,
    accum: int = 1,
    lr: float = 3e-4,  # the reference's learning rate
    seed: int = 0,
    x_key: str = "x",
    y_key: str = "y",
    ckpt_dir=None,
    ckpt_keep: int = 2,
    device="cuda",
):
    """Fine-tune one stage on ``pairs``: every epoch a fresh permutation of
    the examples (``np.random.default_rng(seed)``), batches of ``batch_size``
    in that order, the last one short. Returns (model, params, losses) with
    ``params`` the trained model's ``state_dict()``. With ``ckpt_dir``, saves
    ``{"params": state_dict}`` after each epoch as step ``epoch + 1``
    (``core.checkpoint``, keep-last-``ckpt_keep``: the HF-Trainer
    ``save_total_limit=2`` contract, QwenB.py:218)."""
    cfg = cfg or LLMConfig(vocab_size=len(tokenizer), dim=128, layers=2, heads=4, kv_heads=2, ffn=256, max_len=256)
    batch = build_batches(pairs, tokenizer, task, cfg.max_len, x_key, y_key)
    model, tx, state = init_train(cfg, seed=seed, lr=lr, accum=accum, device=device)
    step = make_train_step(model, tx, trainable=state.mask)
    losses = []
    rng = np.random.default_rng(seed)
    n = batch.ids.shape[0]
    for epoch in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n, batch_size):
            b = order[i : i + batch_size]
            losses.append(float(step(batch.ids[b], batch.loss_mask[b])))
        if ckpt_dir is not None:
            from ..core.checkpoint import save_train_state

            save_train_state(ckpt_dir, epoch + 1, {"params": model.state_dict()}, keep=ckpt_keep)
    return model, model.state_dict(), losses


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
