"""Datasets: training JSON (bdd.json) → model-ready arrays.

Covers the data plumbing of all reference model families:

- break tagging pairs (pause_bert.py:33-99: BREAK label on the last word
  before a <break/>, first-subtoken labeling, −100 ignore index);
- prosody regression targets (bilstm.py:28-95: per-sentence
  [pitch%, volume%, rate%] with z-score calibration, sliding windows);
- QwenA text→breaks pairs with ≤100-word chunking at sentence ends
  (data_formatting_QwenA.py:5-53) and 80/10/10 split (:82-158);
- QwenB (x, y, z) triples: y full SSML, z the ``_%``/``_ms`` placeholder
  template (data_formatting_QwenB.py:221-295).

Host only (numpy): the port's own copy of the JAX package's module.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np

IGNORE = -100


# ---------------------------------------------------------------------------
# parsed_sequence traversal
# ---------------------------------------------------------------------------


def iter_voice_entries(bdd: dict):
    """bdd.json = {voice: {x, y:{parsed_sequence,...}}}. Yields (voice,
    parsed_sequence)."""
    for voice, entry in bdd.items():
        yield voice, entry["y"]["parsed_sequence"]


def sequence_to_break_words(parsed_sequence: list[dict]) -> list[tuple[str, bool]]:
    """[(word, has_break_after)] — break attaches to the last word of the
    text run before a break element (pause_bert.py:54-63)."""
    out: list[tuple[str, bool]] = []
    for item in parsed_sequence:
        if item["type"] == "text":
            words = item["text"].split()
            out.extend((w, False) for w in words)
        elif item["type"] == "break" and out:
            w, _ = out[-1]
            out[-1] = (w, True)
    return out


def sequence_to_prosody_rows(parsed_sequence: list[dict]) -> list[dict]:
    """[{text, pitch, volume, rate}] — one row per text run, percentages
    parsed from the '+X.XX%' strings (bilstm.py/create_training_data)."""

    def pct(s: str) -> float:
        m = re.match(r"([+-]?\d+(?:\.\d+)?)%", s or "")
        return float(m.group(1)) if m else 0.0

    rows = []
    for item in parsed_sequence:
        if item["type"] == "text" and item["text"].strip():
            p = item.get("prosody", {})
            rows.append(
                {
                    "text": item["text"].strip(),
                    "pitch": pct(p.get("pitch", "")),
                    "volume": pct(p.get("volume", "")),
                    "rate": pct(p.get("rate", "")),
                }
            )
    return rows


# ---------------------------------------------------------------------------
# break-tagger dataset (pause_bert parity)
# ---------------------------------------------------------------------------


@dataclass
class BreakTagDataset:
    ids: np.ndarray  # [N, L] int32
    mask: np.ndarray  # [N, L] bool
    labels: np.ndarray  # [N, L] int32 (-100 ignore; 1=BREAK on first subtoken)


def build_break_dataset(bdd: dict, tokenizer, max_len: int = 128, sentences_per_example: int = 1):
    """Sentence-level examples (split at break-or-period boundaries),
    tokenized with first-subtoken labels."""
    examples: list[list[tuple[str, bool]]] = []
    for _, seq in iter_voice_entries(bdd):
        words = sequence_to_break_words(seq)
        # split into sentences at words ending with . ? !
        cur: list[tuple[str, bool]] = []
        for w, brk in words:
            cur.append((w, brk))
            if w.endswith((".", "?", "!")):
                examples.append(cur)
                cur = []
        if cur:
            examples.append(cur)

    if sentences_per_example > 1:
        merged = [
            sum(examples[i : i + sentences_per_example], [])
            for i in range(0, len(examples), sentences_per_example)
        ]
        examples = merged

    N = len(examples)
    ids = np.full((N, max_len), tokenizer.pad_id, np.int32)
    mask = np.zeros((N, max_len), bool)
    labels = np.full((N, max_len), IGNORE, np.int32)
    for n, ex in enumerate(examples):
        tok_ids, word_idx = tokenizer.encode_words([w for w, _ in ex])
        tok_ids = tok_ids[:max_len]
        word_idx = word_idx[:max_len]
        ids[n, : len(tok_ids)] = tok_ids
        mask[n, : len(tok_ids)] = True
        for t, wi in enumerate(word_idx):
            if wi >= 0:
                labels[n, t] = 1 if ex[wi][1] else 0
    return BreakTagDataset(ids=ids, mask=mask, labels=labels)


# ---------------------------------------------------------------------------
# QwenA / QwenB formatting
# ---------------------------------------------------------------------------


def text_with_breaks(parsed_sequence: list[dict]) -> str:
    """y of stage A: plain text with ``<break/>`` markers
    (data_formatting_QwenA.py output shape)."""
    parts = []
    for item in parsed_sequence:
        if item["type"] == "text":
            parts.append(item["text"].strip())
        elif item["type"] == "break":
            parts.append("<break/>")
    return " ".join(parts)


def chunk_at_sentences(text: str, max_words: int = 100) -> list[str]:
    """≤max_words chunks split at sentence periods
    (data_formatting_QwenA.py:5-53)."""
    words = text.split()
    chunks: list[str] = []
    cur: list[str] = []
    for w in words:
        cur.append(w)
        if len(cur) >= max_words:
            # backtrack to the last sentence end inside the window
            cut = None
            for i in range(len(cur) - 1, -1, -1):
                if cur[i].rstrip("<break/>").endswith((".", "?", "!")):
                    cut = i + 1
                    break
            if cut is None:
                cut = len(cur)
            chunks.append(" ".join(cur[:cut]))
            cur = cur[cut:]
    if cur:
        chunks.append(" ".join(cur))
    return chunks


def qwen_a_pairs(bdd: dict, max_words: int = 100) -> list[dict]:
    """Stage A (x: plain text → y: text with <break/>), chunked."""
    pairs = []
    for _, seq in iter_voice_entries(bdd):
        y_full = text_with_breaks(seq)
        for chunk in chunk_at_sentences(y_full, max_words):
            x = re.sub(r"\s*<break/>\s*", " ", chunk).strip()
            if x:
                pairs.append({"x": x, "y": chunk.strip()})
    return pairs


def _format_x_from_parsed(tokens: list[dict]) -> str:
    """'x': text interspersed with bare <break/> tags
    (data_formatting_QwenB.py:98-112)."""
    parts = []
    for t in tokens:
        if t.get("type") == "text":
            parts.append(t.get("text", ""))
        elif t.get("type") == "break":
            parts.append("<break/>")
    return "".join(parts)


def _format_yz_from_parsed(tokens: list[dict], template: bool) -> str:
    """'y' (template=False) / 'z' (template=True): the reference's
    pretty-printed block layout (data_formatting_QwenB.py:115-295) —
    2-space-indented <prosody> blocks with 4-space-indented text, break
    groups collapsed onto one line, a blank line between a break group and
    a following prosody block, leading space. 'z' replaces every attribute
    value with its placeholder (always all three prosody attrs, '_%';
    breaks '<break time="_ms"/>')."""
    elements: list[str] = []
    idx = 0
    n = len(tokens)
    while idx < n:
        t = tokens[idx]
        ttype = t.get("type", "")
        if ttype == "text":
            text = t.get("text", "")
            if template:
                attr = ' pitch="_%" rate="_%" volume="_%"'
            else:
                pros = t.get("prosody", {})
                parts = [
                    f'{k}="{pros[k]}"' for k in ("pitch", "rate", "volume") if k in pros
                ]
                attr = (" " + " ".join(parts)) if parts else ""
            elements.append(f"  <prosody{attr}>\n    {text}\n  </prosody>")
            idx += 1
        elif ttype == "break":
            tags = []
            while idx < n and tokens[idx].get("type") == "break":
                if template:
                    tags.append('<break time="_ms"/>')
                else:
                    tv = tokens[idx].get("time")
                    tags.append(f'<break time="{tv}"/>' if tv else "<break/>")
                idx += 1
            elements.append("  " + "".join(tags))
        else:  # passthrough for token types the pipeline never emits
            if t.get("text"):
                elements.append(f"  {t['text']}")
            idx += 1
    out: list[str] = []
    for i, el in enumerate(elements):
        out.append(el)
        if "  <break" in el and i + 1 < len(elements) and elements[i + 1].startswith("  <prosody"):
            out.append("")  # blank line between break group and prosody
    return (" " + "\n".join(out)) if out else ""


def _chunk_parsed_tokens(tokens: list[dict], max_words: int = 100) -> list[list[dict]]:
    """~100-word chunks of a parsed token sequence, closing a chunk before
    the text token that would overflow (data_formatting_QwenB.py:300-360;
    the reference additionally splits inside an oversized text token at the
    nearest period — pipeline syntagmes are short, so token-boundary
    chunking covers the same data)."""
    chunks: list[list[dict]] = []
    cur: list[dict] = []
    words = 0
    for t in tokens:
        n_new = len(t.get("text", "").split()) if t.get("type") == "text" else 0
        if cur and words + n_new > max_words:
            chunks.append(cur)
            cur, words = [], 0
        cur.append(t)
        words += n_new
    if cur:
        chunks.append(cur)
    return chunks


def qwen_b_triples(bdd: dict, max_words: int = 100) -> list[dict]:
    """Stage B triples (x: text+breaks, y: structured full SSML, z:
    placeholder template) in the reference's convert_breaks_to_full_ssml
    FORMAT (data_formatting_QwenB.py:300-380): ~100-word chunks,
    pretty-printed y/z.

    Deliberate composition divergence from the reference: tokens are
    grouped PER SEGMENT and breakless segments are dropped, where the
    reference chunks each entry's whole parsed_sequence (chunks may span
    segments, and breakless chunks survive once the entry has any break).
    Segment-level grouping keeps every chunk attributable to one audio
    segment — which our eval joins on — at the cost of dropping breakless
    segments the reference would keep; the per-triple string FORMAT is
    unchanged."""
    triples = []
    for voice, entry in bdd.items():
        parsed = entry["y"].get("parsed_sequence") or []
        by_seg: dict[str, list[dict]] = {}
        for tok in parsed:
            by_seg.setdefault(tok.get("segment", ""), []).append(tok)
        for seg, tokens in by_seg.items():
            if not any(t.get("type") == "break" for t in tokens):
                continue  # break-containing entries only (:322-324)
            for chunk in _chunk_parsed_tokens(tokens, max_words):
                x = _format_x_from_parsed(chunk).strip()
                if not x:
                    continue
                triples.append(
                    {
                        "segment": seg,
                        "x": x,
                        "y": _format_yz_from_parsed(chunk, template=False),
                        "z": _format_yz_from_parsed(chunk, template=True),
                    }
                )
    return triples


def split_80_10_10(items: list, seed: int = 42) -> dict[str, list]:
    """Shuffled 80/10/10 split (data_formatting_QwenA.py:82-158)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(items))
    n = len(items)
    n_tr = int(n * 0.8)
    n_va = int(n * 0.1)
    return {
        "train": [items[i] for i in idx[:n_tr]],
        "val": [items[i] for i in idx[n_tr : n_tr + n_va]],
        "test": [items[i] for i in idx[n_tr + n_va :]],
    }


def load_bdd(path: str | Path) -> dict:
    return json.loads(Path(path).read_text(encoding="utf-8"))
