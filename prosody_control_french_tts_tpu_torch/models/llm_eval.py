"""Cascaded-LLM evaluation (the reference's stage-A / stage-B test scripts).

Stage A (text → SSML-with-breaks) metrics: exact match, break-presence
precision/recall/F1 (position-wise on word gaps), and teacher-forced
perplexity of the gold continuation.

Stage B (template → valued SSML) metrics: regex parameter extraction, raw
and z-normalised MSE/MAE/RMSE/R² per parameter
(pitch/rate/volume/break-time).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.kernels import dsp_precision, resolve_device
from .llm import DecoderLM, require_on


# ---------------------------------------------------------------------------
# stage A
# ---------------------------------------------------------------------------


def break_positions(text_with_breaks: str) -> tuple[list[str], set[int]]:
    """Words + the set of gap indices carrying a <break/> after them."""
    words = []
    breaks = set()
    for tok in text_with_breaks.split():
        if tok == "<break/>":
            if words:
                breaks.add(len(words) - 1)
        else:
            words.append(tok)
    return words, breaks


@dataclass
class StageAMetrics:
    exact_match: float
    break_precision: float
    break_recall: float
    break_f1: float
    perplexity: float
    n: int


def evaluate_stage_a(predictions: list[str], references: list[str], perplexities: list[float] | None = None) -> StageAMetrics:
    exact = 0
    tp = fp = fn = 0
    for pred, ref in zip(predictions, references):
        if pred.strip() == ref.strip():
            exact += 1
        _, pb = break_positions(pred)
        _, rb = break_positions(ref)
        tp += len(pb & rb)
        fp += len(pb - rb)
        fn += len(rb - pb)
    prec = tp / (tp + fp) if tp + fp else 0.0
    rec = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    ppl = float(np.mean(perplexities)) if perplexities else 0.0
    return StageAMetrics(
        exact_match=exact / max(len(predictions), 1),
        break_precision=prec,
        break_recall=rec,
        break_f1=f1,
        perplexity=ppl,
        n=len(predictions),
    )


@torch.no_grad()
def teacher_forced_perplexity(model: DecoderLM, prompt_ids, target_ids, device="cuda") -> float:
    """exp(mean NLL of the target tokens given the prompt), one
    teacher-forced forward. The model must be on ``device``."""
    dev = resolve_device(device)
    require_on(model.embed.embedding, dev, "the model")
    dsp_precision()
    prompt = torch.as_tensor(prompt_ids).to(dev, torch.int64)
    ids = torch.cat([prompt, torch.as_tensor(target_ids).to(dev, torch.int64)], dim=-1)[None, :]
    logits = model(ids)
    logp = torch.log_softmax(logits[0, :-1], dim=-1)
    start = prompt.shape[-1] - 1
    ll = torch.gather(logp, -1, ids[0, 1:, None])[:, 0][start:]
    return float(torch.exp(-ll.mean()))


# ---------------------------------------------------------------------------
# stage B
# ---------------------------------------------------------------------------

_PARAMS = {
    "pitch": re.compile(r'pitch="([+-]?\d+(?:\.\d+)?)%"'),
    "rate": re.compile(r'rate="([+-]?\d+(?:\.\d+)?)%"'),
    "volume": re.compile(r'volume="([+-]?\d+(?:\.\d+)?)%"'),
    "break_ms": re.compile(r'<break time="(\d+)ms"'),
}


def extract_ssml_parameters(ssml: str) -> dict[str, list[float]]:
    """All numeric prosody parameters in document order."""
    return {k: [float(v) for v in rx.findall(ssml)] for k, rx in _PARAMS.items()}


@dataclass
class StageBMetrics:
    raw: dict[str, dict[str, float]]
    z: dict[str, dict[str, float]]
    matched: int
    total: int


def evaluate_stage_b(predictions: list[str], references: list[str]) -> StageBMetrics:
    gold: dict[str, list[float]] = {k: [] for k in _PARAMS}
    pred: dict[str, list[float]] = {k: [] for k in _PARAMS}
    matched = 0
    for p_ssml, r_ssml in zip(predictions, references):
        pv = extract_ssml_parameters(p_ssml)
        rv = extract_ssml_parameters(r_ssml)
        ok = True
        for k in _PARAMS:
            if len(pv[k]) != len(rv[k]):
                ok = False
            n = min(len(pv[k]), len(rv[k]))
            gold[k].extend(rv[k][:n])
            pred[k].extend(pv[k][:n])
        matched += ok

    def metrics(g: np.ndarray, p: np.ndarray) -> dict[str, float]:
        if g.size == 0:
            return {"mse": 0.0, "mae": 0.0, "rmse": 0.0, "r2": 0.0}
        err = p - g
        mse = float(np.mean(err**2))
        ss_tot = float(np.sum((g - g.mean()) ** 2))
        return {
            "mse": mse,
            "mae": float(np.mean(np.abs(err))),
            "rmse": float(np.sqrt(mse)),
            "r2": 1.0 - float(np.sum(err**2)) / ss_tot if ss_tot > 0 else 0.0,
        }

    raw = {}
    zed = {}
    for k in _PARAMS:
        g = np.asarray(gold[k])
        p = np.asarray(pred[k])
        raw[k] = metrics(g, p)
        if g.size and g.std() > 1e-9:
            zed[k] = metrics((g - g.mean()) / g.std(), (p - g.mean()) / g.std())
        else:
            zed[k] = metrics(g, p)
    return StageBMetrics(raw=raw, z=zed, matched=matched, total=len(predictions))
