"""Objective evaluation metrics (Code/Pipeline/evaluate_voice.ipynb parity).

- DTW-aligned log-F0 RMSE (the notebook's ``compute_f0_rmse`` with
  torchcrepe+fastdtw → here: YIN on the host, or the Boersma tracker with
  kernels A and B, and the DTW of ``ops.dtw`` on the device);
- break precision/recall/F1 with a time tolerance;
- WER via word-level edit distance (jiwer equivalence).

Counterpart of the JAX package's ``eval/metrics.py``. ``device`` (CUDA by
default) is where ``f0_contour(method="boersma")`` tracks pitch and where
``f0_rmse_dtw`` builds its DTW cost matrix; without a card they raise
unless given ``device="cpu"``. The default YIN contour, ``wer`` and
``break_f1`` run on the host.
"""

from __future__ import annotations

import numpy as np

from ..ops.dtw import dtw_path
from ..ops.pitch import PitchParams, praat_pitch


def normalize_asr_text(text: str) -> str:
    """Whisper's BasicTextNormalizer semantics (openai/whisper
    normalizers/basic.py, the published ASR-eval convention): lowercase,
    strip diacritics (NFKD, drop combining marks), every non-alphanumeric
    character — apostrophes and hyphens included — becomes a space, runs
    collapse. French elisions split ("l'histoire" → "l histoire") on BOTH
    sides of a WER comparison, so hypothesis and reference are scored in
    the same orthographic space regardless of accent/punctuation style."""
    import unicodedata

    text = unicodedata.normalize("NFKD", text.lower())
    out = []
    for ch in text:
        if unicodedata.combining(ch):
            continue
        out.append(ch if ch.isalnum() else " ")
    return " ".join("".join(out).split())


def wer(reference: str, hypothesis: str) -> float:
    """Word error rate = (S+D+I)/N — jiwer.wer semantics."""
    ref = reference.split()
    hyp = hypothesis.split()
    if not ref:
        return 0.0 if not hyp else 1.0
    # intern words to int codes, then roll rows with vectorised numpy (the
    # scalar double loop is too slow for episode-length transcripts)
    codes = {w: k for k, w in enumerate(dict.fromkeys(ref + hyp))}
    r = np.array([codes[w] for w in ref], np.int32)
    h = np.array([codes[w] for w in hyp], np.int32)
    prev = np.arange(len(h) + 1, dtype=np.int32)
    for i in range(1, len(r) + 1):
        sub = prev[:-1] + (h != r[i - 1])
        cur = np.minimum(prev[1:] + 1, sub)
        # the insertion term cur[j-1]+1 is a sequential prefix dependency:
        # resolve it with a running-minimum scan of (cur[j] - j)
        cur = np.minimum.accumulate(np.concatenate(([i], cur)) - np.arange(len(h) + 1)) + np.arange(
            len(h) + 1
        )
        prev = cur
    return float(prev[-1]) / len(ref)


def f0_contour(
    x: np.ndarray, sr: int, floor: float = 60.0, ceiling: float = 600.0, method: str = "yin", device="cuda"
) -> np.ndarray:
    """F0 contour for eval (0 = unvoiced). Default tracker is YIN
    (eval.yin) — an INDEPENDENT estimator, so voice evaluation does not
    grade the pipeline's own Boersma kernel with itself (the reference uses
    torchcrepe in evaluate_voice.ipynb for the same independence).
    ``method="boersma"`` selects the production kernel (ops.pitch) — used
    by the cross-method agreement harness, on ``device``."""
    if method == "yin":
        from .yin import yin_track

        return yin_track(np.asarray(x, np.float32), sr, fmin=floor, fmax=ceiling)
    tr = praat_pitch(
        np.asarray(x, np.float32), sr, PitchParams(floor=floor, ceiling=ceiling), device=device
    )
    return tr.f0.cpu().numpy()


def f0_rmse_dtw(nat: np.ndarray, syn: np.ndarray, sr: int, device="cuda") -> float:
    """DTW-aligned RMSE between log-F0 contours of two signals
    (evaluate_voice.ipynb ``compute_f0_rmse``: log2 F0, voiced frames only,
    fastdtw path, RMSE over aligned pairs). The contours are YIN's, on the
    host; the DTW's [voiced_nat, voiced_syn] cost matrix is built on
    ``device``."""
    f_nat = f0_contour(nat, sr)
    f_syn = f0_contour(syn, sr)
    v_nat = np.log2(f_nat[f_nat > 0]) if (f_nat > 0).any() else np.zeros(1)
    v_syn = np.log2(f_syn[f_syn > 0]) if (f_syn > 0).any() else np.zeros(1)
    _, path = dtw_path(v_nat, v_syn, device=device)
    err = np.array([v_nat[i] - v_syn[j] for i, j in path])
    return float(np.sqrt(np.mean(err**2)))


def break_f1(
    expected_ms: list[int], measured_ms: list[int], tol_ms: int = 100
) -> dict[str, float]:
    """Greedy one-to-one matching of break positions within a tolerance
    (the notebook's break-F1)."""
    used = set()
    tp = 0
    for e in expected_ms:
        best = None
        for k, m in enumerate(measured_ms):
            if k in used:
                continue
            if abs(m - e) <= tol_ms and (best is None or abs(m - e) < abs(measured_ms[best] - e)):
                best = k
        if best is not None:
            used.add(best)
            tp += 1
    fp = len(measured_ms) - tp
    fn = len(expected_ms) - tp
    prec = tp / (tp + fp) if tp + fp else 0.0
    rec = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return {"precision": prec, "recall": rec, "f1": f1, "tp": tp, "fp": fp, "fn": fn}
