"""Evaluation: break fidelity, prosody metrics, WER, aligner gold harness."""

from .breaks import compare_breaks, BreakReport  # noqa: F401
from .metrics import wer, f0_rmse_dtw, break_f1  # noqa: F401
