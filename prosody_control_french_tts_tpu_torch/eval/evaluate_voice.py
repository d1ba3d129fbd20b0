"""Per-voice objective evaluation driver (evaluate_voice.ipynb parity).

For each voice with results: DTW-aligned log-F0 RMSE between the natural
merged audio and OUT.wav, break F1 from the pause comparison artifacts,
and WER between the intended text and the final transcription. Emits one
JSON per voice plus a corpus summary — the notebook's per-episode
parallel driver as a plain module.

Counterpart of the JAX package's ``eval/evaluate_voice.py``; ``device``
(CUDA by default) is where ``f0_rmse_dtw`` builds its DTW. ``evaluate_all``
records a voice whose evaluation raised as ``{"error": ...}`` and goes on
with the next, as the JAX driver does: a caller that must not pass over a
device fault checks the report for ``"error"``.
"""

from __future__ import annotations

import csv
import json
import logging
from pathlib import Path

import numpy as np

from ..utils.wavio import read_wav
from .metrics import break_f1, f0_rmse_dtw, wer

log = logging.getLogger(__name__)


def evaluate_voice(results_dir: Path, voice_dir: Path, max_seconds: float = 120.0, device="cuda") -> dict:
    """results_dir: Out/results/<voice>; voice_dir: Data/voice/<voice>."""
    out: dict = {"voice": results_dir.name}

    out_wav = results_dir / "OUT.wav"
    nat_parts = sorted((voice_dir / "audio").glob("segment_ph*.wav"))
    if out_wav.exists() and nat_parts:
        from ..audio.merge import merge_wavs

        nat = merge_wavs(nat_parts)
        syn = read_wav(out_wav).to_mono()
        n = int(max_seconds * nat.rate)
        out["f0_rmse_log2"] = f0_rmse_dtw(
            np.asarray(nat.samples[:n], np.float32), np.asarray(syn.samples[:n], np.float32), nat.rate,
            device=device,
        )

    pause_csv = results_dir / "pause_comparison_full.csv"
    if pause_csv.exists():
        with open(pause_csv, newline="", encoding="utf-8") as f:
            rows = list(csv.DictReader(f))
        expected = [int(float(r["nat_voice_ms"])) for r in rows]
        measured = [int(float(r["synth_voice_ms"])) for r in rows if float(r["synth_voice_ms"]) > 0]
        out["break"] = break_f1(expected, measured, tol_ms=100)
        if rows:
            diffs = [abs(float(r["diff_ms"])) for r in rows]
            out["break_avg_abs_diff_ms"] = float(np.mean(diffs))

    final_txt = results_dir / "transcription_final.txt"
    txt_dir = voice_dir / "transcription"
    if final_txt.exists() and txt_dir.is_dir():
        ref = " ".join(
            p.read_text(encoding="utf-8").strip() for p in sorted(txt_dir.glob("segment_ph*.txt"))
        )
        hyp = final_txt.read_text(encoding="utf-8").strip()
        if ref:
            out["wer"] = wer(ref.lower(), hyp.lower())
    return out


def evaluate_all(out_dir: Path, data_dir: Path, report_path: Path | None = None, device="cuda") -> dict:
    results_root = Path(out_dir) / "results"
    reports = {}
    for voice in sorted(p for p in results_root.iterdir() if p.is_dir()):
        try:
            reports[voice.name] = evaluate_voice(voice, Path(data_dir) / voice.name, device=device)
        except Exception as e:  # noqa: BLE001 — per-voice isolation
            log.warning("evaluation failed for %s: %s", voice.name, e)
            reports[voice.name] = {"voice": voice.name, "error": str(e)}
    summary = {"voices": reports}
    rmses = [r["f0_rmse_log2"] for r in reports.values() if "f0_rmse_log2" in r]
    if rmses:
        summary["mean_f0_rmse_log2"] = float(np.mean(rmses))
    if report_path:
        Path(report_path).write_text(json.dumps(summary, indent=2), encoding="utf-8")
    return summary
