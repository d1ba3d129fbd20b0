"""Cross-corpus prosody comparisons with feature caching.

Parity with Code/visualisation/Compare_speech_noenhanced.py: per-file mean
pitch / loudness / duration for two corpora, cached to disk, rendered as
scatter / histogram / boxplot / z-score figures. Features come from the
port's pitch tracker (kernels A and B, one launch each per file on
``device``) and ``dbfs`` on the host instead of per-file Praat.
``compare_corpora`` imports matplotlib when it is called, not before.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from ..ops.energy import dbfs
from ..ops.kernels import resolve_device
from ..ops.pitch import PitchParams, praat_pitch
from ..utils.wavio import read_wav

log = logging.getLogger(__name__)


def extract_features(
    corpus_dir: str | Path, cache: str | Path | None = None, max_files: int | None = None, device="cuda"
) -> dict[str, np.ndarray]:
    """{pitch_mean, loudness_dbfs, duration_s} arrays over *.wav, cached
    as npz (the reference's per-feature pickle cache, :223); pitch tracked
    on ``device`` (CUDA by default; without a card it raises unless given
    ``device="cpu"``)."""
    resolve_device(device)
    corpus_dir = Path(corpus_dir)
    if cache is not None and Path(cache).exists():
        data = np.load(cache, allow_pickle=True)
        return {k: data[k] for k in data.files}
    wavs = sorted(corpus_dir.glob("*.wav"))
    if max_files:
        wavs = wavs[:max_files]
    pitch, loud, dur, names = [], [], [], []
    for w in wavs:
        try:
            a = read_wav(w).to_mono()
        except (ValueError, FileNotFoundError):
            continue
        x = np.asarray(a.samples, np.float32)
        tr = praat_pitch(x, a.rate, PitchParams(floor=75.0, ceiling=600.0), device=device)
        f0 = tr.f0.cpu().numpy()
        v = f0[f0 > 0]
        pitch.append(float(v.mean()) if v.size else 0.0)
        loud.append(dbfs(x))
        dur.append(a.duration_seconds)
        names.append(w.stem)
    out = {
        "pitch_mean": np.asarray(pitch),
        "loudness_dbfs": np.asarray(loud),
        "duration_s": np.asarray(dur),
        "names": np.asarray(names),
    }
    if cache is not None:
        Path(cache).parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache, **out)
    return out


def compare_corpora(
    features_a: dict, features_b: dict, out_dir: str | Path, label_a: str = "natural", label_b: str = "synthetic"
) -> list[Path]:
    """Scatter / histogram / boxplot / z-score plots per feature → pngs."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for feat in ("pitch_mean", "loudness_dbfs", "duration_s"):
        a = np.asarray(features_a[feat], float)
        b = np.asarray(features_b[feat], float)
        fig, axes = plt.subplots(1, 3, figsize=(13, 3.2))
        n = min(len(a), len(b))
        axes[0].scatter(a[:n], b[:n], s=8, alpha=0.6)
        lim = [min(a.min(initial=0), b.min(initial=0)), max(a.max(initial=1), b.max(initial=1))]
        axes[0].plot(lim, lim, "k--", lw=0.8)
        axes[0].set_xlabel(label_a)
        axes[0].set_ylabel(label_b)
        axes[0].set_title(f"{feat}: scatter")
        axes[1].hist([a, b], bins=24, label=[label_a, label_b])
        axes[1].legend()
        axes[1].set_title("histogram")
        axes[2].boxplot([a, b], tick_labels=[label_a, label_b])
        axes[2].set_title("boxplot")
        fig.tight_layout()
        p = out_dir / f"compare_{feat}.png"
        fig.savefig(p, dpi=110)
        plt.close(fig)
        written.append(p)

    # z-score trajectory plot
    fig, ax = plt.subplots(figsize=(9, 3))
    for feats, label in ((features_a, label_a), (features_b, label_b)):
        v = np.asarray(feats["pitch_mean"], float)
        if v.std() > 0:
            ax.plot((v - v.mean()) / v.std(), label=label, lw=1)
    ax.legend()
    ax.set_title("pitch z-scores per file")
    p = out_dir / "zscores_pitch.png"
    fig.tight_layout()
    fig.savefig(p, dpi=110)
    plt.close(fig)
    written.append(p)
    return written
