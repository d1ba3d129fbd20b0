"""Side-by-side acoustic comparison figures.

Parity with Code/visualisation/acoustic_analysis.py:210-297: natural vs
TTS waveform + spectrogram + F0 contour panels with word-interval
overlays, rendered to PNG with matplotlib (Agg).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .plotdata import compute_plot_data


def plot_comparison(
    natural_wav: str | Path,
    synth_wav: str | Path,
    out_png: str | Path,
    natural_tg: str | Path | None = None,
    synth_tg: str | Path | None = None,
    title: str = "natural vs synthetic",
    device="cuda",
) -> Path:
    """The PNG of the two renderings' panels; the plot data is computed on
    ``device``. matplotlib is imported here, not with the module."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    datas = [
        ("natural", compute_plot_data(natural_wav, natural_tg, device=device)),
        ("synthetic", compute_plot_data(synth_wav, synth_tg, device=device)),
    ]
    fig, axes = plt.subplots(3, 2, figsize=(14, 8), sharex="col")
    for col, (label, d) in enumerate(datas):
        ax = axes[0][col]
        ax.plot(d["waveform"]["t"], d["waveform"]["y"], lw=0.4)
        ax.set_title(f"{label}: waveform")
        for iv in d["intervals"]:
            ax.axvline(iv["start"], color="g", alpha=0.25, lw=0.6)

        ax = axes[1][col]
        spec = np.asarray([[v if v is not None else -80 for v in row] for row in d["spectrogram"]["db"]])
        extent = [0, spec.shape[1] * d["spectrogram"]["t_step"], 0, spec.shape[0] * d["spectrogram"]["f_step"]]
        ax.imshow(spec, origin="lower", aspect="auto", extent=extent, cmap="magma")
        ax.set_ylim(0, 4000)
        ax.set_title(f"{label}: spectrogram (dB)")

        ax = axes[2][col]
        t = np.asarray([v if v is not None else np.nan for v in d["f0"]["t"]], float)
        hz = np.asarray([v if v is not None else np.nan for v in d["f0"]["hz"]], float)
        ax.plot(t, hz, ".", ms=2)
        ax.set_title(f"{label}: F0 contour")
        ax.set_xlabel("time (s)")
        for iv in d["intervals"]:
            ax.axvline(iv["start"], color="g", alpha=0.25, lw=0.6)

    fig.suptitle(title)
    fig.tight_layout()
    out_png = Path(out_png)
    out_png.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return out_png
