"""Plot-data computation for the viewers.

Parity with the reference's FastAPI plot endpoints
(Code/visualisation/app.py:49-130, visualisation_abtest/app.py:73-122):
downsampled waveform, dB spectrogram, F0 contour, and word intervals as
JSON-safe dicts. Spectrogram/F0 come from the port's ops on ``device``
(``ops.stft.spectrogram``; ``ops.pitch.praat_pitch``, kernels A and B on the
card), librosa's stft/pyin in the reference.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from ..ops.kernels import resolve_device
from ..ops.pitch import PitchParams, praat_pitch
from ..ops.stft import spectrogram
from ..utils.textgridio import read_textgrid
from ..utils.wavio import read_wav


def downsample(x: np.ndarray, max_points: int = 4000) -> np.ndarray:
    if x.shape[0] <= max_points:
        return x
    stride = int(math.ceil(x.shape[0] / max_points))
    return x[::stride]


def _sanitize(arr) -> list:
    """NaN/inf → None for JSON (app.py:80-82)."""
    out = []
    for v in np.asarray(arr, float).tolist():
        out.append(v if math.isfinite(v) else None)
    return out


def compute_plot_data(
    wav_path: str | Path,
    textgrid_path: str | Path | None = None,
    n_fft: int = 1024,  # acoustic_analysis.py:98
    pitch_floor: float = 60.0,  # :76 (pyin fmin)
    pitch_ceiling: float = 600.0,
    max_points: int = 4000,
    device="cuda",
) -> dict:
    """The viewer's JSON for one wav (and its word TextGrid): the
    spectrogram and the pitch track computed on ``device``."""
    dev = resolve_device(device)
    a = read_wav(wav_path).to_mono()
    x = np.asarray(a.samples, np.float32)
    hop = n_fft // 4

    spec = spectrogram(torch.from_numpy(x).to(dev), n_fft=n_fft, hop_length=hop, db=True).cpu().numpy()
    tr = praat_pitch(x, a.rate, PitchParams(floor=pitch_floor, ceiling=pitch_ceiling), device=dev)
    f0 = tr.f0.cpu().numpy().astype(float)
    f0 = np.where(f0 > 0, f0, np.nan)

    wave = downsample(x, max_points)
    wave_t = downsample(np.arange(x.shape[0]) / a.rate, max_points)
    # cap spectrogram size for transfer
    t_stride = max(1, spec.shape[1] // 1200)
    f_stride = max(1, spec.shape[0] // 256)
    spec_small = spec[::f_stride, ::t_stride]

    data = {
        "sample_rate": int(a.rate),
        "duration": a.duration_seconds,
        "waveform": {"t": _sanitize(wave_t), "y": _sanitize(wave)},
        "spectrogram": {
            "db": [[round(float(v), 1) for v in row] for row in spec_small],
            "t_step": hop * t_stride / a.rate,
            "f_step": a.rate / n_fft * f_stride,
        },
        "f0": {"t": _sanitize(tr.times), "hz": _sanitize(f0)},
        "intervals": [],
    }
    if textgrid_path is not None and Path(textgrid_path).exists():
        tg = read_textgrid(textgrid_path)
        data["intervals"] = [
            {"start": iv.min_time, "end": iv.max_time, "text": iv.mark}
            for iv in tg.tiers[0]
            if iv.mark.strip()
        ]
    return data
