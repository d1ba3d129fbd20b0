"""Spectral-gate denoiser, in PyTorch.

Port of the JAX package's ``audio/denoise.py``, the in-framework stand-in
for the reference's external Demucs step (``denoise: spectral``):

1. STFT magnitude; per-frequency noise floor = a low quantile over time
   (linear interpolation between order statistics, as ``jnp.quantile``);
2. soft mask = sigmoid of the SNR above the floor (threshold and softness
   in dB), smoothed along time backward then forward (``ops.mask_ema``: the
   hand-written CUDA kernel on the card);
3. inverse STFT by overlap-add (Hann, 75 % overlap).

A failure raises: the pipeline does not fall back to a copy of the input.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import dsp_precision, resolve_device
from ..ops.mask_ema import mask_ema
from ..ops.stft import istft_overlap_add, stft
from ..utils.wavio import Audio


def _quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """Quantile q of x along its last axis, keeping it: the two order
    statistics around q·(n − 1) weighted linearly, in float32, in the JAX
    package's order of operations (``torch.quantile`` refuses inputs past
    2^24 elements)."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    pos = torch.tensor(q, dtype=torch.float32) * torch.tensor(n - 1, dtype=torch.float32)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    hw = pos - low
    lw = torch.tensor(1.0, dtype=torch.float32) - hw
    lo_i = int(torch.clamp(low, 0, n - 1))
    hi_i = int(torch.clamp(high, 0, n - 1))
    return s[..., lo_i : lo_i + 1] * lw.to(x.device) + s[..., hi_i : hi_i + 1] * hw.to(x.device)


def gate_mask(spec: torch.Tensor, noise_quantile: float = 0.1, threshold_db: float = 9.0, softness_db: float = 3.0):
    """The soft mask [F, T'] of a spectrum, before its time smoothing."""
    mag = spec.abs()
    floor = _quantile_linear(mag, noise_quantile)
    snr_db = 20.0 * (torch.log10(mag + 1e-10) - torch.log10(floor + 1e-10))
    return torch.sigmoid((snr_db - threshold_db) / softness_db).contiguous()


def denoise_core(
    x: torch.Tensor,
    n_fft: int = 1024,
    hop: int = 256,
    noise_quantile: float = 0.1,
    threshold_db: float = 9.0,
    softness_db: float = 3.0,
    smooth: float = 0.5,
) -> torch.Tensor:
    """x [T] float32 → the gated signal [T]."""
    spec = stft(x, n_fft=n_fft, hop_length=hop, center=True)  # [F, T']
    mask = mask_ema(gate_mask(spec, noise_quantile, threshold_db, softness_db), smooth)
    return istft_overlap_add(spec * mask, n_fft, hop, x.shape[-1])


def denoise(audio: Audio, device="cuda", **kw) -> Audio:
    """Spectral gate of a recording (mixed down to mono) on ``device``."""
    dev = resolve_device(device)
    dsp_precision()
    x = torch.from_numpy(np.ascontiguousarray(audio.to_mono().samples, np.float32)).to(dev)
    y = denoise_core(x, **kw).cpu().numpy()
    return Audio(y.astype(np.float32, copy=False), audio.rate)
