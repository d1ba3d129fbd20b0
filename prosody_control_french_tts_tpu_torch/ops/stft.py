"""Batched STFT, its overlap-add inverse, spectrogram and mel filterbank.

Port of the JAX package's ``ops/stft.py`` (librosa conventions: periodic
Hann window, centre padding by reflection, ``[..., 1 + n_fft/2, frames]``
layout). The inverse is the windowed overlap-add with squared-window
normalisation that both denoisers share. Its sums run in a fixed order,
frame by frame from the earliest frame that covers a sample, as elementwise
adds of shifted frame groups: no scatter with atomics, so two runs on the
card give the same bits.

``log_mel`` is the front end of both acoustic aligners (Whisper, CTC). The
power spectrum is two float32 products of the windowed frames against the
real-DFT matrices ``_dft_mats`` (TF32 off on the card, ``dsp_precision``),
where the JAX package runs the same products split into bfloat16 pieces to
suit its accelerator; the two agree within 3.2e-4 in the scaled log units
(mean 7e-6, on synthetic speech and noise, n_fft 400, hop 160, 80 mels).
"""

from __future__ import annotations

import numpy as np
import torch


def _hann(n: int) -> np.ndarray:
    # periodic Hann (librosa/scipy get_window default)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``numpy.pad(mode="reflect")`` on the last axis, any pad and any
    leading axes (``F.pad`` takes neither 1-D input nor a pad past the
    length)."""
    T = x.shape[-1]
    idx = torch.arange(-pad, T + pad, device=x.device)
    if T == 1:
        return x[..., torch.zeros_like(idx)]
    period = 2 * (T - 1)
    idx = idx.abs() % period
    idx = torch.where(idx >= T, period - idx, idx)
    return x[..., idx]


def stft(x: torch.Tensor, n_fft: int = 1024, hop_length: int | None = None, center: bool = True) -> torch.Tensor:
    """Complex STFT of float32 x [..., T] → [..., 1 + n_fft/2, frames]."""
    hop = hop_length or n_fft // 4
    if center:
        x = _reflect_pad(x, n_fft // 2)
    frames = x.unfold(-1, n_fft, hop) * torch.from_numpy(_hann(n_fft)).to(x.device)
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


def _overlap_add(frames: torch.Tensor, hop: int, total: int) -> torch.Tensor:
    """Sum of frames [n, W] placed hop apart, into [total] samples. A
    sample's contributions are added from its earliest frame on (the order
    of a sequential scatter-add over the frames), as G = ceil(W / hop)
    elementwise adds of the frames' hop-long groups."""
    n, W = frames.shape
    G = -(-W // hop)
    groups = torch.nn.functional.pad(frames, (0, G * hop - W)).reshape(n, G, hop)
    out = torch.zeros((n + G - 1, hop), dtype=frames.dtype, device=frames.device)
    for g in range(G - 1, -1, -1):  # group g of frame f lands in block f + g
        out[g : g + n] += groups[:, g]
    out = out.reshape(-1)
    if out.shape[0] >= total:
        return out[:total]
    return torch.nn.functional.pad(out, (0, total - out.shape[0]))


def istft_overlap_add(spec: torch.Tensor, n_fft: int, hop: int, length: int) -> torch.Tensor:
    """Inverse of ``stft(center=True)``: spec [F, T'] complex → [length]
    float32 samples."""
    frames = torch.fft.irfft(spec.T, n=n_fft, dim=-1)  # [T', n_fft]
    win = torch.from_numpy(_hann(n_fft)).to(frames.device)
    frames = frames * win[None, :]
    total = length + 2 * n_fft
    out = _overlap_add(frames, hop, total)
    wsum = _overlap_add((win * win).expand(frames.shape[0], n_fft), hop, total)
    y = out / torch.clamp(wsum, min=1e-8)
    return y[n_fft // 2 : n_fft // 2 + length]


def spectrogram(x: torch.Tensor, n_fft: int = 1024, hop_length: int | None = None, power: float = 2.0, db: bool = True):
    s = stft(x, n_fft, hop_length).abs() ** power
    if not db:
        return s
    ref = s.amax(dim=(-2, -1), keepdim=True)
    return 10.0 * torch.log10(torch.clamp(s, min=1e-10) / torch.clamp(ref, min=1e-10))


def mel_filterbank(sr: float, n_fft: int, n_mels: int = 80, fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Slaney-style mel filterbank [n_mels, 1+n_fft/2] (librosa default)."""
    fmax = fmax or sr / 2.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        mel = f / (200.0 / 3.0)
        log_region = f >= 1000.0
        mel = np.where(log_region, 15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / (np.log(6.4) / 27.0), mel)
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f = m * (200.0 / 3.0)
        log_region = m >= 15.0
        f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)
        return f

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz = mel_to_hz(mels)
    bins = np.fft.rfftfreq(n_fft, 1.0 / sr)
    fb = np.zeros((n_mels, len(bins)), dtype=np.float32)
    for i in range(n_mels):
        lo, ctr, hi = hz[i], hz[i + 1], hz[i + 2]
        up = (bins - lo) / max(ctr - lo, 1e-9)
        down = (hi - bins) / max(hi - ctr, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        enorm = 2.0 / (hi - lo)
        fb[i] *= enorm
    return fb


def _dft_mats(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT analysis matrices [n_fft, 1 + n_fft//2] (cos, −sin)."""
    F = 1 + n_fft // 2
    k = np.arange(F)[None, :]
    t = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * t * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def log_mel(x: torch.Tensor, sr: float, n_fft: int = 400, hop_length: int = 160, n_mels: int = 80) -> torch.Tensor:
    """Log-mel features of float32 x [..., T] → [..., frames, n_mels], the
    Whisper convention: log10, clamped to (the item's max − 8), scaled as
    (log + 4) / 4."""
    dev = x.device
    frames = _reflect_pad(x, n_fft // 2).unfold(-1, n_fft, hop_length) * torch.from_numpy(_hann(n_fft)).to(dev)
    C, S = (torch.from_numpy(m).to(dev) for m in _dft_mats(n_fft))
    re = torch.matmul(frames, C)
    im = torch.matmul(frames, S)
    power = re * re + im * im  # [..., T', F]
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels)).to(dev)
    mel = torch.matmul(power, fb.T)
    logm = torch.log10(torch.clamp(mel, min=1e-10))
    logm = torch.maximum(logm, logm.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (logm + 4.0) / 4.0
