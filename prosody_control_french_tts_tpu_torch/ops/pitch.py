"""Boersma (1993) autocorrelation pitch tracking, batched, in PyTorch.

Port of the JAX package's ``ops/pitch.py`` — the algorithm behind Praat's
``Sound: To Pitch (ac)`` with the reference's ``pitch_floor=150,
pitch_ceiling=600``:

1. frames centred symmetrically over the (padded) signal on an exact
   rational grid, ``n_frames = floor((dur − window_dur)/dt) + 1``;
2. per frame: subtract the local mean (±1 longest period, from chunked
   prefix sums), multiply by a Hanning window;
3. normalised autocorrelation ``r(τ) = (ac_x(τ)/ac_x(0)) / (ac_w(τ)/ac_w(0))``
   from a zero-padded ``torch.fft.rfft`` and a float32 matmul by the
   lag-restricted cosine matrix (the JAX package's ``rfft`` spectrum mode);
4. voiced candidates: the strongest ``max_candidates − 1`` local maxima,
   parabolic-interpolated — kernel A (``ops.candidates``); with
   ``sinc_refine_steps > 0`` each lag then takes that many Newton steps on
   the Hann-windowed sinc interpolant of r (plain tensor code after kernel
   A, as the JAX package runs it as XLA code), and the interpolant's value
   there is the strength;
5. unvoiced candidate strength from the frame's local/global peak ratio;
6. the Viterbi path over frames with octave, octave-jump and voiced/
   unvoiced costs scaled by ``dt/0.01`` — kernel B (``ops.viterbi``).

Signals are batched [S, T]: the batch dimension is written out where the
JAX package ``vmap``s. The host constants (Hanning window, cosine matrix,
window autocorrelation) are the same float64 computations rounded once to
float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import candidates, viterbi
from .cumsum import ChunkedCumsum


@dataclass(frozen=True)
class PitchParams:
    floor: float = 150.0
    ceiling: float = 600.0
    time_step: float | None = None  # None → 0.75/floor (Praat default)
    max_candidates: int = 15
    silence_threshold: float = 0.03
    voicing_threshold: float = 0.45
    octave_cost: float = 0.01
    octave_jump_cost: float = 0.35
    voiced_unvoiced_cost: float = 0.14
    periods_per_window: float = 3.0
    sinc_refine_steps: int = 0  # 0: parabolic lags; n > 0: n Newton steps on the sinc interpolant
    sinc_half_width: int = 16


@dataclass
class PitchTrack:
    f0: torch.Tensor  # [..., F] Hz, 0.0 = unvoiced
    times: np.ndarray  # [F] frame centres in seconds
    dt: float


def _geometry(num_samples: int, sr: float, p: PitchParams):
    dt = p.time_step if p.time_step is not None else 0.75 / p.floor
    dx = 1.0 / sr
    duration = num_samples * dx
    window_dur = p.periods_per_window / p.floor
    nsamp_window = int(math.floor(window_dur / dx))
    half_window = nsamp_window // 2 - 1
    nsamp_window = half_window * 2
    nsamp_period = int(math.floor(sr / p.floor))
    half_period = nsamp_period // 2 + 1
    n_frames = max(1, int(math.floor((duration - window_dur) / dt)) + 1)
    mid_time = duration / 2.0
    first_time = mid_time - 0.5 * (n_frames - 1) * dt
    max_lag = min(int(math.floor(nsamp_window / p.periods_per_window)) + 2, nsamp_window // 2)
    min_lag = max(2, int(math.ceil(sr / p.ceiling)) - 1)
    nfft = 1
    while nfft < nsamp_window * 2:
        nfft *= 2
    return dict(
        dt=dt,
        dx=dx,
        nsamp_window=nsamp_window,
        half_window=half_window,
        nsamp_period=nsamp_period,
        half_period=half_period,
        n_frames=n_frames,
        first_time=first_time,
        max_lag=max_lag,
        min_lag=min_lag,
        nfft=nfft,
    )


def _hanning(n: int) -> np.ndarray:
    j = np.arange(1, n + 1, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * j / (n + 1))).astype(np.float32)


@lru_cache(maxsize=8)
def _cos_lag_matrix(nfft: int, n_lags: int) -> np.ndarray:
    """irfft restricted to the first n_lags outputs, as a [nfft/2+1, n_lags]
    cosine matrix (weight 2 except at DC and Nyquist)."""
    k = np.arange(nfft // 2 + 1, dtype=np.float64)
    tau = np.arange(n_lags, dtype=np.float64)
    C = np.cos(2.0 * np.pi * np.outer(k, tau) / nfft) / nfft
    C[1:-1] *= 2.0
    return C.astype(np.float32)


@lru_cache(maxsize=8)
def _window_ac_ratio(W: int, n_lags: int) -> np.ndarray:
    """ac_w(τ)/ac_w(0) of the Hanning analysis window, in float64."""
    win = _hanning(W).astype(np.float64)
    nfft = 1
    while nfft < W + n_lags:
        nfft *= 2
    ac = np.fft.irfft(np.abs(np.fft.rfft(win, n=nfft)) ** 2)[:n_lags]
    return (ac / ac[0]).astype(np.float32)


def _frame_matrix(x: torch.Tensor, starts: torch.Tensor, width: int) -> torch.Tensor:
    """Gather [..., F, width] windows from x [..., T] at integer starts [F]
    (indices clamped to the signal, as the JAX package's gather)."""
    idx = (starts[:, None] + torch.arange(width, device=x.device)[None, :]).clamp(0, x.shape[-1] - 1)
    return x[..., idx]


def _affine_frame_classes(g: dict, num_samples: int) -> dict | None:
    """Frame starts are affine, start_i = floor(α + β·i) + 1 − half_window
    with β = dt/dx. When β·q is an integer for a small q, frames split into
    q classes of exact integer stride. Returns None when no small q exists
    (the gather path then applies)."""
    beta = g["dt"] / g["dx"]
    q = None
    for cand in (1, 2, 4, 5, 8, 10, 16, 20):
        if abs(beta * cand - round(beta * cand)) < 1e-6:
            q = cand
            break
    if q is None:
        return None
    stride = int(round(beta * q))
    if stride <= 0:
        return None
    alpha0 = g["first_time"] / g["dx"] - 0.5
    F = g["n_frames"]
    Fp = ((F + q - 1) // q) * q
    n_per = Fp // q
    W = g["nsamp_window"]
    m = -(-W // stride) + 1  # chunks per frame
    starts0 = [int(math.floor(alpha0 + beta * p)) + 1 - g["half_window"] for p in range(q)]
    need = max(s0 + stride * (n_per - 1 + m) for s0 in starts0) + 1
    return dict(q=q, stride=stride, n_per=n_per, m=m, starts0=starts0, pad_to=max(need, num_samples), F=F, Fp=Fp, W=W)


def _frames_uniform(x: torch.Tensor, cls: dict) -> torch.Tensor:
    """Strided framing per class (``unfold`` views), interleaved back to
    frame order: [..., F, W]. x [..., pad_to] is zero-padded; a first frame
    that starts before sample 0 reads zeros there."""
    stride, n_per, m, W = cls["stride"], cls["n_per"], cls["m"], cls["W"]
    per_class = []
    for s0 in cls["starts0"]:
        s0c = max(s0, 0)
        rows = x[..., s0c : s0c + stride * (n_per - 1 + m)].unfold(-1, W, stride)[..., :n_per, :]
        if s0 < 0:
            rows = rows.clone()
            rows[..., 0, :] = torch.nn.functional.pad(rows[..., 0, : W + s0], (-s0, 0))
        per_class.append(rows)
    inter = torch.stack(per_class, dim=-2)  # [..., n_per, q, W]
    return inter.reshape(x.shape[:-1] + (cls["Fp"], W))[..., : cls["F"], :]


def _sinc_refine(r: torch.Tensor, lag0: torch.Tensor, steps: int, half: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Newton refinement of each lag of ``lag0`` [rows, k] towards a local
    maximum of the band-limited interpolant r(τ) = Σ_i r[i]·sinc(τ−i) of its
    row of r [rows, L], truncated to ±``half`` samples around the peak and
    tapered by a Hann window of width half + 1 (Praat's
    NUMinterpolate_sinc). Each step moves at most one sample and the lag
    stays within one sample of its start. Returns (lags, the interpolant's
    value there), float32, the JAX package's ``_sinc_refine`` term by term."""
    n = r.shape[-1]
    base = torch.round(lag0).to(torch.int64).clamp(half, n - half - 1)
    offs = torch.arange(-half, half + 1, device=r.device)
    neigh = r[:, None, :].expand(-1, lag0.shape[1], -1).gather(-1, base[..., None] + offs)  # [rows, k, 2·half+1]
    i = base[..., None].to(torch.float32) + offs.to(torch.float32)
    a = math.pi / float(half + 1)

    def value_and_derivs(tau):
        u = tau[..., None] - i
        z = math.pi * u
        z = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
        s = torch.sin(z) / z
        ds = (torch.cos(z) - s) / z * math.pi  # d sinc / du
        d2s = (-torch.sin(z) * math.pi - 2.0 * ds) / z * math.pi
        w = 0.5 * (1.0 + torch.cos(a * u))
        dw = -0.5 * a * torch.sin(a * u)
        d2w = -0.5 * a * a * torch.cos(a * u)
        k = s * w
        dk = ds * w + s * dw
        d2k = d2s * w + 2.0 * ds * dw + s * d2w
        return (neigh * k).sum(-1), (neigh * dk).sum(-1), (neigh * d2k).sum(-1)

    tau = lag0
    zero = torch.zeros((), dtype=torch.float32, device=r.device)
    for _ in range(steps):
        _, d1, d2 = value_and_derivs(tau)
        step = torch.where(d2.abs() > 1e-12, -d1 / d2, zero).clamp(-1.0, 1.0)
        tau = torch.minimum(torch.maximum(tau + step, lag0 - 1.0), lag0 + 1.0)
    val, _, _ = value_and_derivs(tau)
    return tau, val


def _pitch_frames(x: torch.Tensor, sr: float, num_samples: int, p: PitchParams, length=None):
    """Per-frame candidates of a batch x [S, T] float32 (zeros past each
    row's ``length`` samples; None → whole rows are real).

    Returns (freq [S,F,K], strength [S,F,K], intensity [S,F], frame_valid
    [S,F]); candidate 0 is the unvoiced candidate (freq 0, strength 0)."""
    g = _geometry(num_samples, sr, p)
    F, W = g["n_frames"], g["nsamp_window"]
    K = p.max_candidates
    dev = x.device
    x = x.to(torch.float32)
    S = x.shape[0]
    if length is None:
        length = torch.full((S,), float(num_samples), dtype=torch.float32, device=dev)
    else:
        length = torch.as_tensor(length, device=dev).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sample_valid = torch.arange(num_samples, device=dev)[None, :] < length[:, None]
    mean = x.sum(dim=-1) / length.clamp(min=1.0)
    global_peak = torch.where(sample_valid, (x - mean[:, None]).abs(), zero).amax(dim=-1) + 1e-30

    centers = torch.arange(F, device=dev, dtype=torch.float32) * g["dt"] + g["first_time"]
    cls = _affine_frame_classes(g, num_samples)
    if cls is not None:
        i_arr = torch.arange(F, device=dev)
        s0 = torch.tensor(cls["starts0"], dtype=torch.int64, device=dev)
        frame_start = s0[i_arr % cls["q"]] + cls["stride"] * (i_arr // cls["q"])
        left = frame_start + g["half_window"] - 1
    else:
        left = torch.floor(centers / g["dx"] - 0.5).to(torch.int64)
        frame_start = left + 1 - g["half_window"]

    # local mean over ±1 longest period, from chunked prefix sums
    mean_w = 2 * g["nsamp_period"]
    mean_start = (left + 1 - g["nsamp_period"]).clamp(0, num_samples - mean_w)
    cs = ChunkedCumsum.build(x)
    ms = mean_start[None, :].expand(S, F)
    local_mean = cs.range_sum(ms, ms + mean_w) / mean_w  # [S, F]

    win = torch.from_numpy(_hanning(W)).to(dev)
    if cls is not None:
        xp = torch.nn.functional.pad(x, (0, cls["pad_to"] - num_samples)) if cls["pad_to"] > num_samples else x
        raw_frames = _frames_uniform(xp, cls)
    else:
        raw_frames = _frame_matrix(x, frame_start, W)
    frames = (raw_frames - local_mean[..., None]) * win  # [S, F, W]

    # local peak: centre ± half period of the windowed frame
    lp_lo = max(g["half_window"] - g["half_period"], 0)
    lp_hi = min(g["half_window"] + g["half_period"], W) - 1
    local_peak = frames[..., lp_lo : lp_hi + 1].abs().amax(dim=-1)
    intensity = torch.clamp(local_peak / global_peak[:, None], max=1.0)

    # normalised autocorrelation on the needed max_lag + 2 lags
    L = g["max_lag"] + 2
    nfft = g["nfft"]
    spec_pow = torch.fft.rfft(frames, n=nfft, dim=-1).abs() ** 2
    del frames, raw_frames
    ac = spec_pow @ torch.from_numpy(_cos_lag_matrix(nfft, L)).to(dev)  # [S, F, L]
    del spec_pow
    acw = torch.from_numpy(_window_ac_ratio(W, L)).to(dev)
    r = (ac / (ac[..., :1] + 1e-30)) / acw

    r = r.reshape(S * F, L).contiguous()
    lag_f, strength, valid = candidates.topk_parabolic(r, K - 1, g["min_lag"], g["max_lag"], p.voicing_threshold)
    if p.sinc_refine_steps > 0:
        lag_f, strength = _sinc_refine(r, lag_f, p.sinc_refine_steps, p.sinc_half_width)
    lag_f = lag_f.reshape(S, F, K - 1)
    strength = strength.reshape(S, F, K - 1)
    valid = valid.reshape(S, F, K - 1)

    freq = sr / lag_f.clamp(min=1e-6)
    strength = torch.where(strength > 1.0, 1.0 / strength.clamp(min=1e-30), strength)
    freq = torch.where(valid, freq, zero)
    strength = torch.where(valid, strength, zero)

    # frames whose window spills past the true end are forced unvoiced
    frame_valid = (centers[None, :] + 0.5 * W * g["dx"]) <= (length[:, None] * g["dx"] + 1e-6)
    freq = torch.where(frame_valid[..., None], freq, zero)
    strength = torch.where(frame_valid[..., None], strength, zero)
    intensity = torch.where(frame_valid, intensity, zero)

    pad = torch.zeros((S, F, 1), dtype=torch.float32, device=dev)
    return torch.cat([pad, freq], dim=-1), torch.cat([pad, strength], dim=-1), intensity, frame_valid


def _viterbi_inputs(freq, strength, intensity, p: PitchParams, dt: float):
    """δ, voiced and the two transition costs of the path finder."""
    tsc = dt / 0.01
    vuv_cost = p.voiced_unvoiced_cost * tsc
    jump_cost = p.octave_jump_cost * tsc
    voiced = (freq > 0.0) & (freq <= p.ceiling)
    unvoiced_strength = p.voicing_threshold + torch.clamp(
        2.0 - intensity * (1.0 + p.voicing_threshold) / p.silence_threshold, min=0.0
    )
    delta = torch.where(
        voiced,
        strength - p.octave_cost * torch.log2(p.ceiling / freq.clamp(min=1e-6)),
        unvoiced_strength[..., None],
    )
    return delta, voiced, vuv_cost, jump_cost


def viterbi_batched(freq, strength, intensity, p: PitchParams, dt: float) -> torch.Tensor:
    """Path finder over [S, F, K] tracks → f0 [S, F] (kernel B on CUDA)."""
    delta, voiced, vuv_cost, jump_cost = _viterbi_inputs(freq, strength, intensity, p, dt)
    lf = torch.log2(freq.clamp(min=1e-6))
    return viterbi.viterbi_path(
        delta.contiguous(), lf.contiguous(), voiced.contiguous(), freq.contiguous(), vuv_cost, jump_cost
    )


def praat_pitch(x, sr: float, params: PitchParams | None = None, lengths=None, device="cuda") -> PitchTrack:
    """Full pitch track of a mono signal [T] or a zero-padded batch [B, T]
    (``lengths``: per-row real sample counts)."""
    from .kernels import dsp_precision, resolve_device

    dev = resolve_device(device)
    dsp_precision()
    p = params or PitchParams()
    x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    single = x.dim() == 1
    if single:
        x = x[None]
        if lengths is not None:
            lengths = [float(np.asarray(lengths))]
    num_samples = int(x.shape[-1])
    g = _geometry(num_samples, sr, p)
    lens = None if lengths is None else torch.as_tensor(np.asarray(lengths, np.float32), device=dev)
    freq, strength, intensity, _ = _pitch_frames(x, sr, num_samples, p, lens)
    f0 = viterbi_batched(freq, strength, intensity, p, g["dt"])
    times = g["first_time"] + np.arange(g["n_frames"]) * g["dt"]
    return PitchTrack(f0=f0[0] if single else f0, times=times, dt=g["dt"])


def masked_median(values: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Median over masked entries, matching ``np.median`` (mean of the two
    middle order statistics for even counts); 0 where the mask is empty."""
    n = mask.sum(dim=dim)
    big = torch.full((), 3.4e38, dtype=values.dtype, device=values.device)
    v = torch.sort(torch.where(mask, values, big), dim=dim).values
    lo = ((n - 1) // 2).clamp(min=0)
    hi = (n // 2).clamp(min=0)
    lo_v = v.gather(dim, lo.unsqueeze(dim)).squeeze(dim)
    hi_v = v.gather(dim, hi.unsqueeze(dim)).squeeze(dim)
    med = 0.5 * (lo_v + hi_v)
    return torch.where(n > 0, med, torch.zeros((), dtype=med.dtype, device=med.device))


def median_pitch_in_windows(track: PitchTrack, windows: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Median F0 over voiced frames whose centres fall in [t0, t1).

    windows [..., N, 2] seconds → [..., N] (0.0 where no voiced frame)."""
    f0 = track.f0
    t = torch.as_tensor(track.times, dtype=torch.float32).to(f0.device)  # [F]
    t0 = windows[..., 0][..., None]
    t1 = windows[..., 1][..., None]
    m = (t >= t0) & (t < t1) & (f0[..., None, :] > 0)
    if mask is not None:
        m = m & mask[..., None]
    vals = f0[..., None, :].expand(m.shape)
    return masked_median(vals, m, dim=-1)
