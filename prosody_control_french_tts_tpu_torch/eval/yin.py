"""Independent F0 oracle: YIN (de Cheveigné & Kawahara 2002).

Purpose: voice evaluation must not grade the pipeline's own Boersma
kernel with itself — the reference chose torchcrepe
for ``evaluate_voice.ipynb`` precisely for that independence. YIN shares no
code and no estimator structure with ``ops/pitch.py``: it thresholds the
cumulative-mean-normalised difference function (CMNDF) per frame and picks
the FIRST qualifying dip, instead of windowed-autocorrelation candidate
top-k + Viterbi continuity. Implemented host-side in float32 numpy (this is
an eval path, not the production measure kernel; float64 elementwise math
is far slower than float32 on a host core).

Math, straight from the paper:
  step 2  d_t(tau)  = sum_{j<W} (x[j] - x[j+tau])^2
  step 3  d'_t(0)=1; d'_t(tau) = d_t(tau) * tau / sum_{j<=tau} d_t(j)
  step 4  tau* = first tau with d'(tau) < threshold that is a local minimum
          (fall back to argmin); unvoiced if min d' exceeds the threshold
  step 5  parabolic interpolation of d' around tau*
(The O(W * tau_max) difference function is evaluated with the standard
energy + cross-correlation decomposition; the correlation runs through one
batched rfft — numerics only, the estimator is untouched.)
"""

from __future__ import annotations

import numpy as np

__all__ = ["yin_f0", "yin_track", "cross_method_agreement"]


def _frame_starts(n: int, frame: int, hop: int) -> np.ndarray:
    if n < frame:
        return np.zeros(0, np.int64)
    return np.arange(0, n - frame + 1, hop, dtype=np.int64)


def _difference_function(frames: np.ndarray, w: int, tau_max: int) -> np.ndarray:
    """d[f, tau] for tau in [0, tau_max], frames: [F, w + tau_max] float32.

    d(tau) = E0 + E(tau) - 2 c(tau) with
      E0     = sum_{j<w} x[j]^2
      E(tau) = sum_{tau<=j<tau+w} x[j]^2          (sliding energy)
      c(tau) = sum_{j<w} x[j] x[j+tau]            (cross-correlation)
    """
    F, L = frames.shape
    sq = frames * frames
    # sliding energies via a cumulative sum per frame
    csum = np.concatenate(
        [np.zeros((F, 1), np.float32), np.cumsum(sq, axis=1, dtype=np.float32)], axis=1
    )
    taus = np.arange(tau_max + 1)
    energy = csum[:, taus + w] - csum[:, taus]  # [F, tau_max+1]
    e0 = energy[:, :1]
    # cross-correlation through one batched real FFT (complex64 throughout)
    nfft = 1
    while nfft < L + w:
        nfft *= 2
    head = np.zeros((F, nfft), np.float32)
    head[:, :w] = frames[:, :w]
    spec_head = np.fft.rfft(head, axis=1)
    full = np.zeros((F, nfft), np.float32)
    full[:, :L] = frames
    spec_full = np.fft.rfft(full, axis=1)
    corr = np.fft.irfft(np.conj(spec_head) * spec_full, n=nfft, axis=1)[:, : tau_max + 1]
    d = e0 + energy - 2.0 * corr.astype(np.float32)
    return np.maximum(d, 0.0)


def _cmndf(d: np.ndarray) -> np.ndarray:
    """Cumulative-mean-normalised difference: d'(0)=1, d'(tau)=d*tau/cumsum(d)."""
    taus = np.arange(1, d.shape[1], dtype=np.float32)
    running = np.cumsum(d[:, 1:], axis=1, dtype=np.float32)
    out = np.ones_like(d)
    out[:, 1:] = d[:, 1:] * taus / np.maximum(running, 1e-12)
    return out


def yin_f0(
    x: np.ndarray,
    sr: float,
    fmin: float = 60.0,
    fmax: float = 600.0,
    hop_s: float = 0.01,
    threshold: float = 0.15,
) -> tuple[np.ndarray, np.ndarray]:
    """YIN pitch track → (f0_hz [F] with 0.0 = unvoiced, frame centres [F])."""
    x = np.asarray(x, np.float32)
    tau_min = max(int(sr / fmax), 2)
    tau_max = int(np.ceil(sr / fmin))
    w = tau_max  # integration window = one max-lag period (paper's choice)
    frame_len = w + tau_max
    hop = max(int(round(hop_s * sr)), 1)
    starts = _frame_starts(x.size, frame_len, hop)
    if starts.size == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.float32)
    frames = np.stack([x[s : s + frame_len] for s in starts])
    d = _difference_function(frames, w, tau_max)
    nd = _cmndf(d)

    F = nd.shape[0]
    f0 = np.zeros(F, np.float32)
    band = nd[:, tau_min : tau_max + 1]  # search band
    below = band < threshold
    # local minimum: nd[tau] <= nd[tau+1] (within the band; last col allowed)
    nxt = np.concatenate([band[:, 1:], np.full((F, 1), np.inf, np.float32)], axis=1)
    dip = below & (band <= nxt)
    first = np.argmax(dip, axis=1)
    has_dip = dip.any(axis=1)
    fallback = np.argmin(band, axis=1)
    tau_rel = np.where(has_dip, first, fallback)
    tau = tau_rel + tau_min
    voiced = has_dip | (band[np.arange(F), fallback] < threshold)
    # silence gate: an all-(near-)zero frame has d ~= 0 everywhere and the
    # CMNDF ratio degenerates to 0/eps "periodicity" — gate on frame RMS
    # (absolute floor + 1 % of the clip's loudest frame)
    rms = np.sqrt(np.mean(frames[:, :w] ** 2, axis=1))
    voiced &= rms > max(1e-5, 0.01 * float(rms.max()))

    # parabolic interpolation on nd around tau (guard the band edges)
    t0 = np.clip(tau, 1, nd.shape[1] - 2)
    ym = nd[np.arange(F), t0 - 1]
    y0 = nd[np.arange(F), t0]
    yp = nd[np.arange(F), t0 + 1]
    denom = ym - 2.0 * y0 + yp
    shift = np.where(np.abs(denom) > 1e-12, 0.5 * (ym - yp) / np.where(denom == 0, 1, denom), 0.0)
    shift = np.clip(shift, -0.5, 0.5)
    tau_f = np.where(tau == t0, tau + shift, tau).astype(np.float32)

    f0 = np.where(voiced, np.float32(sr) / np.maximum(tau_f, 1.0), 0.0).astype(np.float32)
    f0 = np.where((f0 >= fmin * 0.9) & (f0 <= fmax * 1.1), f0, 0.0)
    times = (starts.astype(np.float32) + frame_len / 2.0) / np.float32(sr)
    return f0, times


def yin_track(x: np.ndarray, sr: float, **kw) -> np.ndarray:
    """f0-only convenience (the eval contour shape)."""
    return yin_f0(x, sr, **kw)[0]


def cross_method_agreement(
    f0_a: np.ndarray,
    times_a: np.ndarray,
    f0_b: np.ndarray,
    times_b: np.ndarray,
) -> dict[str, float]:
    """Agreement stats between two F0 tracks on their common time span.

    Track B is nearest-neighbour sampled onto A's frame grid. Returns
    voicing agreement, median/p90 |cents| over commonly-voiced frames, and
    gross-error rate (>100 cents ≈ a semitone — octave/tracking errors)."""
    if f0_a.size == 0 or f0_b.size == 0:
        return {"frames": 0.0}
    idx = np.clip(np.searchsorted(times_b, times_a), 0, times_b.size - 1)
    left = np.clip(idx - 1, 0, times_b.size - 1)
    use_left = np.abs(times_b[left] - times_a) < np.abs(times_b[idx] - times_a)
    b_on_a = f0_b[np.where(use_left, left, idx)]
    span = (times_a >= times_b[0]) & (times_a <= times_b[-1])
    va, vb = f0_a > 0, b_on_a > 0
    both = va & vb & span
    stats: dict[str, float] = {
        "frames": float(span.sum()),
        "voicing_agreement": float(((va == vb) & span).sum() / max(span.sum(), 1)),
        "both_voiced_frac": float(both.sum() / max(span.sum(), 1)),
    }
    if both.any():
        cents = 1200.0 * np.abs(np.log2(f0_a[both] / b_on_a[both]))
        stats["median_abs_cents"] = float(np.median(cents))
        stats["p90_abs_cents"] = float(np.percentile(cents, 90))
        stats["gross_error_rate"] = float((cents > 100.0).mean())
    return stats
