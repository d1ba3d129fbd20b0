"""The reference's prosody adjustment math, in PyTorch.

Port of the JAX package's ``prosody/adjust.py``: the same clamps,
asymmetries and smoothing order as the reference's measure step
(Code/audioPipeline.py:261-711), vectorised over a flat syntagme axis.
The inputs are a few hundred scalars per voice, so the measure step runs
these as float32 tensors on the CPU whatever device measured the audio.
EMA state deliberately carries across segment boundaries, as in the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ProsodySettings:
    """config.yaml ``prosody_settings`` (reference schema and defaults)."""

    pitch_semitones: float = 2.0
    pitch_lower_clip_factor: float = 0.7
    volume_pct: float = 7.0
    rate_percent: float = 15.0
    smoothing_alpha: float = 0.4
    max_jump_percent: float = 5.0
    end_punctuation_pause_ms: int = 150
    baseline_window: int | None = None
    inter_syntagme_pause_factor: float = 1.0
    threshold_duration_before_slowing_down: float = 1.0
    slow_floor_per_sec: float = 2.0

    @classmethod
    def from_config(cls, cfg: dict) -> "ProsodySettings":
        """From a config.yaml dict: its ``prosody_settings`` block, with the
        reference's defaults for missing keys."""
        p = cfg.get("prosody_settings", {}) or {}
        return cls(
            pitch_semitones=p.get("pitch_semitones", 2.0),
            pitch_lower_clip_factor=p.get("pitch_lower_clip_factor", 0.7),
            volume_pct=p.get("volume_pct", 7.0),
            rate_percent=p.get("rate_percent", 15.0),
            smoothing_alpha=p.get("smoothing_alpha", 0.4),
            max_jump_percent=p.get("max_jump_percent", 5.0),
            end_punctuation_pause_ms=p.get("end_punctuation_pause_ms", 150),
            baseline_window=p.get("baseline_window", None),
            inter_syntagme_pause_factor=p.get("inter_syntagme_pause_factor", 1),
            threshold_duration_before_slowing_down=p.get("threshold_duration_before_slowing_down", 1.0),
            slow_floor_per_sec=p.get("slow_floor_per_sec", 2.0),
        )


def _median(v: np.ndarray) -> float:
    return float(np.median(v)) if v.size else 0.0


def segment_baselines(
    p_nat: np.ndarray, l_nat: np.ndarray, rate_ratio: np.ndarray, window: int | None
) -> dict[str, np.ndarray]:
    """Per-segment F0/loudness/rate baselines (host numpy).

    window None or ≥ n → one global median for all (zero-pitch segments
    excluded from the F0 median, ``or 1.0`` fallback); otherwise a centred
    window of ``window//2`` each side, clipped at the corpus edges."""
    n = len(p_nat)
    p_nat, l_nat, rate_ratio = map(np.asarray, (p_nat, l_nat, rate_ratio))
    if window is None or window >= n:
        f0_all = _median(p_nat[p_nat > 0]) or 1.0
        return {
            "f0": np.full(n, f0_all),
            "loud": np.full(n, _median(l_nat)),
            "rate": np.full(n, _median(rate_ratio)),
        }
    half = window // 2
    f0, loud, rate = np.empty(n), np.empty(n), np.empty(n)
    for i in range(n):
        lo, hi = max(0, i - half), min(n, i + half + 1)
        pw = p_nat[lo:hi]
        f0[i] = _median(pw[pw > 0]) or 1.0
        loud[i] = _median(l_nat[lo:hi])
        rate[i] = _median(rate_ratio[lo:hi])
    return {"f0": f0, "loud": loud, "rate": rate}


def pitch_adjust_pct(p_nat, f0_base, pitch_semitones: float, lower_clip_factor: float) -> torch.Tensor:
    """Semitone delta vs baseline, clipped to [−P·factor, +P], as percent;
    p_nat ≤ 0 → 0 %."""
    st = 12.0 * torch.log2(p_nat.clamp(min=1e-9) / f0_base)
    st = st.clamp(-pitch_semitones * lower_clip_factor, pitch_semitones)
    pct = (torch.exp2(st / 12.0) - 1.0) * 100.0
    return torch.where(p_nat > 0, pct, torch.zeros((), dtype=pct.dtype))


def volume_adjust_pct(loud_base, l_syn, volume_pct: float) -> torch.Tensor:
    """dB gap → linear percent, clipped ±volume_pct."""
    v = (torch.pow(10.0, (loud_base - l_syn) / 20.0) - 1.0) * 100.0
    return v.clamp(-volume_pct, volume_pct)


def rate_adjust_pct(wc, d_nat, d_syn, settings: ProsodySettings) -> torch.Tensor:
    """Speaking-rate delta with the reference's asymmetric length scaling:
    slow-downs ×len^1.5 and speed-ups ÷√len above 1 s, an extra slow floor,
    and a clamp of ±R (len ≤ 5 s) else [−1.5·R, +0.5·R]."""
    zero = torch.zeros((), dtype=torch.float32)
    one = torch.ones((), dtype=torch.float32)
    nat_r = wc / d_nat
    syn_r = wc / d_syn
    rp = torch.where(wc > 0, (nat_r - syn_r) / syn_r * 100.0, zero)
    length_s = d_nat
    slow_factor = torch.where(length_s <= 1.0, one, torch.pow(length_s, 1.5))
    fast_factor = torch.where(length_s <= 1.0, one, torch.sqrt(length_s))
    rp = torch.where(rp < 0, rp * slow_factor, rp / fast_factor)
    extra_slow = (length_s - settings.threshold_duration_before_slowing_down).clamp(min=0.0) * settings.slow_floor_per_sec
    rp = rp - extra_slow
    r = settings.rate_percent
    max_slowdown = torch.where(length_s > 5.0, torch.tensor(r * 1.5), torch.tensor(float(r)))
    max_speedup = torch.where(length_s > 5.0, torch.tensor(r * 0.5), torch.tensor(float(r)))
    return torch.minimum(torch.maximum(rp, -max_slowdown), max_speedup)


def ema_smooth(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """sm[0] = x[0]; sm[i] = α·x[i] + (1−α)·sm[i−1], in float32."""
    out = [x[0]]
    for cur in x[1:]:
        out.append(alpha * cur + (1.0 - alpha) * out[-1])
    return torch.stack(out)


def jump_limit(x: torch.Tensor, max_jump: float) -> torch.Tensor:
    """Max-jump limiter on the smoothed series, the limited predecessor
    feeding forward (the reference mutates the list it iterates)."""
    out = [x[0]]
    for cur in x[1:]:
        prev = out[-1]
        diff = cur - prev
        out.append(prev + torch.sign(diff) * max_jump if diff.abs() > max_jump else cur)
    return torch.stack(out)


def smooth_series(x, alpha: float, max_jump: float) -> torch.Tensor:
    """EMA then jump-limit — the reference's two-pass order (pitch and rate
    only; volume stays raw)."""
    return jump_limit(ema_smooth(torch.as_tensor(np.asarray(x), dtype=torch.float32), alpha), max_jump)
