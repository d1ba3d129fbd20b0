"""Pitch candidates: local maxima → top-k → parabolic interpolation.

Counterpart of the TPU kernel ``ops/pallas_kernels.py:topk_parabolic`` of
the JAX package. On a CUDA tensor :func:`topk_parabolic` launches the
hand-written kernel ``csrc/pitch_candidates.cu``; on a CPU tensor it runs
:func:`topk_parabolic_plain`, the same function in plain PyTorch (the
JAX package's XLA candidate stage, with top-k as k rounds of masked
first-index argmax — ``torch.topk`` leaves its tie order unspecified).
"""

from __future__ import annotations

import torch

from . import kernels

MAX_L = 1024  # the kernel keeps a row's lags in registers, at most 32 per lane

launches = 0  # kernel launches (CUDA path only)


def topk_parabolic_plain(r: torch.Tensor, k: int, min_lag: int, max_lag: int, vth: float):
    """r [rows, L] float32 → (lag_f, strength float32, valid bool), each
    [rows, k]: the k strongest parabolic-interpolated local maxima per row,
    descending (ties to the smallest lag), zeros past the row's maxima."""
    R, L = r.shape
    lag = torch.arange(L, device=r.device)
    interior = (lag >= min_lag) & (lag < max_lag)
    r_m1 = torch.cat([r[:, :1], r[:, :-1]], dim=-1)
    r_p1 = torch.cat([r[:, 1:], r[:, -1:]], dim=-1)
    is_max = (r > r_m1) & (r >= r_p1) & (r > 0.5 * vth) & interior[None, :]
    score = torch.where(is_max, r, float("-inf"))
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(score, dim=-1)  # first index of the max
        v = score.gather(-1, i[:, None])[:, 0]
        vals.append(v)
        idxs.append(i)
        score = score.scatter(-1, i[:, None], float("-inf"))
    top_val = torch.stack(vals, dim=-1)
    top_lag = torch.stack(idxs, dim=-1)
    valid = torch.isfinite(top_val)

    safe = top_lag.clamp(1, L - 2)
    rv = r.gather(-1, safe)
    rl = r.gather(-1, safe - 1)
    rr = r.gather(-1, safe + 1)
    dr = 0.5 * (rr - rl)
    d2r = 2.0 * rv - rl - rr
    offset = torch.where(d2r.abs() > 1e-12, dr / d2r, torch.zeros((), dtype=r.dtype, device=r.device))
    lag_f = safe.to(torch.float32) + offset.clamp(-1.0, 1.0)
    strength = rv + 0.5 * dr * offset  # the UNCLIPPED offset
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    return torch.where(valid, lag_f, zero), torch.where(valid, strength, zero), valid


def topk_parabolic(r: torch.Tensor, k: int, min_lag: int, max_lag: int, vth: float):
    """Kernel A. Same contract as :func:`topk_parabolic_plain`; a CUDA
    tensor goes through the CUDA kernel, a CPU tensor through the plain
    version."""
    if r.device.type == "cpu":
        return topk_parabolic_plain(r, k, min_lag, max_lag, vth)
    if r.device.type != "cuda":
        raise ValueError(f"topk_parabolic: unsupported device {r.device}")
    kernels.require(r, "r", torch.float32, 2, r.device)
    R, L = r.shape
    if L > MAX_L:
        raise ValueError(f"topk_parabolic: L={L} exceeds the kernel's {MAX_L} lags")
    if not (1 <= min_lag and max_lag <= L - 1):
        raise ValueError(f"topk_parabolic: lags [{min_lag}, {max_lag}) must be interior to L={L}")
    if k < 1:
        raise ValueError("topk_parabolic: k must be >= 1")
    lag_f = torch.empty((R, k), dtype=torch.float32, device=r.device)
    strength = torch.empty((R, k), dtype=torch.float32, device=r.device)
    valid = torch.empty((R, k), dtype=torch.bool, device=r.device)  # the kernel writes bytes 0 and 1
    lib = kernels.library()
    global launches
    rc = lib.pitch_candidates_launch(
        r.data_ptr(), lag_f.data_ptr(), strength.data_ptr(), valid.data_ptr(),
        R, L, k, int(min_lag), int(max_lag), float(0.5 * vth), kernels.stream_ptr(r),
    )
    kernels.check(rc, "pitch_candidates")
    launches += 1
    return lag_f, strength, valid
