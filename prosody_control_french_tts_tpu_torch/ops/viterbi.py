"""Batched Praat pitch path finder (Viterbi) over [S, F, K] candidates.

Counterpart of the TPU kernel ``ops/viterbi_pallas.py:viterbi_pallas_batched``
of the JAX package. On CUDA tensors :func:`viterbi_path` launches the
hand-written kernel ``csrc/viterbi.cu`` (one block per segment: one warp
runs the back-pointer recurrence with the transition costs computed a tile
of frames ahead by the other three); on CPU tensors it runs :func:`viterbi_path_plain`, the same
recurrence as a PyTorch loop over frames, vectorised over segments, with
the same operations in the same order — the two agree bit for bit.

Inputs are computed once in torch by ``ops.pitch``: δ (per-candidate local
score), ``lf = log2(max(freq, 1e-6))`` and ``voiced``; the transition cost
is ``0`` between two unvoiced candidates, ``jump_cost·|lf_j − lf_k|``
between two voiced ones and ``vuv_cost`` otherwise.
"""

from __future__ import annotations

import torch

from . import kernels

MAX_K = 32  # candidates ride the lanes of one warp; back-pointers fit a byte

launches = 0  # kernel launches (CUDA path only)


def viterbi_path_plain(delta, lf, voiced, freq, vuv_cost: float, jump_cost: float) -> torch.Tensor:
    """delta, lf, freq float32 and voiced bool, each [S, F, K] → f0 [S, F]
    (0 where the chosen candidate is unvoiced)."""
    S, F, K = delta.shape
    vuv = torch.tensor(vuv_cost, dtype=torch.float32, device=delta.device)
    zero = torch.zeros((), dtype=torch.float32, device=delta.device)
    psi = delta[:, 0]
    back = []
    for t in range(1, F):
        lf_p, lf_c = lf[:, t - 1], lf[:, t]
        v_p, v_c = voiced[:, t - 1], voiced[:, t]
        both = v_p[:, :, None] & v_c[:, None, :]
        neither = (~v_p[:, :, None]) & (~v_c[:, None, :])
        jump = jump_cost * (lf_p[:, :, None] - lf_c[:, None, :]).abs()
        cost = torch.where(neither, zero, torch.where(both, jump, vuv))  # [S, j, k]
        total = psi[:, :, None] - cost
        back.append(torch.argmax(total, dim=1))  # first index of the max
        psi = total.amax(dim=1) + delta[:, t]
    cur = torch.argmax(psi, dim=-1)  # [S]
    path = [cur]
    for bp in reversed(back):
        cur = bp.gather(-1, cur[:, None])[:, 0]
        path.append(cur)
    path = torch.stack(path[::-1], dim=1)  # [S, F]
    f = freq.gather(-1, path[..., None])[..., 0]
    v = voiced.gather(-1, path[..., None])[..., 0]
    return torch.where(v, f, zero)


def viterbi_path(delta, lf, voiced, freq, vuv_cost: float, jump_cost: float) -> torch.Tensor:
    """Kernel B. Same contract as :func:`viterbi_path_plain`; CUDA tensors
    go through the CUDA kernel, CPU tensors through the plain version."""
    dev = delta.device
    if dev.type == "cpu":
        return viterbi_path_plain(delta, lf, voiced, freq, vuv_cost, jump_cost)
    if dev.type != "cuda":
        raise ValueError(f"viterbi_path: unsupported device {dev}")
    kernels.require(delta, "delta", torch.float32, 3, dev)
    kernels.require(lf, "lf", torch.float32, 3, dev)
    kernels.require(voiced, "voiced", torch.bool, 3, dev)
    kernels.require(freq, "freq", torch.float32, 3, dev)
    S, F, K = delta.shape
    for name, t in (("lf", lf), ("voiced", voiced), ("freq", freq)):
        if t.shape != delta.shape:
            raise ValueError(f"viterbi_path: {name} shape {tuple(t.shape)} != {tuple(delta.shape)}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"viterbi_path: K={K} outside [1, {MAX_K}]")
    back = torch.empty((S, F, K), dtype=torch.uint8, device=dev)
    f0 = torch.empty((S, F), dtype=torch.float32, device=dev)
    lib = kernels.library()
    global launches
    rc = lib.viterbi_launch(
        delta.data_ptr(), lf.data_ptr(), voiced.data_ptr(), freq.data_ptr(),
        back.data_ptr(), f0.data_ptr(), S, F, K, float(vuv_cost), float(jump_cost),
        kernels.stream_ptr(delta),
    )
    kernels.check(rc, "viterbi")
    launches += 1
    return f0
