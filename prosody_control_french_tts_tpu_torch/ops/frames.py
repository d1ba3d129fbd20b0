"""Windowed frame gather at non-uniform starts.

Counterpart of the TPU kernels ``ops/pallas_kernels.py:extract_frames`` and
``extract_frames_aligned`` of the JAX package (and of its dispatcher
``frames_op``): ``frames[..., f, j] = x[..., start_f + j] · window[j]``.
The two TPU kernels compute the same function; the aligned one exists only
to satisfy Mosaic's DMA rules, which have no counterpart on the card, so
here one hand-written kernel (``csrc/frames.cu``) serves all three
wrappers. On a CUDA tensor each wrapper launches it; on a CPU tensor it
runs :func:`extract_frames_plain`, the JAX package's gather reference.

Shapes: x [T] or [B, T] float32, starts [F] or [B, F] int32, window [W]
float32 → [F, W] or [B, F, W]. Indices follow the reference gather:
``clip(start + j, 0, T − 1)``; on the contract domain
``starts ∈ [0, T − W]`` all the TPU entries agree with it.
"""

from __future__ import annotations

import torch

from . import kernels

MAX_W = 12288  # the window is staged in 48 KB of shared memory

launches = 0  # kernel launches (CUDA path only)


def extract_frames_plain(x: torch.Tensor, starts: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """The gather reference (``extract_frames_reference``): clipped indices,
    one gather, one multiply by the window."""
    T = x.shape[-1]
    W = window.shape[0]
    idx = (starts.to(torch.int64)[..., None] + torch.arange(W, device=x.device)).clamp(0, T - 1)
    if x.dim() == 1:
        return x[idx] * window
    B, F = starts.shape
    return x.gather(-1, idx.reshape(B, F * W)).reshape(B, F, W) * window


def _check(x, starts, window, width):
    if x.dim() not in (1, 2) or starts.dim() != x.dim():
        raise ValueError(f"frames: x {tuple(x.shape)} and starts {tuple(starts.shape)} must both be 1-D or both 2-D")
    if x.dim() == 2 and starts.shape[0] != x.shape[0]:
        raise ValueError(f"frames: {starts.shape[0]} rows of starts for {x.shape[0]} rows of x")
    if window.dim() != 1:
        raise ValueError("frames: window must be 1-D")
    if width is not None and int(width) != window.shape[0]:
        raise ValueError(f"frames: width {width} differs from the window's {window.shape[0]}")
    if x.dtype != torch.float32 or window.dtype != torch.float32:
        raise TypeError("frames: x and window must be float32")
    if starts.dtype != torch.int32:
        raise TypeError(f"frames: starts has dtype {starts.dtype}, expected torch.int32")
    if x.shape[-1] < 1 or window.shape[0] < 1:
        raise ValueError("frames: empty signal or window")


def _launch(x, starts, window):
    dev = x.device
    squeeze = x.dim() == 1
    x2 = x[None] if squeeze else x
    s2 = starts[None] if squeeze else starts
    kernels.require(x2, "x", torch.float32, 2, dev)
    kernels.require(s2, "starts", torch.int32, 2, dev)
    kernels.require(window, "window", torch.float32, 1, dev)
    B, T = x2.shape
    F = s2.shape[1]
    W = window.shape[0]
    if W > MAX_W:
        raise ValueError(f"frames: window {W} exceeds the kernel's {MAX_W}")
    if B > 65535:
        raise ValueError(f"frames: {B} rows exceed the grid's 65535")
    out = torch.empty((B, F, W), dtype=torch.float32, device=dev)
    global launches
    rc = kernels.library().frames_launch(
        x2.data_ptr(), s2.data_ptr(), window.data_ptr(), out.data_ptr(), B, T, F, W, kernels.stream_ptr(x2)
    )
    kernels.check(rc, "frames")
    launches += 1
    return out[0] if squeeze else out


def _frames(x, starts, window, width):
    _check(x, starts, window, width)
    if x.device.type == "cpu":
        return extract_frames_plain(x, starts, window)
    if x.device.type != "cuda":
        raise ValueError(f"frames: unsupported device {x.device}")
    return _launch(x, starts, window)


def extract_frames(x: torch.Tensor, starts: torch.Tensor, window: torch.Tensor, width: int | None = None) -> torch.Tensor:
    """Kernel C (``extract_frames``): frames [.., F, W] at the given starts."""
    return _frames(x, starts, window, width)


def extract_frames_aligned(x: torch.Tensor, starts: torch.Tensor, window: torch.Tensor, width: int | None = None) -> torch.Tensor:
    """Kernel D (``extract_frames_aligned``): the same function as
    :func:`extract_frames`, through the same CUDA kernel."""
    return _frames(x, starts, window, width)


def frames_op(x: torch.Tensor, starts: torch.Tensor, window: torch.Tensor, width: int | None = None) -> torch.Tensor:
    """The dispatcher: the kernel for CUDA tensors, the plain gather for CPU
    tensors. Contract: starts ∈ [0, T − W]."""
    return _frames(x, starts, window, width)
