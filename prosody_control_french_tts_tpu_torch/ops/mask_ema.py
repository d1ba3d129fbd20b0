"""Two-way exponential smoothing along time of a spectral mask.

The spectral-gate denoiser (``audio.denoise``) smooths its soft mask
[F, T] (bins by frames) along time, backward then forward, each pass the
linear recurrence ``v = smooth * prev + (1 - smooth) * cur`` started from
the first frame it visits. In the JAX package this is a ``lax.scan`` over
frames (``audio/denoise.py:_denoise_core``), XLA code and not a Pallas
kernel. At 44.1 kHz and hop 256 a 160 s recording has about 27,500 frames:
as a loop of torch operations that is some 160 k small launches, so on a
CUDA tensor :func:`mask_ema` launches the hand-written kernel
``csrc/mask_ema.cu`` (one thread per bin, both passes in one launch); on a
CPU tensor it runs :func:`mask_ema_plain`, the same recurrence as a PyTorch
loop over frames. Every multiply and add is rounded on its own in both, so
they agree bit for bit.
"""

from __future__ import annotations

import torch

from . import kernels

launches = 0  # kernel launches (CUDA path only)


def _check(mask: torch.Tensor) -> None:
    if mask.dtype != torch.float32:
        raise TypeError(f"mask_ema: mask has dtype {mask.dtype}, expected torch.float32")
    if mask.dim() != 2:
        raise ValueError(f"mask_ema: mask must be [F, T], got {tuple(mask.shape)}")


def mask_ema_plain(mask: torch.Tensor, smooth: float = 0.5) -> torch.Tensor:
    """mask [F, T] float32 → the same shape: the backward pass from frame
    T − 1, then the forward pass from frame 0 over its result."""
    _check(mask)
    a = torch.tensor(smooth, dtype=torch.float32, device=mask.device)
    b = torch.tensor(1 - smooth, dtype=torch.float32, device=mask.device)
    m = mask.T.contiguous()  # [T, F]: one frame a row
    T = m.shape[0]
    out = torch.empty_like(m)
    if T == 0:
        return out.T.contiguous()
    v = m[T - 1]
    out[T - 1] = v
    for t in range(T - 2, -1, -1):
        v = a * v + b * m[t]
        out[t] = v
    w = out[0]
    for t in range(1, T):
        w = a * w + b * out[t]
        out[t] = w
    return out.T.contiguous()


def mask_ema(mask: torch.Tensor, smooth: float = 0.5) -> torch.Tensor:
    """Same contract as :func:`mask_ema_plain`; a CUDA tensor goes through
    the CUDA kernel, a CPU tensor through the plain version."""
    _check(mask)
    if mask.device.type == "cpu":
        return mask_ema_plain(mask, smooth)
    if mask.device.type != "cuda":
        raise ValueError(f"mask_ema: unsupported device {mask.device}")
    kernels.require(mask, "mask", torch.float32, 2, mask.device)
    F, T = mask.shape
    if F >= 2**31:
        raise ValueError(f"mask_ema: {F} bins exceed the kernel's grid")
    out = torch.empty_like(mask)
    if F == 0 or T == 0:
        return out
    global launches
    rc = kernels.library().mask_ema_launch(
        mask.data_ptr(), out.data_ptr(), F, T, float(smooth), float(1 - smooth), kernels.stream_ptr(mask)
    )
    kernels.check(rc, "mask_ema")
    launches += 1
    return out
