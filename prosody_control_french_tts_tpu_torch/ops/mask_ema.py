"""Two-way exponential smoothing along time of a spectral mask.

The spectral-gate denoiser (``audio.denoise``) smooths its soft mask
[F, T] (bins by frames) along time, backward then forward, each pass the
linear recurrence ``v = smooth * prev + (1 - smooth) * cur`` started from
the first frame it visits. In the JAX package this is a ``lax.scan`` over
frames (``audio/denoise.py:_denoise_core``), XLA code and not a Pallas
kernel. At 44.1 kHz and hop 256 a 160 s recording has about 27,500 frames:
as a loop of torch operations that is some 160 k small launches, so on a
CUDA tensor :func:`mask_ema` launches the hand-written kernel
``csrc/mask_ema.cu``; on a CPU tensor it runs :func:`mask_ema_plain`, the
same recurrence as a PyTorch loop over frames. Every multiply and add is
rounded on its own in both, so they agree bit for bit.

The kernel cuts each pass into chunks of 256 frames, one thread a (bin,
chunk), each restarted :data:`WARMUP` frames ahead of its chunk, and a
fix-up launch recomputes from the true state every chunk that entered it
with another state than the true one (one call: four launches). The
recomputed chunks are added up on the card; :func:`fixup_count` reads the
sum (a synchronisation) and :func:`reset_fixups` clears it.
"""

from __future__ import annotations

import torch

from . import kernels

launches = 0  # kernel calls (CUDA path only; one call is the four launches of the two passes)

# Warm-up frames of a chunk's restart (at most the chunk's 256). On gate
# masks of synthetic segments joined by 1.5 s of zeros at smooth 0.5, 256
# frames enter every chunk with the true state and 128 do not (the gaps'
# values, about 3e-26, halve towards the subnormal floor): in the CPU model
# (tests/test_torch_ctc_mask_plan.py) and on the card, where the recomputed
# chunks cost more than the longer warm-up (tools/mask_ema_phases.py).
WARMUP = 256

_fixups: dict = {}  # CUDA device -> int64 [1], chunks recomputed by the fix-up launches


def fixup_count(device=None) -> int:
    """Chunks the fix-up launches recomputed on ``device`` (default: the
    current CUDA device) since the last :func:`reset_fixups`. Synchronises."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    t = _fixups.get(dev)
    return 0 if t is None else int(t.item())


def reset_fixups() -> None:
    for t in _fixups.values():
        t.zero_()


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
    if F > 65535:
        raise ValueError(f"mask_ema: {F} bins exceed the kernel's grid (65,535)")
    out = torch.empty_like(mask)
    if F == 0 or T == 0:
        return out
    dev = mask.device if mask.device.index is not None else torch.device("cuda", torch.cuda.current_device())
    counter = _fixups.get(dev)
    if counter is None:
        counter = _fixups[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = kernels.library()
    scratch = torch.empty_like(mask)
    enter = torch.empty((F, lib.mask_ema_chunks(T)), dtype=torch.float32, device=mask.device)
    global launches
    rc = lib.mask_ema_launch(
        mask.data_ptr(), out.data_ptr(), scratch.data_ptr(), enter.data_ptr(), counter.data_ptr(), F, T, float(smooth),
        float(1 - smooth), WARMUP, kernels.stream_ptr(mask),
    )
    kernels.check(rc, "mask_ema")
    launches += 1
    return out
