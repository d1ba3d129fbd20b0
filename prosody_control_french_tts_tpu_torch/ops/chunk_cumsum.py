"""Exclusive prefix sums within 1024-column chunks.

Counterpart of the TPU kernel ``ops/pallas_kernels.py:chunk_cumsum`` of the
JAX package: for x [R, C] float32 with R % 8 == 0 and C % 1024 == 0,
``out[r, c] = sum(x[r, c0:c])`` where c0 starts c's 1024-column chunk. The
TPU kernel computes it as a shift-add ladder over [8, 1024] tiles, and both
versions here keep that association: :func:`chunk_cumsum_plain` in PyTorch
(bit-equal to the Pallas kernel in interpret mode on the CPU), and the
hand-written kernel ``csrc/chunk_cumsum.cu`` that :func:`chunk_cumsum`
launches on a CUDA tensor (bit-equal to the plain version on the card).
"""

from __future__ import annotations

import torch

from . import kernels

CUMSUM_CHUNK = 1024
CUMSUM_ROWS = 8  # the TPU kernel's row tile: R must be a multiple
MAX_CHUNKS = 4 * (2**31 - 1)  # the kernel's 1-D grid: 4 chunks (one a warp) per block

launches = 0  # kernel launches (CUDA path only)


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"chunk_cumsum: x has dtype {x.dtype}, expected torch.float32")
    if x.dim() != 2:
        raise ValueError(f"chunk_cumsum: x must be [R, C], got {tuple(x.shape)}")
    R, C = x.shape
    if R % CUMSUM_ROWS or C % CUMSUM_CHUNK or R == 0 or C == 0:
        raise ValueError(f"chunk_cumsum: [R, C] = [{R}, {C}] needs R % {CUMSUM_ROWS} == 0 and C % {CUMSUM_CHUNK} == 0")


def chunk_cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's ladder: 10 steps of
    ``acc += where(col >= s, shift(acc, s), 0)``, then ``acc − x``."""
    _check(x)
    R, C = x.shape
    t = x.reshape(R, C // CUMSUM_CHUNK, CUMSUM_CHUNK)
    col = torch.arange(CUMSUM_CHUNK, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    acc = t
    s = 1
    while s < CUMSUM_CHUNK:
        rolled = torch.roll(acc, s, dims=-1)
        acc = acc + torch.where(col >= s, rolled, zero)
        s *= 2
    return (acc - t).reshape(R, C)


def chunk_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Kernel E. Same contract as :func:`chunk_cumsum_plain`; a CUDA tensor
    goes through the CUDA kernel, a CPU tensor through the plain version."""
    _check(x)
    if x.device.type == "cpu":
        return chunk_cumsum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"chunk_cumsum: unsupported device {x.device}")
    kernels.require(x, "x", torch.float32, 2, x.device)
    R, C = x.shape
    if R * (C // CUMSUM_CHUNK) > MAX_CHUNKS:
        raise ValueError(f"chunk_cumsum: {R * (C // CUMSUM_CHUNK)} chunks exceed the grid's {MAX_CHUNKS}")
    out = torch.empty_like(x)
    global launches
    rc = kernels.library().chunk_cumsum_launch(x.data_ptr(), out.data_ptr(), R, C, kernels.stream_ptr(x))
    kernels.check(rc, "chunk_cumsum")
    launches += 1
    return out
