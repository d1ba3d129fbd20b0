"""NF4 dequantization of a frozen base kernel (``csrc/nf4_dequant.cu``).

A QLoRA base kernel is stored as NF4 codes packed two a byte, ``packed``
[in/2, out] uint8 (rows 2i and 2i+1 in the low and high nibble of byte i),
with a float32 scale a block of 64 rows and a column, ``scale`` [in/64,
out]. Each weight is its code's NF4 level times its block's scale, rounded
once in float32 and, for bfloat16, once more. The JAX package does this in
XLA (``models/quant.py:dequant_nf4``); it is no Pallas kernel. In the port
``models.quant.dequant_nf4`` calls :func:`nf4_dequant` on every use of a
quantized kernel: three times a kernel a QLoRA micro-step. As eager PyTorch
that is four kernels a call (widen the codes, gather the levels, the
product, the cast), some 26 bytes moved a weight; the kernel moves 2.5625 in
one launch.

On a CUDA tensor :func:`nf4_dequant` launches the kernel; on a CPU tensor it
runs :func:`nf4_dequant_plain`, the eager version, whose float32 products
and rounding to bfloat16 give the kernel's bits. :func:`plan` is the
launch's shape: how many threads share a scale block's packed rows.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import kernels
from ..models import quant

launches = 0  # kernel launches (CUDA path only; one a call)

BLOCK = 64  # rows of a scale block: the kernel's, quant.NF4_BLOCK
ROW_BYTES = 16  # output bytes of a thread a row, one 16-byte store: 8 bfloat16 columns, 4 float32
PACKED_ROWS = BLOCK // 2  # packed rows of a scale block
BLOCK_THREADS = 256  # threads of a thread block
# threads that share a scale block's 32 packed rows: 4 rows a thread. On an
# H100 80GB HBM3 at 700 W (PERF.md §6) 4 rows a thread came within 2 % of
# the best split at each of stage B's four shapes; 16 rows were up to 6 %
# slower, 32 up to 2.9x
SPLIT = 8

_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


class Plan(NamedTuple):
    cols: int  # columns of a thread, ROW_BYTES over the output's item size
    groups: int  # column groups of ``cols`` columns (the last one short where out % cols)
    blocks: int  # scale blocks, in / 64
    split: int  # threads that share a scale block's 32 packed rows: 8, 16 or 32
    rows: int  # packed rows of a thread, 32 / split


@functools.lru_cache(maxsize=None)
def plan(in_f: int, out_f: int, sms: int, itemsize: int = 2) -> Plan:
    """The launch for an [in_f, out_f] kernel of ``itemsize``-byte items
    (2: bfloat16, 4: float32) on a card of ``sms`` SMs: each thread takes
    ROW_BYTES of output a row of one scale block and SPLIT's share of its
    packed rows; where the grid would then have fewer thread blocks than the
    card has SMs (few columns: k and v), the rows are split over 16 or 32
    threads."""
    if in_f <= 0 or out_f <= 0 or in_f % BLOCK:
        raise ValueError(f"nf4_dequant: in_f {in_f} must be a positive multiple of {BLOCK}, out_f {out_f} positive")
    cols = ROW_BYTES // itemsize
    groups, blocks = -(-out_f // cols), in_f // BLOCK
    split = SPLIT
    while split < PACKED_ROWS and groups * blocks * split < sms * BLOCK_THREADS:
        split *= 2
    return Plan(cols, groups, blocks, split, PACKED_ROWS // split)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def nf4_dequant_plain(packed: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype, block: int = BLOCK) -> torch.Tensor:
    """Codebook lookup → blockwise rescale in float32 → ``dtype``. One
    lookup a byte gives both of its levels ([2, in/2, out]); the rescale
    writes them interleaved, rows 2i and 2i+1, into the [in, out] result."""
    half, out_f = packed.shape
    in_f = half * 2
    pairs = quant._on_device("NF4_PAIRS", packed.device)[:, packed.long()]  # [2, in/2, out]
    w = torch.empty((in_f // block, block // 2, 2, out_f), dtype=torch.float32, device=packed.device)
    torch.mul(pairs.permute(1, 0, 2).reshape(in_f // block, block // 2, 2, out_f), scale.float()[:, None, None, :], out=w)
    return w.reshape(in_f, out_f).to(dtype)


def nf4_dequant(packed: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype, block: int = BLOCK) -> torch.Tensor:
    """Same contract as :func:`nf4_dequant_plain`; a CUDA tensor goes through
    the CUDA kernel, which takes bfloat16 or float32 out, contiguous uint8
    codes and float32 scales, blocks of 64 rows and ``in`` a multiple of 64,
    and raises on anything else. A CPU tensor goes through the plain
    version."""
    if packed.device.type == "cpu":
        return nf4_dequant_plain(packed, scale, dtype, block)
    if packed.device.type != "cuda":
        raise ValueError(f"nf4_dequant: unsupported device {packed.device}")
    if dtype not in _DTYPES:
        raise TypeError(f"nf4_dequant: the kernel writes bfloat16 or float32, not {dtype}")
    kernels.require(packed, "packed", torch.uint8, 2, packed.device)
    kernels.require(scale, "scale", torch.float32, 2, packed.device)
    half, out_f = packed.shape
    in_f = half * 2
    if block != BLOCK or in_f % BLOCK or tuple(scale.shape) != (in_f // BLOCK, out_f):
        raise ValueError(f"nf4_dequant: the kernel takes blocks of {BLOCK} rows, in a multiple of {BLOCK} and scales "
                         f"[in/{BLOCK}, out]; got block {block}, packed {tuple(packed.shape)}, scale {tuple(scale.shape)}")
    out = torch.empty((in_f, out_f), dtype=dtype, device=packed.device)
    if out.numel() == 0:
        return out
    dev = packed.device
    p = plan(in_f, out_f, _sms(dev.index if dev.index is not None else torch.cuda.current_device()), dtype.itemsize)
    rc = kernels.library().nf4_dequant_launch(
        packed.data_ptr(), scale.data_ptr(), quant._on_device("NF4_TABLE", dev).data_ptr(), out.data_ptr(), in_f, out_f,
        p.split, _DTYPES[dtype], kernels.stream_ptr(packed),
    )
    kernels.check(rc, "nf4_dequant")
    global launches
    launches += 1
    return out
