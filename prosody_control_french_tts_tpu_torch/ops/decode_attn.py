"""Decode-step grouped-query attention over packed KV caches.

Counterpart of the TPU kernel ``ops/decode_attn.py:decode_attention`` of the
JAX package: the decode half of ``models.llm._fused_forward``. On CUDA
tensors :func:`decode_attention` launches the hand-written kernel
``csrc/decode_attn.cu``: one launch, one thread-block cluster of C blocks per
batch row and KV head, the live cache rows split over the cluster's blocks
(:func:`split_plan`, :func:`block_rows`) and the softmax's max and sum
exchanged through distributed shared memory. On CPU tensors it runs
:func:`decode_attention_plain`, the same function in plain PyTorch with the
kernel's rounding points. The two agree to a tolerance, not to bits: the
order of the float32 sums and ``expf`` differ. The kernel gives the same
bits from call to call.
"""

from __future__ import annotations

import functools
import math

import torch

from . import kernels

HEAD_DIMS = (64, 128)  # the kernel is instantiated for these
MAX_GROUP = 8  # query heads per KV head: the products' A operand has 16 rows, the exchange 8 slots
MAX_CLUSTER = 8  # blocks per cluster: the portable cluster size
MAX_BLOCK_ROWS = 2048  # cache rows a block's shared memory holds scores for
PLAN_BLOCK_ROWS = 192  # rows a block takes at most where the cluster can grow: three 64-row tiles
H100_SMS = 132
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches (CUDA path only)


def split_plan(B: int, kv_heads: int, S: int, sms: int = H100_SMS) -> int:
    """Blocks per cluster C for caches [B, S, kv_heads·hd]: the smallest power
    of two with at least one block for every two SMs (2·B·kv_heads·C ≥ sms)
    and at most PLAN_BLOCK_ROWS cache rows a block, at most MAX_CLUSTER, and
    enough blocks that none holds more than MAX_BLOCK_ROWS rows. (On the H100
    at both serving shapes C = 2 beat C = 1 and C = 4: a larger cluster pays
    more for its three barriers, a smaller one more rows a block; PERF.md.)
    It depends on the shapes only, never on ``pos``, so a decode step keeps
    one launch configuration over a whole generation. The grid is
    (C, kv_heads, B) with clusters of (C, 1, 1)."""
    c = 1
    while c < MAX_CLUSTER and (2 * B * kv_heads * c < sms or -(-S // c) > PLAN_BLOCK_ROWS):
        c *= 2
    if -(-S // c) > MAX_BLOCK_ROWS:
        raise ValueError(f"decode_attention: a cache of {S} rows exceeds {MAX_CLUSTER} x {MAX_BLOCK_ROWS} rows")
    return c


def block_rows(rank: int, n: int, C: int) -> range:
    """The live cache rows (of n = pos + 1) that block ``rank`` of a cluster
    of C takes: ceil(n / C) rows each, the last blocks fewer or none. The
    kernel computes the same split."""
    chunk = -(-n // C)
    r0 = min(n, rank * chunk)
    return range(r0, min(n, r0 + chunk))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention_plain(q, kc, vc, pos: int, kv_heads: int) -> torch.Tensor:
    """q [B, H, hd], kc/vc [B, S, kv_heads·hd] packed caches with row ``pos``
    already written → [B, H, hd] in q's dtype, attending to rows 0..pos.

    Scores are float32 sums of float32-upcast operands times ``1/√hd``, the
    softmax is float32, the probabilities are rounded to V's dtype, and the
    second product accumulates in float32 before the cast to q's dtype."""
    B, H, hd = q.shape
    n = int(pos) + 1
    group = H // kv_heads
    k = kc[:, :n].reshape(B, n, kv_heads, hd).float()
    v = vc[:, :n].reshape(B, n, kv_heads, hd).float()
    qg = q.reshape(B, kv_heads, group, hd).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) * (1.0 / math.sqrt(hd))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(vc.dtype).float()
    out = torch.einsum("bhgs,bshd->bhgd", p, v)
    return out.reshape(B, H, hd).to(q.dtype)


def decode_attention(q, kc, vc, pos: int, kv_heads: int) -> torch.Tensor:
    """Kernel F. Same contract as :func:`decode_attention_plain`; CUDA
    tensors go through the CUDA kernel, CPU tensors through the plain
    version. ``pos`` is a host integer, passed to the kernel by value."""
    dev = q.device
    pos = int(pos)
    if q.dim() != 3 or kc.dim() != 3:
        raise ValueError("decode_attention: q must be [B, H, hd] and the caches [B, S, kv_heads*hd]")
    B, H, hd = q.shape
    S = kc.shape[1]
    if H % kv_heads or kc.shape != (B, S, kv_heads * hd) or vc.shape != kc.shape:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)}, kc {tuple(kc.shape)}, vc {tuple(vc.shape)} "
            f"do not fit kv_heads={kv_heads}"
        )
    if not 0 <= pos < S:
        raise ValueError(f"decode_attention: pos={pos} outside the cache's {S} rows")
    if dev.type == "cpu":
        return decode_attention_plain(q, kc, vc, pos, kv_heads)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {dev}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"decode_attention: dtype {q.dtype} is not float32 or bfloat16")
    kernels.require(q, "q", q.dtype, 3, dev)
    kernels.require(kc, "kc", q.dtype, 3, dev)
    kernels.require(vc, "vc", q.dtype, 3, dev)
    group = H // kv_heads
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {hd} not in {HEAD_DIMS}")
    if group > MAX_GROUP:
        raise ValueError(f"decode_attention: {group} query heads per KV head exceed {MAX_GROUP}")
    for name, t in (("q", q), ("kc", kc), ("vc", vc)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} is not 16-byte aligned")
    clusters = split_plan(B, kv_heads, S, _sm_count(dev.index))
    out = torch.empty_like(q)
    lib = kernels.library()
    global launches
    rc = lib.decode_attn_launch(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
        B, S, kv_heads, group, hd, pos, float(1.0 / math.sqrt(hd)), _DTYPE_CODES[q.dtype], clusters,
        kernels.stream_ptr(q),
    )
    kernels.check(rc, "decode_attn")
    launches += 1
    return out
