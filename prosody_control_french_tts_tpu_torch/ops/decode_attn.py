"""Decode-step grouped-query attention over packed KV caches.

Counterpart of the TPU kernel ``ops/decode_attn.py:decode_attention`` of the
JAX package: the decode half of ``models.llm._fused_forward``. On CUDA
tensors :func:`decode_attention` launches the hand-written kernel
``csrc/decode_attn.cu`` (one block per batch row and KV head); on CPU
tensors it runs :func:`decode_attention_plain`, the same function in plain
PyTorch with the kernel's rounding points. The two agree to a tolerance,
not to bits: the order of the float32 sums and ``expf`` differ.
"""

from __future__ import annotations

import math

import torch

from . import kernels

HEAD_DIMS = (64, 128)  # the kernel is instantiated for these
MAX_GROUP = 8  # query heads per KV head the kernel keeps in registers
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches (CUDA path only)


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
    out = torch.empty_like(q)
    scores = torch.empty((B, H, pos + 1), dtype=torch.float32, device=dev)
    lib = kernels.library()
    global launches
    rc = lib.decode_attn_launch(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), scores.data_ptr(),
        B, S, kv_heads, group, hd, pos, float(1.0 / math.sqrt(hd)), _DTYPE_CODES[q.dtype],
        kernels.stream_ptr(q),
    )
    kernels.check(rc, "decode_attn")
    launches += 1
    return out
