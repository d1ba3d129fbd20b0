"""Causal flash attention for long training sequences, forward and backward.

Counterpart of the upstream Pallas TPU flash-attention op that the JAX
package's model calls with ``attn_impl="flash"`` (``models.llm.Attention``):
``flash_attention(q, k, v, causal=True, sm_scale=...)`` on q, k, v
``[B, H, L, hd]`` with K/V already repeated to all heads, L a multiple of 128,
no upper bound on L. On CUDA tensors :func:`flash_attention` launches the
hand-written kernels of ``csrc/flash_attention.cu`` behind a
``torch.autograd.Function``: a forward with an online softmax over streamed
K/V tiles (no whole score row is ever held), then a backward of two kernels in
the upstream split, dq by query tile and dk/dv by key tile, without atomics,
so two backward runs give the same bits. bfloat16 runs on the tensor cores
(``mma.sync``), float32 on the CUDA cores (no TF32).

On CPU tensors it runs :func:`flash_attention_plain`, plain PyTorch with the
upstream op's rounding points, forward and backward:

- forward, in 128-key tiles, tiles above the diagonal skipped: ``s`` the
  float32 product, then ``s *= sm_scale``, then the additive mask
  ``s + where(causal, 0, MASK_VALUE)``; ``m_next = max(m_prev, rowmax s)``,
  ``p = exp(s − m_next)``, ``l_next = rowsum p + exp(m_prev − m_next)·l_prev``
  and the accumulator rescaled in every tile,
  ``acc·(l_corr/l_next) + (p rounded to v's type @ v)·(1/l_next)``. At L = 128
  (one tile) ``p`` is normalised before the cast, as the upstream single-step
  body does. The residuals are l and m, float32 ``[B, H, L]``.
- backward: ``di = rowsum(o·do)`` in float32, ``p = exp(s − m)·(1/l)``,
  ``dv = pᵀ @ do`` and ``dk = dsᵀ @ q`` with ``ds = (do vᵀ − di)·p·sm_scale``,
  ``dq = ds @ k``; ``p`` and ``ds`` rounded to the operands' type before their
  products, the sums in float32.

The kernels are held to the plain version to a tolerance, not to bits: their
tiles are 64 keys (bfloat16) and 32 keys (float32), so the running max that
``p`` is rounded against moves at other points, and sums run in another order.
"""

from __future__ import annotations

import torch

from . import kernels

BLOCK = 128  # the upstream op's tile: L must be a multiple
HEAD_DIMS = (64, 128)  # the CUDA kernels are instantiated for these
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # the upstream additive mask
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

calls = 0  # wrapper calls, any device (the dispatch tests read it)
launches = 0  # forward kernel launches (CUDA path only)
launches_bwd = 0  # backward calls (CUDA path only; one per backward, whatever its number of kernels)


def _scores(qt, kt, sm_scale: float, diag: bool) -> torch.Tensor:
    """The float32 scores of query tiles against one key tile, scaled after the
    product; ``diag``: the tiles sit on the diagonal and take the causal mask."""
    s = qt.float() @ kt.float().transpose(-1, -2)
    if sm_scale != 1.0:
        s = s * sm_scale
    if diag:
        n = s.shape[-1]
        causal = torch.ones((n, n), dtype=torch.bool, device=s.device).tril()
        s = s + torch.where(causal, 0.0, MASK_VALUE)
    return s


def _forward_plain(q, k, v, sm_scale: float):
    """(o, l, m): the upstream forward's recurrence, vectorised over the query
    tiles at or below each key tile."""
    B, H, L, hd = q.shape
    n = L // BLOCK
    if n == 1:  # the upstream single-step body: p normalised before the cast
        s = _scores(q, k, sm_scale, True)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        p = p / l
        o = p.to(v.dtype).float() @ v.float()
        return o.to(q.dtype), l[..., 0], m[..., 0]
    qt = q.reshape(B, H, n, BLOCK, hd)
    kt = k.reshape(B, H, n, BLOCK, hd)
    vt = v.reshape(B, H, n, BLOCK, hd)
    m = torch.full((B, H, n, BLOCK, 1), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, n, BLOCK, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, n, BLOCK, hd), dtype=torch.float32, device=q.device)
    for j in range(n):  # key tile j meets query tiles j .. n-1; tile j alone on the diagonal
        for diag, rows in ((True, slice(j, j + 1)), (False, slice(j + 1, n))):
            if rows.start >= n:
                continue
            s = _scores(qt[:, :, rows], kt[:, :, j : j + 1], sm_scale, diag)
            m_prev, l_prev = m[:, :, rows], l[:, :, rows]
            m_next = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_next)
            l_corr = torch.exp(m_prev - m_next) * l_prev
            l_next = p.sum(dim=-1, keepdim=True) + l_corr
            inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
            o_curr = p.to(v.dtype).float() @ vt[:, :, j : j + 1].float()
            acc[:, :, rows] = acc[:, :, rows] * (l_corr * inv) + o_curr * inv
            m[:, :, rows], l[:, :, rows] = m_next, l_next
    o = acc.reshape(B, H, L, hd).to(q.dtype)
    return o, l.reshape(B, H, L), m.reshape(B, H, L)


def _backward_plain(q, k, v, o, l, m, do, sm_scale: float):
    """(dq, dk, dv) of the upstream backward, on the whole score matrix: the
    tiles above the diagonal give p = 0 and ds = 0 exactly, so only the order
    of the float32 sums differs from the tiled kernels."""
    di = (o.float() * do.float()).sum(dim=-1, keepdim=True)
    s = _scores(q, k, sm_scale, True)
    p = torch.exp(s - m[..., None]) * (1.0 / l[..., None])
    dv = p.transpose(-1, -2).to(do.dtype).float() @ do.float()
    dp = do.float() @ v.float().transpose(-1, -2)
    ds = (dp - di) * p
    if sm_scale != 1.0:
        ds = ds * sm_scale
    dk = ds.transpose(-1, -2).to(do.dtype).float() @ q.float()
    dq = ds.to(k.dtype).float() @ k.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashPlain(torch.autograd.Function):
    """The plain version: forward and backward in plain PyTorch, any device."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, l, m = _forward_plain(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, l, m)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m = ctx.saved_tensors
        return (*_backward_plain(q, k, v, o, l, m, do, ctx.sm_scale), None)


def flash_attention_plain(q, k, v, sm_scale: float = 1.0) -> torch.Tensor:
    """Causal attention [B, H, L, hd] in plain PyTorch with the upstream op's
    rounding points, differentiable in q, k and v (module docstring)."""
    _check(q, k, v)
    return _FlashPlain.apply(q, k, v, float(sm_scale))


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k and v must all be [B, H, L, hd], got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    L = q.shape[2]
    if L < BLOCK or L % BLOCK:
        raise ValueError(f"flash_attention: L={L} is not a positive multiple of {BLOCK}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share a dtype")


def _prepare(tensors, names, dtype, dev):
    out = []
    for name, t in zip(names, tensors):
        t = t.contiguous()
        kernels.require(t, name, dtype, 4, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")
        out.append(t)
    return out


class _FlashAttention(torch.autograd.Function):
    """The CUDA path: forward and backward are launches of ``csrc/flash_attention.cu``."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        global launches
        dev = q.device
        if q.dtype not in _DTYPE_CODES:
            raise TypeError(f"flash_attention: dtype {q.dtype} is not float32 or bfloat16")
        B, H, L, hd = q.shape
        if hd not in HEAD_DIMS:
            raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS} (the kernels are built for these)")
        q, k, v = _prepare((q, k, v), ("q", "k", "v"), q.dtype, dev)
        o = torch.empty_like(q)
        l = torch.empty((B, H, L), dtype=torch.float32, device=dev)
        m = torch.empty_like(l)
        rc = kernels.library().flash_attn_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(),
            B, H, L, hd, float(sm_scale), _DTYPE_CODES[q.dtype], kernels.stream_ptr(q),
        )
        kernels.check(rc, "flash_attn_fwd")
        launches += 1
        ctx.save_for_backward(q, k, v, o, l, m)
        ctx.sm_scale = float(sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        global launches_bwd
        q, k, v, o, l, m = ctx.saved_tensors
        B, H, L, hd = q.shape
        (do,) = _prepare((do,), ("do",), q.dtype, q.device)  # it arrives as a view of the caller's transpose
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        di = torch.empty_like(l)
        rc = kernels.library().flash_attn_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), l.data_ptr(), m.data_ptr(),
            di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, L, hd, ctx.sm_scale,
            _DTYPE_CODES[q.dtype], kernels.stream_ptr(q),
        )
        kernels.check(rc, "flash_attn_bwd")
        launches_bwd += 1
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True, sm_scale: float = 1.0) -> torch.Tensor:
    """out [B, H, L, hd] = causal softmax(q kᵀ · sm_scale) v for q, k, v
    [B, H, L, hd] (K/V repeated to all heads), L a positive multiple of 128;
    differentiable in q, k and v. CUDA tensors go through the CUDA kernels
    (hd 64 or 128, float32 or bfloat16), CPU tensors through the plain
    version. Only the causal form is ported."""
    global calls
    if not causal:
        raise NotImplementedError("flash_attention: only causal=True is ported")
    _check(q, k, v)
    calls += 1
    dev = q.device
    if dev.type == "cpu":
        return _FlashPlain.apply(q, k, v, float(sm_scale))
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    return _FlashAttention.apply(q, k, v, float(sm_scale))
