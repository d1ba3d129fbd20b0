"""Causal flash attention for long training sequences, forward and backward.

Counterpart of the upstream Pallas TPU flash-attention op that the JAX
package's model calls with ``attn_impl="flash"`` (``models.llm.Attention``):
``flash_attention(q, k, v, causal=True, sm_scale=...)`` on q, k, v
``[B, H, L, hd]`` with K/V already repeated to all heads, L a multiple of 128,
no upper bound on L. Two entries:

- :func:`flash_attention_gqa` (the model's): q ``[B, L, H, hd]`` and k, v
  ``[B, L, KVH, hd]`` as ``Attention`` holds them, query head h reading KV
  head h // (H // KVH) (``jnp.repeat``'s order), dk and dv back at KVH heads;
- :func:`flash_attention` (the upstream op's signature and layout, group 1),
  kept for the tests that hold it to the upstream op in interpret mode.

On CUDA tensors both launch the same hand-written kernels of
``csrc/flash_attention.cu`` behind one ``torch.autograd.Function``; the
kernels take each tensor's strides and the group, so nothing is repeated,
transposed or copied around them: a forward with an online softmax over
streamed K/V tiles (no whole score row is ever held), then a backward in the
upstream split, dq by query tile and dk/dv by key tile (the group's heads
added in a fixed order), without atomics, so two backward runs give the same
bits. bfloat16 runs on ``wgmma`` fed by TMA, float32 on the CUDA cores (no
TF32). :func:`tile_plan` orders the bf16 kernels' blocks.

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

The kernels are held to the plain version to a tolerance, not to bits: the
forward's key tiles are 128 keys (bfloat16) and 32 (float32), the sum stays
unnormalised until the end, so the running max that ``p`` is rounded against
moves at other points, and sums run in another order.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels

BLOCK = 128  # the upstream op's tile: L must be a multiple
HEAD_DIMS = (64, 128)  # the CUDA kernels are instantiated for these
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # the upstream additive mask
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

calls = 0  # wrapper calls of either entry, any device (the dispatch tests read it)
launches = 0  # forward kernel launches of either entry (CUDA path only)
launches_bwd = 0  # backward calls of either entry (CUDA path only; one per backward, whatever its number of kernels)


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


def repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """[B, L, KVH, hd] → [B, KVH·group, L, hd], the upstream op's layout,
    each KV head repeated ``group`` times in place (head h reads KV head
    h // group): ``jnp.repeat``'s head order, then heads before L. Written as
    transpose + expand + reshape, one copy, so its backward sums over the
    expanded axis: the same bits every run, where an index-add would not be."""
    B, L, KVH, hd = x.shape
    return x.transpose(1, 2)[:, :, None].expand(B, KVH, group, L, hd).reshape(B, KVH * group, L, hd)


def tile_plan(B: int, H: int, tiles: int, descending: bool) -> list[tuple[int, int, int]]:
    """The bf16 kernels' work order, one (b, h, tile) per block: the longest
    tiles first (the forward's and dq's query tiles from the last,
    ``descending``; dk/dv's key tiles from the first), and
    within a tile b then h, so that the heads of one KV group (h // group) are
    neighbours and read the same K/V tiles from L2."""
    order = range(tiles - 1, -1, -1) if descending else range(tiles)
    return [(b, h, t) for t in order for b in range(B) for h in range(H)]


_PLANS: dict = {}


def _plan_tensor(B, H, tiles, descending, dev) -> torch.Tensor:
    key = (B, H, tiles, descending, dev)
    if key not in _PLANS:
        _PLANS[key] = torch.tensor(tile_plan(B, H, tiles, descending), dtype=torch.int32).to(dev)
    return _PLANS[key]


# the element strides (batch, row, head) of a 4-D tensor in each entry's layout
_LAYOUT_DIMS = {"blhd": (0, 1, 2), "bhld": (0, 2, 1)}


def _strides(t: torch.Tensor, layout: str) -> tuple[int, int, int]:
    return tuple(t.stride(d) for d in _LAYOUT_DIMS[layout])


def _usable(t: torch.Tensor, layout: str) -> bool:
    """The kernels read t in place: hd contiguous, the other strides multiples
    of 16 bytes (TMA's rule), 16-byte aligned."""
    unit = 16 // t.element_size()
    return t.stride(3) == 1 and all(s > 0 and s % unit == 0 for s in _strides(t, layout)) and t.data_ptr() % 16 == 0


def _check_cuda(tensors, names, layout) -> None:
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: dtype {dtype} is not float32 or bfloat16")
    hd = tensors[0].shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS} (the kernels are built for these)")
    for name, t in zip(names, tensors):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"flash_attention: {name} has dtype {t.dtype}, expected {dtype}")
        if not _usable(t, layout):
            raise ValueError(f"flash_attention: {name}'s strides {tuple(t.stride())} or address are not ones TMA takes "
                             "(hd contiguous, other strides multiples of 16 bytes, 16-byte aligned)")


def _stride_array(tensors, layout):
    vals = [s for t in tensors for s in _strides(t, layout)]
    return (ctypes.c_longlong * len(vals))(*vals)


class _FlashAttention(torch.autograd.Function):
    """The CUDA path: forward and backward are launches of
    ``csrc/flash_attention.cu``, on q [.., H, ..] and k, v [.., KVH, ..] in
    ``layout`` ("blhd": the model's [B, L, heads, hd]; "bhld": the upstream
    [B, heads, L, hd]), read in place through their strides."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, layout):
        global launches
        _check_cuda((q, k, v), ("q", "k", "v"), layout)
        dims = _LAYOUT_DIMS[layout]
        B, L, H, hd = q.shape[dims[0]], q.shape[dims[1]], q.shape[dims[2]], q.shape[3]
        KVH = k.shape[dims[2]]
        dev = q.device
        o = torch.empty(q.shape, dtype=q.dtype, device=dev)
        l = torch.empty((B, H, L), dtype=torch.float32, device=dev)
        m = torch.empty_like(l)
        plan = _plan_tensor(B, H, L // BLOCK, True, dev)
        rc = kernels.library().flash_attn_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(), plan.data_ptr(),
            plan.shape[0], B, H, KVH, L, hd, _stride_array((q, k, v, o), layout), float(sm_scale),
            _DTYPE_CODES[q.dtype], kernels.stream_ptr(q),
        )
        kernels.check(rc, "flash_attn_fwd")
        launches += 1
        ctx.save_for_backward(q, k, v, o, l, m)
        ctx.sm_scale = float(sm_scale)
        ctx.layout = layout
        return o

    @staticmethod
    def backward(ctx, do):
        global launches_bwd
        q, k, v, o, l, m = ctx.saved_tensors
        layout = ctx.layout
        if do.dtype != q.dtype:
            raise TypeError(f"flash_attention: do has dtype {do.dtype}, expected {q.dtype}")
        if not _usable(do, layout):
            do = do.contiguous()
        dims = _LAYOUT_DIMS[layout]
        B, L, H, hd = q.shape[dims[0]], q.shape[dims[1]], q.shape[dims[2]], q.shape[3]
        KVH = k.shape[dims[2]]
        dev = q.device
        dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
        dk = torch.empty(k.shape, dtype=k.dtype, device=dev)
        dv = torch.empty(v.shape, dtype=v.dtype, device=dev)
        di, lse2 = torch.empty_like(l), torch.empty_like(l)
        parts = [None, None]
        if q.dtype == torch.bfloat16 and H > KVH:  # float32 partials of every query head, summed over the group
            parts = [torch.empty((B, H, L, hd), dtype=torch.float32, device=dev) for _ in range(2)]
        plan_q = _plan_tensor(B, H, L // BLOCK, True, dev)
        plan_k = _plan_tensor(B, H, L // BLOCK, False, dev)
        rc = kernels.library().flash_attn_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), l.data_ptr(), m.data_ptr(),
            di.data_ptr(), lse2.data_ptr(), *(p.data_ptr() if p is not None else None for p in parts),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), plan_q.data_ptr(), plan_k.data_ptr(), plan_q.shape[0],
            B, H, KVH, L, hd, _stride_array((q, k, v, o, do, dq, dk, dv), layout), ctx.sm_scale,
            _DTYPE_CODES[q.dtype], kernels.stream_ptr(q),
        )
        kernels.check(rc, "flash_attn_bwd")
        launches_bwd += 1
        return dq, dk, dv, None, None


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
    return _FlashAttention.apply(q, k, v, float(sm_scale), "bhld")


def flash_attention_gqa_plain(q, k, v, sm_scale: float = 1.0) -> torch.Tensor:
    """The plain version of :func:`flash_attention_gqa`, any device: K/V
    repeated to all heads, q and the output transposed, the upstream op's
    plain recurrence between (gradients of k, v summed over each group)."""
    group = q.shape[2] // k.shape[2]
    out = _FlashPlain.apply(q.transpose(1, 2), repeat_kv(k, group), repeat_kv(v, group), float(sm_scale))
    return out.transpose(1, 2)


def flash_attention_gqa(q, k, v, sm_scale: float = 1.0) -> torch.Tensor:
    """out [B, L, H, hd] = causal softmax(q kᵀ · sm_scale) v for q [B, L, H, hd]
    and k, v [B, L, KVH, hd] in the model's layout, H a multiple of KVH, query
    head h reading KV head h // (H // KVH) (``jnp.repeat``'s order), L a
    positive multiple of 128; differentiable in q, k and v (dk, dv at KVH
    heads, summed over each group). CUDA tensors go through the kernels, which
    read K/V at KVH heads and every tensor through its strides (no repeat, no
    transpose; hd 64 or 128, float32 or bfloat16). CPU tensors take
    :func:`flash_attention_gqa_plain`, which keeps the upstream op's rounding
    points."""
    global calls
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention_gqa: q must be [B, L, H, hd] and k, v [B, L, KVH, hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, L, H, hd = q.shape
    KVH = k.shape[2]
    if H % KVH:
        raise ValueError(f"flash_attention_gqa: {H} query heads are not a multiple of {KVH} KV heads")
    if L < BLOCK or L % BLOCK:
        raise ValueError(f"flash_attention_gqa: L={L} is not a positive multiple of {BLOCK}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_gqa: q, k and v must share a dtype")
    calls += 1
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_gqa_plain(q, k, v, sm_scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_gqa: unsupported device {dev}")
    return _FlashAttention.apply(q, k, v, float(sm_scale), "blhd")
