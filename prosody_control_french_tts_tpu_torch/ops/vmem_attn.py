"""Causal grouped-query attention for short training sequences, with a
backward that recomputes the probabilities.

Counterpart of the TPU kernel ``ops/vmem_attn.py:causal_attention_vmem`` of
the JAX package: the attention of the LoRA training step
(``models.llm.Attention`` with ``attn_impl="vmem"``). On CUDA tensors
:func:`causal_attention_vmem` launches the hand-written kernels of
``csrc/vmem_attn.cu`` behind a ``torch.autograd.Function``, chosen by dtype:

- bfloat16 (the training path): tensor-core kernels (``mma.sync`` bf16 tiles
  with float32 accumulation, K/V tiles staged by ``cp.async`` in two
  buffers). Forward: one block per batch row, query head and tile of 64
  query rows, online softmax, scores in registers. Backward: a dq kernel
  that also takes ``delta = rowsum(dO * O)`` from the saved output, a dk/dv
  kernel whose blocks follow :func:`dkv_plan` (pairs of key tiles per query
  head) into float32 partials, and a kernel that sums the group's partials in
  head order. No atomics: two backward runs give the same bits.
- float32: the CUDA-core kernels (whole score rows in shared memory, the TPU
  kernel's softmax); tensor cores would take float32 through TF32.

On CPU tensors it runs :func:`causal_attention_vmem_plain`, the same function
in plain PyTorch with the kernel's rounding points, differentiated by
autograd. Kernel and plain version agree to a tolerance, not to bits: the
order of the float32 sums and ``exp`` differ; in bfloat16 the kernel's
backward rounds ``ds`` and ``p`` to the operand type before its products as
the TPU kernel does, which autograd of the plain version does not, and the
bf16 forward rounds ``p`` against the running row max of the online softmax.

Layouts are the caller's: q ``[B, L, H, hd]``, k/v ``[B, L, KVH, hd]``.
"""

from __future__ import annotations

import torch

from . import kernels

# the float32 forward keeps a [32, L] float32 score tile in shared memory
# and its backward two of them; callers take the masked dot path above this
MAX_L = 512
HEAD_DIMS = (64, 128)  # the kernels are instantiated for these
TILE = 32  # L must be a multiple (the float32 kernels' tile)
BF16_TILE = 64  # query rows and keys per tile of the bfloat16 kernels (a ragged last tile is masked)
_NEG = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

calls = 0  # wrapper calls, any device (the dispatch tests read it)
launches = 0  # forward kernel launches (CUDA path only)
launches_bwd = 0  # backward calls (CUDA path only; one per backward, whatever its number of kernels)

_PLANS: dict = {}  # (L, H, device) -> the dk/dv work plan on that device


def dkv_plan(L: int, H: int) -> torch.Tensor:
    """The bfloat16 dk/dv kernel's work plan: int32 ``[P, 3]``, one row per
    block (of each batch row), ``(query head, key tile a, key tile b or -1)``
    in tiles of :data:`BF16_TILE` keys. Key tile j has the query tiles
    j .. n-1 at or below the diagonal (n - j of them), so the pair
    {j, n-1-j} always walks n + 1; with n odd the middle tile is a block of
    its own, placed last. Every (head, key tile, query tile ≥ key tile) is
    covered by exactly one block."""
    n = -(-L // BF16_TILE)
    pairs = [(j, n - 1 - j) for j in range(n // 2)]
    if n % 2:
        pairs.append((n // 2, -1))
    return torch.tensor([(h, a, b) for a, b in pairs for h in range(H)], dtype=torch.int32)


def _device_plan(L: int, H: int, dev) -> torch.Tensor:
    key = (L, H, dev)
    if key not in _PLANS:
        _PLANS[key] = dkv_plan(L, H).to(dev)
    return _PLANS[key]


def causal_attention_vmem_plain(q, k, v, sm_scale: float) -> torch.Tensor:
    """out [B, L, H, hd] = causal softmax(q kᵀ · scale) v in plain PyTorch.

    Scores are float32 sums of float32-upcast operands, masked with −1e30
    above the diagonal; ``p = exp(s − max)`` is rounded to v's dtype for the
    second product, whose float32 result is divided by the (unrounded) row
    sum and cast to q's dtype. Differentiable by autograd."""
    B, L, H, hd = q.shape
    KVH = k.shape[2]
    group = H // KVH
    qg = q.reshape(B, L, KVH, group, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * sm_scale
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    s = s.masked_fill(~causal, _NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)  # [B, KVH, group, L]
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, L, H, hd).to(q.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("causal_attention_vmem: q must be [B, L, H, hd] and k, v [B, L, KVH, hd]")
    B, L, H, hd = q.shape
    KVH = k.shape[2]
    if k.shape[0] != B or k.shape[1] != L or k.shape[3] != hd or KVH < 1 or H % KVH:
        raise ValueError(f"causal_attention_vmem: q {tuple(q.shape)} and k {tuple(k.shape)} do not fit")
    if L > MAX_L:
        raise ValueError(f"causal_attention_vmem: L={L} exceeds MAX_L={MAX_L}")


class _VmemAttention(torch.autograd.Function):
    """The CUDA path: forward and backward are launches of ``csrc/vmem_attn.cu``."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        global launches
        dev = q.device
        if q.dtype not in _DTYPE_CODES:
            raise TypeError(f"causal_attention_vmem: dtype {q.dtype} is not float32 or bfloat16")
        B, L, H, hd = q.shape
        KVH = k.shape[2]
        if hd not in HEAD_DIMS:
            raise ValueError(f"causal_attention_vmem: head dim {hd} not in {HEAD_DIMS}")
        if L % TILE:
            raise ValueError(f"causal_attention_vmem: L={L} is not a multiple of {TILE}")
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        for name, t in (("q", q), ("k", k), ("v", v)):
            kernels.require(t, name, q.dtype, 4, dev)
            if t.data_ptr() % 16:
                raise ValueError(f"causal_attention_vmem: {name} is not 16-byte aligned")
        out = torch.empty_like(q)
        lse = torch.empty((B, H, L), dtype=torch.float32, device=dev)
        rc = kernels.library().vmem_attn_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, L, H, KVH, hd, float(sm_scale), _DTYPE_CODES[q.dtype], kernels.stream_ptr(q),
        )
        kernels.check(rc, "vmem_attn_fwd")
        launches += 1
        ctx.save_for_backward(q, k, v, out, lse)  # the bf16 backward takes delta from out
        ctx.sm_scale = float(sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        global launches_bwd
        q, k, v, out, lse = ctx.saved_tensors
        B, L, H, hd = q.shape
        KVH = k.shape[2]
        dout = dout.contiguous()  # it arrives as a view of the caller's reshape
        kernels.require(dout, "dout", q.dtype, 4, q.device)
        if dout.shape != q.shape or dout.data_ptr() % 16:
            raise ValueError("causal_attention_vmem: the output gradient does not fit q")
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty_like(lse)
        stream = kernels.stream_ptr(q)
        if q.dtype == torch.bfloat16:
            plan = _device_plan(L, H, q.device)
            dk_part = torch.empty((B, L, H, hd), dtype=torch.float32, device=q.device)
            dv_part = torch.empty_like(dk_part)
            rc = kernels.library().vmem_attn_bwd_bf16_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), plan.data_ptr(), plan.shape[0], dk_part.data_ptr(), dv_part.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, L, H, KVH, hd, ctx.sm_scale, stream,
            )
        else:
            rc = kernels.library().vmem_attn_bwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, L, H, KVH, hd, ctx.sm_scale, stream,
            )
        kernels.check(rc, "vmem_attn_bwd")
        launches_bwd += 1
        return dq, dk, dv, None


def causal_attention_vmem(q, k, v, sm_scale: float) -> torch.Tensor:
    """Kernel G. out [B, L, H, hd] = causal softmax(q kᵀ · scale) v for
    q [B, L, H, hd], k/v [B, L, KVH, hd] with H % KVH == 0 and L ≤ MAX_L;
    differentiable in q, k and v. CUDA tensors go through the CUDA kernels
    (L a multiple of 32, hd 64 or 128; bfloat16 on the tensor cores, float32
    on the CUDA cores), CPU tensors through the plain version."""
    global calls
    _check(q, k, v)
    calls += 1
    dev = q.device
    if dev.type == "cpu":
        return causal_attention_vmem_plain(q, k, v, sm_scale)
    if dev.type != "cuda":
        raise ValueError(f"causal_attention_vmem: unsupported device {dev}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("causal_attention_vmem: q, k and v must share a dtype")
    return _VmemAttention.apply(q, k, v, sm_scale)
