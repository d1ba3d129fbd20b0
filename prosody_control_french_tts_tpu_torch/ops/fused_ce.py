"""Fused LM-head + cross-entropy: the ``[N, V]`` logits never reach device memory.

Counterpart of the TPU kernel ``ops/fused_ce.py:linear_ce_rows`` of the JAX
package: the loss of the LoRA training step
(``models.llm.causal_lm_loss_fused``). On CUDA tensors :func:`linear_ce_rows`
launches the hand-written kernels of ``csrc/fused_ce.cu`` behind a
``torch.autograd.Function``: the forward walks the vocabulary in splits of
128-column tiles with an online logsumexp and combines the splits' partial
(max, sum, target logit) in a second small kernel; the backward walks it in
chunks, recomputes each chunk's logits into a ``[N, chunk]`` coefficient
scratch and adds ``coef · W_chunkᵀ`` into ``dh``. It gives ``dh`` only: the
head is frozen in the LoRA step, and a ``W`` that asks for a gradient raises.
On CPU tensors it runs :func:`linear_ce_rows_plain`, differentiated by
autograd. Kernel and plain version agree to a tolerance, not to bits (sum
order, ``expf``; in bfloat16 the kernel rounds the backward's coefficients
to ``W``'s type as the TPU kernel does, autograd of the plain version does
not).
"""

from __future__ import annotations

import torch

from . import kernels

BLOCK_V = 512  # the vocabulary must be a multiple (the TPU kernel's vocab tile)
TILE = 128  # rows and columns of a CUDA block's logits tile
BWD_CHUNK = 8192  # vocabulary columns per backward chunk: the scratch stays in L2
_TARGET_BLOCKS = 264  # forward grid size aimed at: two blocks for each of 132 SMs
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # forward launches (CUDA path only; the sweep and its combine)
launches_bwd = 0  # backward launches (CUDA path only; one per backward, all chunks)


def linear_ce_supported(d: int, v: int) -> bool:
    return d % 128 == 0 and v % BLOCK_V == 0


def linear_ce_rows_plain(h, w, tgt) -> torch.Tensor:
    """Per-row NLL [N] float32 of targets under softmax(h @ W) in plain
    PyTorch: float32 sums of float32-upcast operands, logsumexp minus the
    target's logit. Differentiable by autograd (in h)."""
    logits = h.float() @ w.float()
    picked = torch.gather(logits, 1, tgt.long()[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - picked


def split_plan(n: int, v: int) -> tuple[int, int]:
    """(splits, tiles_per_split) of the forward's grid: the V / 128 column
    tiles dealt to enough splits that row tiles × splits fills the card."""
    tiles = v // TILE
    row_tiles = -(-n // TILE)
    want = max(1, min(tiles, -(-_TARGET_BLOCKS // row_tiles)))
    per = -(-tiles // want)
    return -(-tiles // per), per


class _LinearCE(torch.autograd.Function):
    """The CUDA path: forward and backward are launches of ``csrc/fused_ce.cu``."""

    @staticmethod
    def forward(ctx, h, w, tgt):
        global launches
        dev = h.device
        n, d = h.shape
        v = w.shape[1]
        h, w = h.contiguous(), w.contiguous()
        tgt = tgt.to(torch.int32).contiguous()
        kernels.require(h, "h", h.dtype, 2, dev)
        kernels.require(w, "w", h.dtype, 2, dev)
        kernels.require(tgt, "tgt", torch.int32, 1, dev)
        if h.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError("linear_ce_rows: h and w must be 16-byte aligned")
        splits, per = split_plan(n, v)
        nll = torch.empty((n,), dtype=torch.float32, device=dev)
        lse = torch.empty((n,), dtype=torch.float32, device=dev)
        partials = torch.empty((3, splits, n), dtype=torch.float32, device=dev)
        rc = kernels.library().fused_ce_fwd_launch(
            h.data_ptr(), w.data_ptr(), tgt.data_ptr(), nll.data_ptr(), lse.data_ptr(), partials.data_ptr(),
            n, d, v, splits, per, _DTYPE_CODES[h.dtype], kernels.stream_ptr(h),
        )
        kernels.check(rc, "fused_ce_fwd")
        launches += 1
        ctx.save_for_backward(h, w, tgt, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        global launches_bwd
        h, w, tgt, lse = ctx.saved_tensors
        n, d = h.shape
        v = w.shape[1]
        g = g.to(torch.float32).contiguous()
        chunk = min(BWD_CHUNK, v)
        coef = torch.empty((n, chunk), dtype=w.dtype, device=h.device)
        dh = torch.empty((n, d), dtype=torch.float32, device=h.device)
        rc = kernels.library().fused_ce_bwd_launch(
            h.data_ptr(), w.data_ptr(), tgt.data_ptr(), lse.data_ptr(), g.data_ptr(), coef.data_ptr(), dh.data_ptr(),
            n, d, v, chunk, _DTYPE_CODES[h.dtype], kernels.stream_ptr(h),
        )
        kernels.check(rc, "fused_ce_bwd")
        launches_bwd += 1
        return dh.to(h.dtype), None, None


def linear_ce_rows(h, w, tgt) -> torch.Tensor:
    """Kernel H. Per-token NLL [N] float32 of targets under softmax(h @ W),
    fused: h [N, D] and w [D, V] float32 or bfloat16 (the same), tgt [N]
    integer. Requires ``linear_ce_supported(D, V)``; any N ≥ 1 (ragged row
    tiles are guarded in the kernel, nothing is padded in device memory).
    Differentiable in h only: a ``w`` that requires a gradient raises. CUDA
    tensors go through the CUDA kernels, CPU tensors through the plain
    version."""
    if h.dim() != 2 or w.dim() != 2 or tgt.dim() != 1 or w.shape[0] != h.shape[1] or tgt.shape[0] != h.shape[0]:
        raise ValueError(f"linear_ce_rows: h {tuple(h.shape)}, w {tuple(w.shape)}, tgt {tuple(tgt.shape)} do not fit")
    if not linear_ce_supported(h.shape[1], w.shape[1]):
        raise ValueError(f"linear_ce_rows: D={h.shape[1]} must be a multiple of 128 and V={w.shape[1]} of {BLOCK_V}")
    if h.shape[0] < 1:
        raise ValueError("linear_ce_rows: no rows")
    if w.requires_grad:
        raise ValueError("linear_ce_rows computes no dW: the head must be frozen (use the dense loss to train it)")
    dev = h.device
    if dev.type == "cpu":
        return linear_ce_rows_plain(h, w, tgt)
    if dev.type != "cuda":
        raise ValueError(f"linear_ce_rows: unsupported device {dev}")
    if h.dtype not in _DTYPE_CODES:
        raise TypeError(f"linear_ce_rows: dtype {h.dtype} is not float32 or bfloat16")
    if w.dtype != h.dtype:
        raise TypeError(f"linear_ce_rows: w is {w.dtype}, h is {h.dtype}")
    return _LinearCE.apply(h, w, tgt)
