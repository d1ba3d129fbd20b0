"""Fused LM-head + cross-entropy: the ``[N, V]`` logits never reach device memory.

Counterpart of the TPU kernel ``ops/fused_ce.py:linear_ce_rows`` of the JAX
package: the loss of the LoRA training step
(``models.llm.causal_lm_loss_fused``). On CUDA tensors :func:`linear_ce_rows`
launches the hand-written kernels of ``csrc/fused_ce.cu`` behind a
``torch.autograd.Function``: the forward walks the vocabulary in splits of
column tiles with an online logsumexp and combines the splits' partial
(max, sum, target logit) in a second small kernel; the backward walks it in
chunks, recomputes each chunk's logits into a ``[N, chunk]`` coefficient
scratch and adds ``coef · W_chunkᵀ`` into ``dh``. In bfloat16 the products
are ``wgmma`` tiles fed by TMA through an ``mbarrier`` ring (128 × 256
forward and coefficient tiles, 128 × :func:`dh_cols` dh tiles, one block per
SM); in float32 they run on the CUDA cores (128 × 128 tiles). The bfloat16
kernels are bound by their ``wgmma`` mainloop: about 82 % of the bf16 peak
forward and 66–70 % backward at the 7B shape on an H100 (PERF.md, section
6). The grid plans are the Python functions below (:func:`split_plan`,
:func:`chunk_plan`, :func:`dh_cols`), checked on the CPU. It gives ``dh``
only: the head is frozen in the LoRA step, and a ``W`` that asks for a
gradient raises. On CPU tensors it runs :func:`linear_ce_rows_plain`,
differentiated by autograd. Kernel and plain version agree to a tolerance, not to bits (sum
order, ``exp``; in bfloat16 the kernel rounds the backward's coefficients
to ``W``'s type as the TPU kernel does, autograd of the plain version does
not).
"""

from __future__ import annotations

import functools

import torch

from . import kernels

BLOCK_V = 512  # the vocabulary must be a multiple (the TPU kernel's vocab tile)
ROWS = 128  # rows of a CUDA block's output tile (both types)
TILE = 128  # float32: columns of a logits tile and of a dh tile
TILE_BF16 = 256  # bfloat16: columns of a forward / coefficient tile
DH_COLS_BF16 = (224, 128)  # bfloat16: the dh tile widths the kernel has
BWD_CHUNK = 8192  # float32: vocabulary columns per backward chunk
SCRATCH_L2_BYTES = 36 << 20  # bfloat16: the coefficient scratch stays well inside the 50 MB L2
# SMs of an H100 SXM; the wrapper asks the card. Every plan counts one block
# per SM: the bfloat16 kernels take 197,696 bytes of shared memory, the
# float32 forward 145 registers a thread (two blocks of 256 threads would
# need more than the SM's 65,536); chip_smoke.py's ptxas line prints both
SMS = 132
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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=64)
def split_plan(n: int, v: int, tile: int, slots: int) -> tuple[int, int]:
    """(splits, tiles_per_split) of the forward's grid (splits × row tiles):
    the V / ``tile`` column tiles dealt to splits so that the critical path,
    waves of ``slots`` resident blocks (one per SM) times tiles per block, is shortest;
    the fewest blocks among equals. A whole number of waves where the shapes
    allow it: at N 2,044, V 152,064 in bfloat16, 33 splits of 18 tiles × 16
    row tiles = 528 blocks, 4 waves of 132."""
    tiles = v // tile
    row_tiles = _cdiv(n, ROWS)
    best = None
    for want in range(1, tiles + 1):
        per = _cdiv(tiles, want)
        splits = _cdiv(tiles, per)
        if splits != want:  # the same deal as a smaller count
            continue
        cost = _cdiv(splits * row_tiles, slots) * per
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


@functools.lru_cache(maxsize=64)
def dh_cols(n: int, d: int, sms: int) -> int:
    """Columns of a bfloat16 dh tile: of the widths the kernel has that divide
    D, the one whose grid (D / cols × row tiles, one block per SM) ends
    soonest, waves times width; the widest among equals. 224 at the 7B and
    bench shapes (D 3,584 and 896): 97 % of its waves' slots filled, where 128
    fills 85 %."""
    row_tiles = _cdiv(n, ROWS)
    best = None
    for cols in DH_COLS_BF16:
        if d % cols:
            continue
        cost = _cdiv(d // cols * row_tiles, sms) * cols
        if best is None or cost < best[0]:
            best = (cost, cols)
    return best[1]


@functools.lru_cache(maxsize=64)
def chunk_plan(n: int, v: int, sms: int) -> int:
    """Vocabulary columns per bfloat16 backward chunk: a multiple of the
    256-column tile whose ``[N, chunk]`` bf16 scratch fits
    ``SCRATCH_L2_BYTES``, chosen so that the coefficient kernels' waves
    (chunk tiles × row tiles, one block per SM) are fewest over the whole
    vocabulary; the fewest chunks among equals. At N 2,044, V 152,064: 18
    chunks of 8,448 columns, each 528 blocks = 4 waves. (The dh kernels'
    work does not depend on the chunking.)"""
    tiles = v // TILE_BF16
    row_tiles = _cdiv(n, ROWS)
    most = max(1, min(tiles, SCRATCH_L2_BYTES // (n * 2 * TILE_BF16)))
    best = None
    for per in range(1, most + 1):
        full, rest = divmod(tiles, per)
        waves = full * _cdiv(per * row_tiles, sms) + (_cdiv(rest * row_tiles, sms) if rest else 0)
        key = (waves, _cdiv(tiles, per))
        if best is None or key < best[0]:
            best = (key, per)
    return best[1] * TILE_BF16


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


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
        bf16 = h.dtype == torch.bfloat16
        splits, per = split_plan(n, v, TILE_BF16 if bf16 else TILE, _sms(dev))
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
        if h.dtype == torch.bfloat16:
            sms = _sms(h.device)
            chunk, cols = chunk_plan(n, v, sms), dh_cols(n, d, sms)
        else:
            chunk, cols = min(BWD_CHUNK, v), TILE
        coef = torch.empty((n, chunk), dtype=w.dtype, device=h.device)
        dh = torch.empty((n, d), dtype=torch.float32, device=h.device)
        rc = kernels.library().fused_ce_bwd_launch(
            h.data_ptr(), w.data_ptr(), tgt.data_ptr(), lse.data_ptr(), g.data_ptr(), coef.data_ptr(), dh.data_ptr(),
            n, d, v, chunk, cols, _DTYPE_CODES[h.dtype], kernels.stream_ptr(h),
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
