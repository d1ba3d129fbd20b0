"""CTC loss (the sum over alignments) and its gradient, on the card through
``csrc/ctc_loss.cu``.

Same topology as ``ops.ctc_viterbi``: states s = blank, l1, blank, l2, …,
blank (2L + 1); transitions s→s, s−1→s, and s−2→s when the labels differ.
In the JAX package ``align/ctc.py:ctc_loss`` is a ``lax.scan`` of
``logaddexp`` over frames and its gradient JAX's reverse-mode autodiff of
it: XLA code, not a Pallas kernel. As PyTorch operations that is about six
launches a frame each way, so on a CUDA tensor :func:`ctc_loss` launches the
hand-written kernels: one for the forward (alpha of every advanced frame
and the loss, on a cluster of blocks with no barrier a frame) and three for
the backward (the adjoint's multipliers from alpha across the grid, the
adjoint chain on a cluster, the per-(frame, label column) sums across the
grid), four a call in all. On a CPU tensor it runs the plain versions
(:func:`ctc_loss_forward_plain`, :func:`ctc_loss_backward_plain`), the same
recursions as PyTorch loops over frames. :func:`plan` gives the warps and
the row stride of the kernels' one layout (2 states a lane on a cluster of
4 blocks), and :func:`host_meta` builds the states' labels, skips and
label columns on the host; both are plain functions.

The gradient is JAX's, not PyTorch's: JAX's ``logaddexp``'s derivative is
exp(x − lae(x, y)) for each argument, so where both ends of the label
sequence sit at the NEG sentinel (an infeasible alignment) each takes a
weight of 1, where the α·β/Z form (and ``F.ctc_loss``) gives 0. The loss
keeps JAX's quirks too: ``label_len`` 0 adds α of the one end state to
itself (+log 2) and an infeasible alignment gives about 1e30, not inf.
``F.ctc_loss``'s gradient is exp(log_probs) − γ (it assumes a log-softmax
before it); this one is −γ, so the two agree only on the logits' gradient
through the log-softmax.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from .ctc_viterbi import NEG, expand_labels

# the kernels' layout (csrc/ctc_loss.cu kK, kCluster, kMaxWarps): 2 states a
# lane on a cluster of 4 blocks of up to 16 warps, the fastest of the layouts
# timed at S 413, 601 and 1,201 on an H100 (PERF.md)
STATES_PER_LANE, CLUSTER, MAX_WARPS = 2, 4, 16
STATES_PER_WARP = STATES_PER_LANE * 32 * CLUSTER  # the states one more warp a block adds: 256
MAX_STATES = MAX_WARPS * STATES_PER_WARP  # 4,096: 2L + 1 at most, 2,047 labels

launches = 0  # kernel launches, forward and backward (CUDA path only)


def _lae(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """JAX's ``logaddexp``: max(x, y) + log1p(exp(−|x − y|))."""
    d = x - y
    return torch.where(torch.isnan(d), x + y, torch.maximum(x, y) + torch.log1p(torch.exp(-d.abs())))


def _states(labels: torch.Tensor, blank: int):
    """(ext [S] int64, each state's label; skip [S] bool, state s may come
    from s − 2) on the labels' device."""
    ext = expand_labels(labels.long(), blank)
    s_idx = torch.arange(ext.shape[0], device=ext.device)
    skip = (s_idx >= 2) & (s_idx % 2 == 1) & (ext != torch.roll(ext, 2))
    return ext, skip


def _check(log_probs: torch.Tensor, labels: torch.Tensor, label_len: int) -> None:
    if log_probs.dim() != 2 or labels.dim() != 1:
        raise ValueError(f"ctc_loss: log_probs [T, V] and labels [L], got {tuple(log_probs.shape)} and {tuple(labels.shape)}")
    if log_probs.dtype != torch.float32:
        raise TypeError(f"ctc_loss: log_probs has dtype {log_probs.dtype}, expected torch.float32")
    if labels.shape[0] < 1:
        raise ValueError("ctc_loss: labels must hold at least one entry (label_len may be 0)")
    if not 0 <= int(label_len) <= labels.shape[0]:
        raise ValueError(f"ctc_loss: label_len {label_len} outside [0, {labels.shape[0]}]")
    if log_probs.shape[0] == 0:
        raise ValueError("ctc_loss: no frames")


def _frames(T: int, input_len: int) -> int:
    """Frames the recursion advances through: frames from input_len on are
    frozen (the JAX scan's mask), and frame 0 always counts."""
    return min(max(int(input_len), 1), T)


def ctc_loss_forward_plain(emit: torch.Tensor, skip: torch.Tensor, input_len: int, label_len: int):
    """emit [T, S] float32 (each frame's log-prob of each state's label), skip
    [S] bool → (alpha [Tv, S] float32, each advanced frame's forward
    variables; loss float32 0-d tensor)."""
    T, S = emit.shape
    neg = torch.tensor(NEG, dtype=torch.float32, device=emit.device)
    s_idx = torch.arange(S, device=emit.device)
    valid = s_idx < 2 * int(label_len) + 1
    alpha = torch.where(valid & (s_idx < 2), emit[0], neg)
    rows = [alpha]
    for t in range(1, _frames(T, input_len)):
        from1 = torch.cat([neg[None], alpha[:-1]])
        from2 = torch.where(skip, torch.cat([neg.expand(2), alpha[:-2]]), neg)
        alpha = torch.where(valid, _lae(_lae(alpha, from1), from2) + emit[t], neg)
        rows.append(alpha)
    endA = 2 * int(label_len)
    endB = max(endA - 1, 0)
    return torch.stack(rows), -_lae(alpha[endA], alpha[endB])


def ctc_loss_backward_plain(alpha: torch.Tensor, ext: torch.Tensor, skip: torch.Tensor, T: int, V: int,
                            label_len: int, grad_out: torch.Tensor) -> torch.Tensor:
    """The adjoint of :func:`ctc_loss_forward_plain`: alpha [Tv, S] (its
    output), ext [S], skip [S], the frames T and classes V of log_probs →
    d loss / d log_probs [T, V] float32 times ``grad_out``, with the weights
    JAX's autodiff takes (exp(x − lae(x, y)) for each argument of each
    logaddexp). Frames from Tv on get 0."""
    Tv, S = alpha.shape
    dev = alpha.device
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    s_idx = torch.arange(S, device=dev)
    valid = s_idx < 2 * int(label_len) + 1
    endA = 2 * int(label_len)
    endB = max(endA - 1, 0)
    aA, aB = alpha[-1, endA], alpha[-1, endB]
    out = _lae(aA, aB)
    ct = -grad_out.to(torch.float32)
    g = torch.zeros(S, dtype=torch.float32, device=dev)
    g[endA] = g[endA] + ct * torch.exp(aA - out)
    g[endB] = g[endB] + ct * torch.exp(aB - out)
    de = torch.zeros((T, S), dtype=torch.float32, device=dev)
    for t in range(Tv - 1, 0, -1):
        a = alpha[t - 1]
        f1 = torch.cat([neg[None], a[:-1]])
        f2 = torch.where(skip, torch.cat([neg.expand(2), a[:-2]]), neg)
        la1 = _lae(a, f1)
        la2 = _lae(la1, f2)
        dla2 = torch.where(valid, g, zero)
        de[t] = dla2
        dla1 = dla2 * torch.exp(la1 - la2)
        d2 = torch.where(skip, dla2 * torch.exp(f2 - la2), zero)
        d1 = dla1 * torch.exp(f1 - la1)
        g = dla1 * torch.exp(a - la1) + torch.cat([d1[1:], zero[None]]) + torch.cat([d2[2:], zero.expand(2)])
    de[0] = torch.where(valid & (s_idx < 2), g, zero)
    return torch.zeros((T, V), dtype=torch.float32, device=dev).index_add_(1, ext.to(dev), de)


class _PlainLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, ext, skip, input_len: int, label_len: int):
        alpha, loss = ctc_loss_forward_plain(log_probs[:, ext], skip, input_len, label_len)
        ctx.save_for_backward(alpha, ext, skip)
        ctx.shape, ctx.label_len = tuple(log_probs.shape), label_len
        return loss

    @staticmethod
    def backward(ctx, grad_out):
        alpha, ext, skip = ctx.saved_tensors
        T, V = ctx.shape
        return ctc_loss_backward_plain(alpha, ext, skip, T, V, ctx.label_len, grad_out), None, None, None, None


class Plan(NamedTuple):
    """How both chains lay out S states: the warps W of each of the
    cluster's blocks, and the row stride of alpha, the weight planes and d e
    (W · 256, a multiple of 64)."""

    S: int
    warps: int
    stride: int


def plan(S: int) -> Plan:
    """The kernels' layout of S states (1 <= S <= ``MAX_STATES``): lane l of
    warp w of block b holds states ((b W + w) 32 + l) 2 and the one after,
    with W = ceil(S / 256), the fewest warps a block that hold S."""
    if not 1 <= S <= MAX_STATES:
        raise ValueError(f"ctc_loss: {S} states outside [1, {MAX_STATES}]")
    warps = -(-S // STATES_PER_WARP)
    return Plan(S, warps, warps * STATES_PER_WARP)


def host_meta(labels, blank: int, V: int) -> np.ndarray:
    """labels [L] → int32 [ext (S), skip (S), col_ptr (V + 1), col_states
    (S)] on the host: each state's label, whether it may come from s − 2, and
    the states of each label column in state order (the backward's column
    sums). Raises if a label or the blank lies outside [0, V)."""
    lab = np.asarray(labels, dtype=np.int64).reshape(-1)
    S = 2 * lab.size + 1
    ext = np.full(S, blank, np.int64)
    ext[1::2] = lab
    if ext.min() < 0 or ext.max() >= V:
        raise ValueError(f"ctc_loss: a label lies outside [0, {V})")
    skip = np.zeros(S, np.int64)
    skip[3::2] = lab[1:] != lab[:-1]
    col_ptr = np.zeros(V + 1, np.int64)
    np.cumsum(np.bincount(ext, minlength=V), out=col_ptr[1:])
    col_states = np.argsort(ext, kind="stable")
    return np.concatenate([ext, skip, col_ptr, col_states]).astype(np.int32)


class _KernelLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, meta, T: int, V: int, Tv: int, label_len: int, pl: Plan):
        global launches
        lib = kernels.library()
        S, Sp = pl.S, pl.stride
        alpha = torch.empty((Tv, Sp), dtype=torch.float32, device=log_probs.device)
        loss = torch.empty((), dtype=torch.float32, device=log_probs.device)
        rc = lib.ctc_loss_fwd_launch(log_probs.data_ptr(), meta.data_ptr(), meta[S:].data_ptr(), alpha.data_ptr(),
                                     loss.data_ptr(), T, S, V, Tv, label_len, pl.warps, Sp,
                                     kernels.stream_ptr(log_probs))
        kernels.check(rc, "ctc_loss_fwd")
        launches += 1
        ctx.save_for_backward(alpha, meta)
        ctx.dims = (T, V, Tv, label_len, pl)
        return loss

    @staticmethod
    def backward(ctx, grad_out):
        global launches
        alpha, meta = ctx.saved_tensors
        T, V, Tv, label_len, pl = ctx.dims
        lib = kernels.library()
        dev, S, Sp = alpha.device, pl.S, pl.stride
        stream = kernels.stream_ptr(alpha)
        go = grad_out.to(torch.float32).contiguous()
        skip_d, col_ptr, col_states = meta[S:], meta[2 * S:], meta[2 * S + V + 1:]
        planes = torch.empty((max(Tv - 1, 1), 4, Sp), dtype=torch.float32, device=dev)  # w12, w2, w1, wa
        kernels.check(lib.ctc_loss_weights_launch(alpha.data_ptr(), skip_d.data_ptr(), planes.data_ptr(), S, Tv, Sp,
                                                  stream), "ctc_loss_weights")
        de = torch.empty((Tv, Sp), dtype=torch.float32, device=dev)  # each frame's state adjoints
        kernels.check(lib.ctc_loss_chain_launch(planes.data_ptr(), alpha.data_ptr(), skip_d.data_ptr(), go.data_ptr(),
                                                de.data_ptr(), S, Tv, label_len, pl.warps, Sp, stream),
                      "ctc_loss_chain")
        dlogp = torch.empty((T, V), dtype=torch.float32, device=dev)
        kernels.check(lib.ctc_loss_columns_launch(de.data_ptr(), col_ptr.data_ptr(), col_states.data_ptr(),
                                                  dlogp.data_ptr(), T, V, Tv, Sp, stream), "ctc_loss_columns")
        launches += 3
        return dlogp, None, None, None, None, None, None


def ctc_loss_plain(log_probs: torch.Tensor, labels: torch.Tensor, input_len: int, label_len: int, blank: int = 0):
    """The plain version of :func:`ctc_loss` on any device (the loops of
    :func:`ctc_loss_forward_plain` and :func:`ctc_loss_backward_plain` under
    a ``torch.autograd.Function``)."""
    _check(log_probs, labels, label_len)
    ext, skip = _states(labels.to(log_probs.device), blank)
    return _PlainLoss.apply(log_probs, ext, skip, int(input_len), int(label_len))


def ctc_loss(log_probs: torch.Tensor, labels, input_len: int, label_len: int, blank: int = 0) -> torch.Tensor:
    """Sum-product CTC negative log likelihood of one sequence: log_probs
    [T, V] float32 (the frames' log-softmax), labels [L] int (L >= 1; on the
    card pass them on the host: they are read there), input_len / label_len
    the valid lengths → scalar loss, differentiable with respect to
    log_probs. A CUDA tensor goes through the kernels of
    ``csrc/ctc_loss.cu`` (one launch forward, three backward), a CPU tensor
    through the plain version. More than ``MAX_STATES`` states raises."""
    labels = torch.as_tensor(labels)
    if log_probs.device.type == "cpu":
        return ctc_loss_plain(log_probs, labels, input_len, label_len, blank)
    if log_probs.device.type != "cuda":
        raise ValueError(f"ctc_loss: unsupported device {log_probs.device}")
    _check(log_probs, labels, label_len)
    T, V = log_probs.shape
    S = 2 * labels.shape[0] + 1
    if S > MAX_STATES:
        raise ValueError(f"ctc_loss: {S} states (2L + 1) exceed the kernel's {MAX_STATES}: at most "
                         f"{(MAX_STATES - 1) // 2} labels a sequence")
    pl = plan(S)
    if T * max(V, 4 * pl.stride) >= 2**31:
        raise ValueError(f"ctc_loss: [T, V] {(T, V)} with {S} states not taken")
    meta = torch.from_numpy(host_meta(labels.detach().cpu().numpy(), blank, V)).to(log_probs.device)
    return _KernelLoss.apply(log_probs.contiguous(), meta, T, V, _frames(T, input_len), int(label_len), pl)
