"""CTC forced alignment: the Viterbi over the blank-interleaved label
sequence, on the card through ``csrc/ctc_viterbi.cu``.

Standard CTC topology: states s = blank, l1, blank, l2, …, blank (2L + 1);
transitions s→s, s−1→s, and s−2→s when the labels differ (no skip over a
repeated label). In the JAX package ``align/ctc.py:ctc_forced_align`` is a
``lax.scan`` over frames and one back over them, XLA code and not a Pallas
kernel; as PyTorch operations that is about 8 launches a frame, so on a CUDA
tensor :func:`ctc_forced_align` launches the hand-written kernel, forward
and backtrack in one launch. On a CPU tensor it runs
:func:`ctc_forced_align_plain`, the same recurrence as a PyTorch loop over
frames. Both keep the JAX rounding and tie rule: the state is the max of
stay, s−1 and s−2 (the first of equal candidates winning, in that order)
plus the frame's emission, one float32 add, so they agree bit for bit.

The log-softmax and the blank bias are plain tensor operations before the
Viterbi. The plain version gathers each state's emission
(``log_probs[:, ext]``, [T, S]); the kernel reads the frames' [T, V]
log-probabilities and gathers on the chip, so the card path builds no
[T, S] tensor. The labels, the states' labels and skips and the lengths
are checked on the host and uploaded in one copy.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels

NEG = -1e30
MAX_STATES = 16383  # 2L + 1 at most: 8,191 labels (8 states a thread, 8 blocks of 256 threads)

launches = 0  # kernel launches (CUDA path only)


def expand_labels(labels: torch.Tensor, blank: int) -> torch.Tensor:
    """[L] → [2L+1] blank-interleaved."""
    ext = torch.full((2 * labels.shape[-1] + 1,), blank, dtype=labels.dtype, device=labels.device)
    ext[1::2] = labels
    return ext


def _states(labels: torch.Tensor, blank: int):
    """(ext [S] int64, the states' labels; skip [S] bool, whether state s
    may come from s − 2) on the labels' device."""
    ext = expand_labels(labels.long(), blank)
    s_idx = torch.arange(ext.shape[0], device=ext.device)
    skip = (s_idx >= 2) & (s_idx % 2 == 1) & (ext != torch.roll(ext, 2))
    return ext, skip


def _check_inputs(log_probs: torch.Tensor, labels: torch.Tensor, label_len: int) -> None:
    if log_probs.dim() != 2 or labels.dim() != 1:
        raise ValueError(f"ctc_forced_align: log_probs [T, V] and labels [L], got {tuple(log_probs.shape)} and {tuple(labels.shape)}")
    if log_probs.dtype != torch.float32:
        raise TypeError(f"ctc_forced_align: log_probs has dtype {log_probs.dtype}, expected torch.float32")
    if not 0 <= int(label_len) <= labels.shape[0]:
        raise ValueError(f"ctc_forced_align: label_len {label_len} outside [0, {labels.shape[0]}]")
    if log_probs.shape[0] == 0:
        raise ValueError("ctc_forced_align: no frames")


def _prepare(log_probs: torch.Tensor, labels: torch.Tensor, blank: int):
    """(emissions [T, S] float32, skip [S] bool) of one sequence."""
    ext, skip = _states(labels.to(log_probs.device), blank)
    return log_probs[:, ext].contiguous(), skip


def ctc_viterbi_plain(emit: torch.Tensor, skip: torch.Tensor, input_len: int, label_len: int):
    """emit [T, S] float32, skip [S] bool → (states [T] int32, score float32
    0-d tensor): the recurrence of ``csrc/ctc_viterbi.cu`` frame by frame."""
    T, S = emit.shape
    dev = emit.device
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    s_idx = torch.arange(S, device=dev)
    valid_state = s_idx < 2 * label_len + 1
    alpha = torch.where(s_idx < 2, emit[0], neg)
    alpha = torch.where(valid_state, alpha, neg)
    Tv = min(max(int(input_len), 1), T)
    backs = []
    for t in range(1, Tv):
        stay = alpha
        from1 = torch.cat([neg[None], alpha[:-1]])
        from2 = torch.where(skip, torch.cat([neg.expand(2), alpha[:-2]])[:S], neg)
        take1 = from1 > stay
        m = torch.where(take1, from1, stay)
        best = take1.to(torch.int8)
        take2 = from2 > m
        m = torch.where(take2, from2, m)
        best = torch.where(take2, 2, best).to(torch.int8)
        alpha = torch.where(valid_state, m + emit[t], neg)
        backs.append(best)
    endA = 2 * int(label_len)
    endB = max(endA - 1, 0)
    score_a, score_b = alpha[endA], alpha[endB]
    a_wins = bool(score_a >= score_b)
    last = endA if a_wins else endB
    score = score_a if a_wins else score_b
    states = np.full(T, last, np.int32)
    back = torch.stack(backs).cpu().numpy() if backs else np.zeros((0, S), np.int8)
    s = last
    for t in range(Tv - 2, -1, -1):
        s -= int(back[t, s])
        states[t] = s
    return torch.from_numpy(states).to(dev), score


def ctc_forced_align_plain(log_probs: torch.Tensor, labels: torch.Tensor, input_len: int, label_len: int, blank: int = 0):
    """Viterbi alignment in plain PyTorch. log_probs [T, V] float32 frame
    log-softmax; labels [L] int; input_len / label_len the valid lengths
    (padding supported). Returns (frame_states [T] int32, an index into the
    expanded sequence; score float32 0-d tensor). Frame → label index =
    state // 2 when the state is odd, else blank; frames past input_len keep
    the final state."""
    _check_inputs(log_probs, labels, label_len)
    emit, skip = _prepare(log_probs, labels, blank)
    return ctc_viterbi_plain(emit, skip, input_len, label_len)


def ctc_forced_align(log_probs: torch.Tensor, labels: torch.Tensor, input_len: int, label_len: int, blank: int = 0):
    """Same contract as :func:`ctc_forced_align_plain`; a CUDA tensor goes
    through the CUDA kernel, a CPU tensor through the plain version. On the
    card the labels are read on the host (labels on the card are copied
    back first, a synchronisation: pass them on the host)."""
    if log_probs.device.type == "cpu":
        return ctc_forced_align_plain(log_probs, labels, input_len, label_len, blank)
    if log_probs.device.type != "cuda":
        raise ValueError(f"ctc_forced_align: unsupported device {log_probs.device}")
    _check_inputs(log_probs, labels, label_len)
    ext, skip = _states(labels.detach().cpu(), blank)
    states, score = ctc_viterbi(log_probs.contiguous()[None], ext[None], skip[None],
                                torch.tensor([int(input_len)]), torch.tensor([int(label_len)]))
    return states[0], score[0]


def ctc_viterbi(log_probs: torch.Tensor, ext: torch.Tensor, skip: torch.Tensor, input_len: torch.Tensor,
                label_len: torch.Tensor):
    """The kernel: log_probs [B, T, V] float32 on one CUDA device (the frames'
    log-probabilities, blank bias applied); on the host, ext [B, S] int (each
    state's label, in [0, V); the even states all the blank), skip [B, S]
    bool (state s may come from s − 2; never an even state), input_len /
    label_len [B] int → (states [B, T] int32, score [B] float32) on the
    card. The host tensors are checked on the host and uploaded in one copy;
    what the kernel cannot take raises."""
    dev = log_probs.device
    if dev.type != "cuda":
        raise ValueError(f"ctc_viterbi: the kernel takes CUDA tensors, got {dev}")
    kernels.require(log_probs, "log_probs", torch.float32, 3, dev)
    B, T, V = log_probs.shape
    for name, t in (("ext", ext), ("skip", skip), ("input_len", input_len), ("label_len", label_len)):
        if t.device.type != "cpu":
            raise ValueError(f"ctc_viterbi: {name} must be on the host (checked there before the upload), got {t.device}")
    if ext.dim() != 2 or ext.shape[0] != B or tuple(skip.shape) != tuple(ext.shape):
        raise ValueError(f"ctc_viterbi: ext {tuple(ext.shape)} and skip {tuple(skip.shape)}, expected [{B}, S] both")
    if tuple(input_len.shape) != (B,) or tuple(label_len.shape) != (B,):
        raise ValueError(f"ctc_viterbi: input_len and label_len must be [{B}]")
    S = ext.shape[1]
    if S > MAX_STATES:
        raise ValueError(f"ctc_viterbi: {S} states (2L + 1) exceed the kernel's {MAX_STATES}: at most "
                         f"{(MAX_STATES - 1) // 2} labels a sequence")
    if B * T * V >= 2**62 or T >= 2**31 or S == 0:
        raise ValueError(f"ctc_viterbi: shape {(B, T, V)} with {S} states not taken")
    lib = kernels.library()
    if lib.ctc_viterbi_tile_frames(V) == 0:
        raise ValueError(f"ctc_viterbi: {V} classes a frame exceed the kernel's shared-memory ring")
    lab = label_len.long()
    if bool(((lab < 0) | (2 * lab + 1 > S)).any()):
        raise ValueError(f"ctc_viterbi: label_len {label_len.tolist()} outside [0, {(S - 1) // 2}]")
    if bool(((ext < 0) | (ext >= V)).any()):
        raise ValueError(f"ctc_viterbi: a state's label lies outside [0, {V})")
    if bool((ext[:, 0::2] != ext[:, :1]).any()) or bool(skip[:, 0::2].any()):
        raise ValueError("ctc_viterbi: the even states must be the blank (ext[b, 0]) and never skip")
    host = torch.cat([input_len.int(), label_len.int(), ext.int().reshape(-1), skip.int().reshape(-1)])
    meta = host.to(dev, non_blocking=False)
    inp, lbl, ext_d, skip_d = meta[:B], meta[B:2 * B], meta[2 * B:2 * B + B * S], meta[2 * B + B * S:]
    kK = lib.ctc_viterbi_states_per_thread(S)
    C = lib.ctc_viterbi_cluster_blocks(S, kK)
    back = torch.empty((B, lib.ctc_viterbi_back_words(T, S, kK, C)), dtype=torch.int32, device=dev)
    states = torch.empty((B, T), dtype=torch.int32, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    global launches
    rc = lib.ctc_viterbi_launch(
        log_probs.data_ptr(), ext_d.data_ptr(), skip_d.data_ptr(), inp.data_ptr(), lbl.data_ptr(), back.data_ptr(),
        states.data_ptr(), score.data_ptr(), B, T, S, V, kK, C, kernels.stream_ptr(log_probs),
    )
    kernels.check(rc, "ctc_viterbi")
    launches += 1
    return states, score
