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

The log-softmax, the blank bias and the gather of each state's emission
(``log_probs[:, ext]``) are plain tensor operations before the Viterbi.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels

NEG = -1e30
MAX_STATES = 16 * 1024  # one block of 1,024 threads, 16 states a thread

launches = 0  # kernel launches (CUDA path only)


def expand_labels(labels: torch.Tensor, blank: int) -> torch.Tensor:
    """[L] → [2L+1] blank-interleaved."""
    ext = torch.full((2 * labels.shape[-1] + 1,), blank, dtype=labels.dtype, device=labels.device)
    ext[1::2] = labels
    return ext


def _prepare(log_probs: torch.Tensor, labels: torch.Tensor, blank: int):
    """(emissions [T, S] float32, skip [S] bool) of one sequence."""
    if log_probs.dim() != 2 or labels.dim() != 1:
        raise ValueError(f"ctc_forced_align: log_probs [T, V] and labels [L], got {tuple(log_probs.shape)} and {tuple(labels.shape)}")
    if log_probs.dtype != torch.float32:
        raise TypeError(f"ctc_forced_align: log_probs has dtype {log_probs.dtype}, expected torch.float32")
    ext = expand_labels(labels.to(log_probs.device).long(), blank)
    emit = log_probs[:, ext].contiguous()  # [T, S]
    s_idx = torch.arange(ext.shape[0], device=ext.device)
    skip = (s_idx >= 2) & (s_idx % 2 == 1) & (ext != torch.roll(ext, 2))
    return emit, skip


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
    emit, skip = _prepare(log_probs, labels, blank)
    _check_lengths(emit, labels, label_len)
    return ctc_viterbi_plain(emit, skip, input_len, label_len)


def _check_lengths(emit: torch.Tensor, labels: torch.Tensor, label_len: int) -> None:
    if not 0 <= int(label_len) <= labels.shape[0]:
        raise ValueError(f"ctc_forced_align: label_len {label_len} outside [0, {labels.shape[0]}]")
    if emit.shape[0] == 0:
        raise ValueError("ctc_forced_align: no frames")


def ctc_forced_align(log_probs: torch.Tensor, labels: torch.Tensor, input_len: int, label_len: int, blank: int = 0):
    """Same contract as :func:`ctc_forced_align_plain`; a CUDA tensor goes
    through the CUDA kernel, a CPU tensor through the plain version."""
    if log_probs.device.type == "cpu":
        return ctc_forced_align_plain(log_probs, labels, input_len, label_len, blank)
    if log_probs.device.type != "cuda":
        raise ValueError(f"ctc_forced_align: unsupported device {log_probs.device}")
    emit, skip = _prepare(log_probs, labels, blank)
    _check_lengths(emit, labels, label_len)
    states, score = ctc_viterbi(emit[None], skip[None], torch.tensor([int(input_len)], dtype=torch.int32),
                                torch.tensor([int(label_len)], dtype=torch.int32))
    return states[0], score[0]


def ctc_viterbi(emit: torch.Tensor, skip: torch.Tensor, input_len: torch.Tensor, label_len: torch.Tensor):
    """The kernel: emit [B, T, S] float32 and skip [B, S] bool on one CUDA
    device, input_len / label_len [B] int32 (any device) → (states [B, T]
    int32, score [B] float32). A tensor the kernel cannot take raises."""
    dev = emit.device
    if dev.type != "cuda":
        raise ValueError(f"ctc_viterbi: the kernel takes CUDA tensors, got {dev}")
    kernels.require(emit, "emit", torch.float32, 3, dev)
    B, T, S = emit.shape
    if tuple(skip.shape) != (B, S):
        raise ValueError(f"ctc_viterbi: skip has shape {tuple(skip.shape)}, expected {(B, S)}")
    if S > MAX_STATES:
        raise ValueError(f"ctc_viterbi: {S} states (2L + 1) exceed the kernel's {MAX_STATES} (one block, "
                         f"16 states a thread): at most {(MAX_STATES - 1) // 2} labels a sequence")
    if B * T * S >= 2**62 or T >= 2**31:
        raise ValueError(f"ctc_viterbi: shape {(B, T, S)} too large")
    lab = label_len.to(device=dev, dtype=torch.int32).contiguous()
    if bool(((lab < 0) | (2 * lab + 1 > S)).any()):
        raise ValueError(f"ctc_viterbi: label_len {label_len.tolist()} outside [0, {(S - 1) // 2}]")
    inp = input_len.to(device=dev, dtype=torch.int32).contiguous()
    sk = skip.to(device=dev, dtype=torch.uint8).contiguous()
    back = torch.empty((B, max(T - 1, 1), S), dtype=torch.int8, device=dev)
    states = torch.empty((B, T), dtype=torch.int32, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    global launches
    rc = kernels.library().ctc_viterbi_launch(
        emit.data_ptr(), sk.data_ptr(), inp.data_ptr(), lab.data_ptr(), back.data_ptr(), states.data_ptr(),
        score.data_ptr(), B, T, S, kernels.stream_ptr(emit),
    )
    kernels.check(rc, "ctc_viterbi")
    launches += 1
    return states, score
