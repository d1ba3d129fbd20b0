"""The host-side plan of the CTC loss kernels (``csrc/ctc_loss.cu``) and
their hand-off between warps, checked on the CPU.

The CUDA source cannot run here; the kernels themselves are held to the
plain versions on the card (``tests/test_torch_kernels.py``). What is
checked here:

- ``ops/ctc_loss.py:plan``: lane l of warp w of block b of the cluster of 4
  holds states ((b W + w) 32 + l) 2 and the one after; every state is owned
  once, W = ceil(S / 256) fits a block, the row stride holds the layout;
- ``host_meta``: each state's label and skip as ``_states`` gives them,
  and the column lists of the column sums, each column's states in state
  order;
- the column sums' grid-stride loop: every (frame, column) of dlogp once;
- the hand-off through tagged slots in groups of frames (a warp waits for
  a group's slots at its top and stores its own group's at its end; a
  writer reads how far its reader has got): no deadlock, no slot
  overwritten before it is read, under any interleaving of the warps, both
  ways.
"""

import numpy as np
import pytest
import torch

from prosody_control_french_tts_tpu_torch.ops import ctc_loss as cl


def _labels(V, L, seed, labels=None):
    rng = np.random.default_rng(seed)
    return np.asarray(labels, np.int64) if labels is not None else rng.integers(1, V, L)


# ---------------------------------------------------------------------------
# the plan and the host lists
# ---------------------------------------------------------------------------

# S on either side of each warps-a-block boundary (256 states a warp), and
# train_ctc's shapes
PLAN_S = sorted({1, 3, 413, 601, 1201} | {s for w in range(1, 17) for s in (256 * w - 1, 256 * w + 1)
                                          if s <= cl.MAX_STATES})


@pytest.mark.parametrize("S", PLAN_S)
def test_plan_owns_every_state_once(S):
    pl = cl.plan(S)
    assert pl.S == S and 1 <= pl.warps <= cl.MAX_WARPS
    k, blocks = cl.STATES_PER_LANE, cl.CLUSTER
    owner = np.zeros(blocks * pl.warps * 32 * k, np.int64)
    for b in range(blocks):
        for w in range(pl.warps):
            for lane in range(32):
                s0 = ((b * pl.warps + w) * 32 + lane) * k
                owner[s0:s0 + k] += 1
    assert (owner == 1).all() and owner.size >= S
    assert pl.warps == 1 or owner.size - blocks * 32 * k < S  # the fewest warps a block
    assert pl.stride >= owner.size and pl.stride % 64 == 0


def test_plan_refuses():
    assert cl.plan(cl.MAX_STATES - 1).warps == cl.MAX_WARPS
    for S in (0, cl.MAX_STATES + 1):
        with pytest.raises(ValueError, match="4096"):
            cl.plan(S)


@pytest.mark.parametrize("L, V, seed, labels", [(1, 5, 0, None), (6, 5, 0, [1, 1, 2, 2, 1, 1]), (40, 10, 1, None),
                                                (206, 47, 2, None), (300, 48, 3, None)])
def test_host_meta_matches_states_and_columns(L, V, seed, labels):
    lab = _labels(V, L, seed, labels)
    meta = cl.host_meta(lab, 0, V)
    S = 2 * L + 1
    assert meta.dtype == np.int32 and meta.shape == (3 * S + V + 1,)
    ext, skip = cl._states(torch.from_numpy(lab), 0)
    assert (meta[:S] == ext.numpy()).all() and (meta[S:2 * S] == skip.numpy()).all()
    ptr, states = meta[2 * S:2 * S + V + 1], meta[2 * S + V + 1:]
    assert ptr[0] == 0 and ptr[-1] == S and (np.diff(ptr) >= 0).all()
    assert sorted(states.tolist()) == list(range(S))  # every state in one column
    for c in range(V):
        col = states[ptr[c]:ptr[c + 1]]
        assert (np.diff(col) > 0).all() and (meta[col] == c).all()  # state order, its label
    with pytest.raises(ValueError, match="outside"):
        cl.host_meta(lab + V, 0, V)


def _grid(n):  # csrc/ctc_loss.cu grid_for: 256-thread blocks, at most 65,535
    return min(max(-(-n // 256), 1), 65535) * 256


@pytest.mark.parametrize("T, V", [(1, 1), (9, 6), (945, 47), (4200, 48), (400_000, 48)])
def test_columns_grid_covers_every_entry_once(T, V):
    """Thread tid of the column sums' grid takes i = tid, tid + stride, ...
    below T V, (t, c) = divmod(i, V): every entry of dlogp once (past 65,535
    blocks a thread takes more than one)."""
    n, stride = T * V, _grid(T * V)
    visits = np.zeros(n, np.int64)
    for m in range(-(-n // stride)):  # the m-th pass of every thread at once
        tid = np.arange(stride)
        i = tid + m * stride
        np.add.at(visits, i[i < n], 1)
    assert (visits == 1).all()
    t, c = np.divmod(np.arange(n), V)
    assert (t < T).all() and (c < V).all() and (t * V + c == np.arange(n)).all()


# ---------------------------------------------------------------------------
# the hand-off through tagged slots, both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("W, G, steps", [(2, 4, 60), (4, 4, 81), (8, 4, 200), (7, 2, 150), (16, 2, 97), (1, 4, 10)])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_edge_slots_under_any_interleaving(direction, W, G, steps, seed):
    """The hand-off in groups of G frames (steps), through kSlots = 32
    tagged slots a warp. Forward: warp w's group of frames t0 .. t0 + n - 1
    (t0 = 1, 1 + G, ...) starts once its left neighbour's slots hold frames
    t0 - 1 .. t0 + n - 2 and its own reader's mark leaves room for frames up
    to t0 + n - 1 (below mark + 33); at the group's end it stores its frames
    and marks t0 + n - 2 read; frame 0's slot is stored first. Backward: warp
    w's group of steps i0 .. i0 + n - 1 needs its right neighbour's same
    steps, stores its own at the end and marks i0 + n - 1 read. Under random
    interleavings no warp deadlocks, every read returns the value written for
    the frame it waited for, and no slot is overwritten before it is read."""
    K = 32  # csrc/ctc_loss.cu kSlots
    rng = np.random.default_rng(seed)
    fwd = direction == "forward"
    src = (lambda w: w - 1) if fwd else (lambda w: w + 1)  # the neighbour a warp reads
    dst = (lambda w: w + 1) if fwd else (lambda w: w - 1)  # the warp that reads this one
    slots = {(w, q): (-1, None) for w in range(W) for q in range(K)}  # (writer, slot) -> (tag, value)
    mark = [-1] * W  # the last frame (step) warp w has read from its neighbour
    if fwd:
        for w in range(W):
            slots[(w, 0)] = (0, (w, 0))
    first = 1 if fwd else 0
    starts = list(range(first, steps, G))
    pos = {w: (0, "enter") for w in range(W)}  # (group index, phase)

    def span(g):
        t0 = starts[g]
        n = min(G, steps - t0)
        ins = range(t0 - 1, t0 + n - 1) if fwd else range(t0, t0 + n)
        return t0, n, ins, range(t0, t0 + n)

    def may(w):
        g, phase = pos[w]
        if g >= len(starts):
            return False
        if phase == "leave":
            return True
        t0, n, ins, outs = span(g)
        ok_in = not 0 <= src(w) < W or all(slots[(src(w), f % K)][0] == f for f in ins)
        ok_room = not 0 <= dst(w) < W or outs[-1] < mark[dst(w)] + K + 1
        return ok_in and ok_room

    while any(pos[w][0] < len(starts) for w in range(W)):
        runnable = [w for w in range(W) if may(w)]
        assert runnable, "deadlock"
        w = runnable[int(rng.integers(len(runnable)))]
        g, phase = pos[w]
        t0, n, ins, outs = span(g)
        if phase == "enter":
            if 0 <= src(w) < W:
                for f in ins:
                    assert slots[(src(w), f % K)] == (f, (src(w), f))
            pos[w] = (g, "leave")
        else:
            if 0 <= dst(w) < W:
                for f in outs:
                    old = slots[(w, f % K)][0]
                    assert old < 0 or old <= mark[dst(w)], "a slot overwritten before it was read"
                    slots[(w, f % K)] = (f, (w, f))
            if 0 <= src(w) < W:
                mark[w] = ins[-1]
            pos[w] = (g + 1, "enter")
