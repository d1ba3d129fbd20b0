"""The schedules of the two kernels that replace XLA loops: ``mask_ema``
(the spectral gate's two-way time smoothing) and ``ctc_viterbi`` (the CTC
forced-alignment Viterbi), modelled step by step in numpy and held to the
plain PyTorch versions bit for bit, and the CTC one through them to the JAX
package's ``align/ctc.py:ctc_forced_align``.

The CUDA sources cannot run here. These models follow them:

- ``csrc/mask_ema.cu``: each pass (backward, then forward over its result)
  cut into chunks of 256 frames in the pass's order; a chunk's chain
  restarted ``WARMUP`` frames ahead of it from that frame's value, its
  entered state kept; chunk 0 exact; then the fix-up walk over each bin's
  chunks in order, which recomputes from the true state every chunk whose
  entered state differs, bit for bit, from the true output before it. The
  model walks the chunks of all bins together; the kernel's warp takes 32
  chunks a ballot while nothing was recomputed, which compares the same
  values.
- ``csrc/ctc_viterbi.cu``: kK consecutive states a thread (2, 4, 8, 16),
  the threads of C blocks one after another, each state's emission read
  from the frame's [V] log-probabilities at its label, the two states before
  a thread's first from the thread before it; the back-pointers, 2 bits a
  state, gathered 2 kK bits a frame into a thread's 16-byte entry over
  64 / kK frames; the backtrack in windows of 64 frames staged as the words
  of states [ref - 256, ref], each word put together from the entries that
  hold its 16 states, the words the state two frames on can fall in read
  before it is known. Two schedules are modelled on their own: the ring of
  frame tiles (every frame's row read from the slot that holds its tile,
  after the wait and barrier that make it visible, no slot refilled while
  a frame of its tile is still to be read) and the hand-off of the edge
  states between warps and blocks through tagged slots (no deadlock, no
  slot overwritten before it is read, under any interleaving).

What the models get right here, the kernels are held to on the card
(``tests/test_torch_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosody_control_french_tts_tpu.align import ctc as jctc
from prosody_control_french_tts_tpu_torch.ops import ctc_viterbi, mask_ema

from test_torch_kernels import ctc_fixture, mask_fixture

f32 = np.float32

# ---------------------------------------------------------------------------
# mask_ema: speculate and verify
# ---------------------------------------------------------------------------

CHUNK = 256  # csrc/mask_ema.cu kChunk


def ema_pass_model(x, a, b, warm):
    """One pass over x [F, T] float32 in the pass's order (column p is the
    pass's p-th frame) → (out [F, T], fixed [F, K] bool: the chunks the
    fix-up recomputed)."""
    F, T = x.shape
    K = -(-T // CHUNK)
    out = np.empty_like(x)
    enter = np.zeros((F, K), f32)
    # the speculative launch: chunk 0 from the pass's first frame, chunk k >= 1
    # restarted `warm` frames ahead of it (warm <= CHUNK <= k * CHUNK)
    v0 = x[:, 0].copy()
    out[:, 0] = v0
    for p in range(1, min(CHUNK, T)):
        v0 = a * v0 + b * x[:, p]
        out[:, p] = v0
    if K > 1:
        starts = np.arange(1, K) * CHUNK
        v = x[:, starts - warm].copy()
        for i in range(1, warm):
            v = a * v + b * x[:, starts - warm + i]
        enter[:, 1:] = v
        for i in range(CHUNK):
            p = starts + i
            live = p < T
            v = a * v + b * x[:, np.minimum(p, T - 1)]
            out[:, p[live]] = v[:, live]
    # the fix-up: each chunk against the true output before it
    fixed = np.zeros((F, K), bool)
    for k in range(1, K):
        last = out[:, k * CHUNK - 1]
        bad = enter[:, k].view(np.uint32) != last.view(np.uint32)
        if bad.any():
            fixed[bad, k] = True
            v = last[bad]
            for p in range(k * CHUNK, min((k + 1) * CHUNK, T)):
                v = a * v + b * x[bad, p]
                out[bad, p] = v
    return out, fixed


def mask_ema_model(m, smooth, warm=mask_ema.WARMUP):
    """m [F, T] float32 → (the smoothed mask, chunks recomputed by the
    backward pass's fix-up, by the forward pass's)."""
    a, b = f32(smooth), f32(1 - smooth)
    u, fixed_bwd = ema_pass_model(np.ascontiguousarray(m[:, ::-1]), a, b, warm)
    w, fixed_fwd = ema_pass_model(np.ascontiguousarray(u[:, ::-1]), a, b, warm)
    return w, fixed_bwd, fixed_fwd


def sparse_ones(F, T, every=500):
    """Exact zeros with a 1 every ``every`` frames: values halve down to the
    subnormal floor, where restarted chains meet late."""
    m = np.zeros((F, T), f32)
    m[:, ::every] = 1.0
    return m


def plain(m, smooth):
    return mask_ema.mask_ema_plain(torch.from_numpy(m), smooth).numpy()


def assert_bits(got, want):
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# (F, T): one bin and 513, T below one chunk, one chunk and a frame, T not a
# multiple of 4, many chunks
MASK_SHAPES = [(1, 100), (4, 257), (513, 1027), (513, 6000), (1, 6000)]


@pytest.mark.parametrize("smooth", [0.5, 0.3, 0.9, 0.999])
@pytest.mark.parametrize("shape", MASK_SHAPES)
def test_mask_ema_model_equals_plain(shape, smooth):
    m = mask_fixture(*shape, seed=shape[0] * 3 + shape[1])
    got, fixed_bwd, fixed_fwd = mask_ema_model(m, smooth)
    assert_bits(got, plain(m, smooth))
    K = -(-shape[1] // CHUNK)
    # chunk 0 starts the pass, and a chunk whose warm-up reaches back to the
    # pass's first frame restarts from it: both exact
    exact = np.arange(K) * CHUNK <= mask_ema.WARMUP
    assert not fixed_bwd[:, exact].any() and not fixed_fwd[:, exact].any()
    if (~exact).any() and smooth == 0.999:
        # the mask does not forget its start within the warm-up: nearly every other chunk is recomputed
        assert fixed_bwd[:, ~exact].mean() > 0.9 and fixed_fwd[:, ~exact].mean() > 0.9
    if smooth in (0.5, 0.3):
        assert not fixed_bwd.any() and not fixed_fwd.any()


@pytest.mark.parametrize("warm", [128, CHUNK])
def test_mask_ema_model_on_exact_zero_stretches(warm):
    """Long stretches of exact zeros: a restarted chain halves towards the
    subnormal floor and meets the true one only after well over 100 steps,
    so chunks are recomputed, fewer with a longer warm-up; all exact."""
    m = sparse_ones(64, 6000)
    got, fixed_bwd, fixed_fwd = mask_ema_model(m, 0.5, warm)
    assert_bits(got, plain(m, 0.5))
    n = fixed_bwd.sum() + fixed_fwd.sum()
    assert 0 < n < fixed_bwd[:, 1:].size
    if warm == CHUNK:
        _, fb, ff = mask_ema_model(m, 0.5, 128)
        assert n < fb.sum() + ff.sum()


def test_mask_ema_model_forced_fixups_recompute_every_chunk():
    """smooth 0.999 with a warm-up of one frame: every chunk after the first
    enters wrong and is recomputed from the true state: the sequential
    chain again, still exact."""
    m = mask_fixture(33, 2000, seed=4)
    got, fixed_bwd, fixed_fwd = mask_ema_model(m, 0.999, warm=1)
    assert_bits(got, plain(m, 0.999))
    assert fixed_bwd[:, 1:].all() and fixed_fwd[:, 1:].all()


def test_mask_ema_model_on_the_gate_mask_needs_no_fixup(tmp_path):
    """The spectral gate's own mask of a brute recording like the pipeline's
    (three synthetic segments joined by 1.5 s of zeros, 44.1 kHz, hop 256)
    at smooth 0.5: after the kernel's warm-up every chunk enters with the
    true state; after 128 frames some chunks of the backward pass do not
    (the gaps' mask values, about 3e-26, halve towards the subnormal floor),
    and after 32 many more."""
    from prosody_control_french_tts_tpu_torch.audio.denoise import gate_mask
    from prosody_control_french_tts_tpu_torch.ops.stft import stft
    from prosody_control_french_tts_tpu_torch.utils.synth import synth_voice
    from prosody_control_french_tts_tpu_torch.utils.wavio import read_wav

    seg_files, _, _ = synth_voice(tmp_path, seed=0, n_segments=3)
    parts = []
    for p in seg_files:
        a = read_wav(p)
        parts += [np.asarray(a.samples, f32), np.zeros(int(1.5 * a.rate), f32)]
    x = torch.from_numpy(np.concatenate(parts[:-1]))
    m = gate_mask(stft(x, 1024, 256)).numpy()
    got, fixed_bwd, fixed_fwd = mask_ema_model(m, 0.5)
    assert_bits(got, plain(m, 0.5))
    assert not fixed_bwd.any() and not fixed_fwd.any()
    _, fb128, ff128 = mask_ema_model(m, 0.5, warm=128)
    _, fb32, ff32 = mask_ema_model(m, 0.5, warm=32)
    assert 0 < fb128.sum() + ff128.sum() < fb32.sum() + ff32.sum()


# ---------------------------------------------------------------------------
# ctc_viterbi: gather from the frame's log-probs, packed pointers, windows
# ---------------------------------------------------------------------------

NEG = f32(-1e30)
WIN = 64  # csrc/ctc_viterbi.cu kWin
WIN_WORDS = 4 * WIN // 16 + 2
TILES, MAX_TILE_FRAMES, RING_BYTES = 3, 64, 40 * 1024  # the ring


def tile_frames(V):
    tf = min(RING_BYTES // (TILES * V * 4), MAX_TILE_FRAMES) & ~3
    return tf if tf >= 4 else 0


def block_threads(S, kK, C):
    return (-(-(-(-S // kK)) // C) + 31) // 32 * 32


def group_frames(kK):
    return 64 // kK


def row_word(back, nt, row, c, kK):
    """Word c of pointer row `row` (states 16 c .. 16 c + 15) from the
    threads' 16-byte entries, as the backtrack stages it."""
    G = group_frames(kK)
    g, bit = row // G, (row % G) * 2 * kK
    mask = (1 << (2 * kK)) - 1
    w = 0
    for q in range(16 // kK):
        w |= ((int(back[g, c * (16 // kK) + q, bit >> 5]) >> (bit & 31)) & mask) << (2 * kK * q)
    return w


def unpack(word, s):
    return int(word) >> (2 * (s & 15)) & 3


def ctc_model(lp, labels, input_len, label_len, kK, C=1, blank=0):
    """The kernel's schedule on one sequence (C blocks, kK states a thread):
    lp [T, V] float32 → (states [T] int32, score float32, the pointer
    entries [groups, threads, 4] uint32)."""
    T, V = lp.shape
    L = len(labels)
    S = 2 * L + 1
    ext = np.full(S, blank, np.int64)
    ext[1::2] = labels
    s_idx = np.arange(S)
    skip = (s_idx >= 2) & (s_idx % 2 == 1) & (ext != np.roll(ext, 2))
    n = C * block_threads(S, kK, C)  # the sequence's threads, block after block
    RW = n * kK // 16
    sp = np.arange(n * kK).reshape(n, kK)  # thread i holds states i kK .. i kK + kK - 1
    lab = np.where(sp < S, np.pad(ext, (0, n * kK - S))[sp], 0)
    sk = np.where(sp < S, np.pad(skip, (0, n * kK - S))[sp], False)
    valid = sp < 2 * label_len + 1
    Tv = min(max(input_len, 1), T)
    a = np.where((sp < 2) & valid, lp[0][lab], NEG).astype(f32)
    G = group_frames(kK)
    back = np.zeros((-(-max(T - 1, 1) // G), n, 4), np.uint32)
    for t in range(1, Tv):
        e = lp[t][lab]  # each thread gathers its states' emissions from the frame's row
        flat = a.reshape(-1)
        p1 = np.concatenate([[NEG], flat[kK - 1::kK][:-1]])  # the thread before's last state
        p2 = np.concatenate([[NEG], flat[kK - 2::kK][:-1]])  # and its second-last
        f1 = np.concatenate([p1[:, None], a[:, :-1]], 1)
        f2 = np.concatenate([p2[:, None], p1[:, None], a[:, :-2]], 1)[:, :kK]
        f2 = np.where(sk, f2, NEG)
        take1 = f1 > a
        m = np.where(take1, f1, a)
        take2 = f2 > m
        m = np.where(take2, f2, m)
        best = np.where(take2, 2, take1.astype(int))
        a = np.where(valid, m + e, NEG).astype(f32)
        # 2 kK bits a thread, frame f of its group at bits 2 kK f of the 128-bit entry
        pk = (best.astype(np.uint64) << (2 * np.arange(kK, dtype=np.uint64))).sum(1)
        g, bit = (t - 1) // G, ((t - 1) % G) * 2 * kK
        back[g, :, bit >> 5] |= (pk << np.uint64(bit & 31)).astype(np.uint32)
    flat = a.reshape(-1)
    endA = 2 * label_len
    endB = max(endA - 1, 0)
    last = endA if flat[endA] >= flat[endB] else endB
    score = max(flat[endA], flat[endB])
    states = np.full(T, last, np.int32)
    # backtrack: window i staged as the words [w0, w0 + WIN_WORDS) of its rows
    st = ref = last
    hi = Tv - 2
    while hi >= 0:
        lo = max(hi - WIN + 1, 0)
        w0 = max(ref - 4 * WIN, 0) >> 4
        win = np.zeros((WIN, WIN_WORDS), np.uint32)
        for r in range(hi - lo + 1):
            for c in range(WIN_WORDS):
                if w0 + c < RW:
                    win[r, c] = row_word(back, n, lo + r, w0 + c, kK)

        def word(r, s):
            c = (s >> 4) - w0
            assert 0 <= c < WIN_WORDS, (s, ref, w0)
            return win[r, c]

        # the state two frames on lies in [s - 4, s]: its row's words at s and
        # s - 4 are read before it is known, and one of them is chosen after
        s = st
        cur = word(hi - lo, s)
        pending = {hi - lo - 1: (s >> 4, s - 4)}  # row -> (s's word, the lower state's)
        for t in range(hi, lo - 1, -1):
            r = t - lo
            if r >= 2:
                pending[r - 2] = (s >> 4, s - 4)
            ns = s - unpack(cur, s)
            states[t] = ns
            if r >= 1:
                top, low = pending.pop(r - 1)
                cur = word(r - 1, ns) if ns >> 4 == top else word(r - 1, max(low, 0))
                assert (ns >> 4) in (top, max(low, 0) >> 4)
            s = ns
        ref, st = st, s
        hi = lo - 1
    return states, f32(score), back


def jax_align(lp, labels, input_len, label_len):
    states, score = jctc.ctc_forced_align(jnp.asarray(lp), jnp.asarray(labels), input_len, label_len)
    return np.asarray(states), float(score)


# (T, L, V, ties): V 47 (rows of 188 bytes, not 16-byte multiples) and 48 (the
# aligner's vocabulary); S from 1 to 401; windows of 64 frames crossed
CTC_CASES = [(1, 0, 47, False), (9, 1, 48, True), (70, 15, 47, True), (200, 31, 48, False), (300, 100, 47, True),
             (150, 200, 48, True)]


@pytest.mark.parametrize("kK", [2, 4, 8, 16])
@pytest.mark.parametrize("case", CTC_CASES)
def test_ctc_model_equals_plain_and_jax(case, kK):
    T, L, V, ties = case
    lp, labels = ctc_fixture(T, L, seed=T * 7 + L, V=V, ties=ties)
    lpn = lp.numpy()
    for input_len, label_len in ((T, L), (max(T // 2, 1), L // 2)):
        states, score, _ = ctc_model(lpn, labels.numpy(), input_len, label_len, kK, C=1 + L % 3)
        want_states, want_score = ctc_viterbi.ctc_forced_align_plain(lp, labels, input_len, label_len)
        assert np.array_equal(states, want_states.numpy())
        assert score.view(np.int32) == want_score.numpy().view(np.int32)
        if L:  # the JAX function takes one label at least (its s - 2 shift)
            js, jscore = jax_align(lpn, labels.numpy(), input_len, label_len)
            assert np.array_equal(states, js)
            assert abs(float(score) - jscore) <= 1e-6 * max(abs(jscore), 1.0)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("kK", [2, 4, 8, 16])
def test_ctc_model_pointer_rows_unpack_to_the_plain_choices(kK, C):
    """Every packed pointer, gathered back into its row's word as the
    backtrack stages it and unpacked at its state, is the plain version's
    choice (0 stay, 1 from s - 1, 2 from s - 2)."""
    T, L, V = 70, 45, 48
    lp, labels = ctc_fixture(T, L, seed=kK, V=V, ties=True)
    _, _, back = ctc_model(lp.numpy(), labels.numpy(), T, L, kK, C)
    n = back.shape[1]
    emit, skip = ctc_viterbi._prepare(lp, labels, 0)
    S = emit.shape[1]
    neg = np.float32(-1e30)
    alpha = np.where(np.arange(S) < 2, emit[0].numpy(), neg)
    for t in range(1, T):
        from1 = np.concatenate([[neg], alpha[:-1]])
        from2 = np.where(skip.numpy(), np.concatenate([[neg, neg], alpha[:-2]]), neg)
        take1 = from1 > alpha
        m = np.where(take1, from1, alpha)
        take2 = from2 > m
        want = np.where(take2, 2, take1.astype(int))
        words = [row_word(back, n, t - 1, c, kK) for c in range(n * kK // 16)]
        assert [unpack(words[s >> 4], s) for s in range(S)] == want.tolist()
        alpha = (np.where(take2, from2, m) + emit[t].numpy()).astype(np.float32)


@pytest.mark.parametrize("V", [47, 48, 5, 853])
@pytest.mark.parametrize("Tv", [1, 2, 3, 4, 63, 64, 65, 129, 700])
def test_ctc_ring_schedule(V, Tv):
    """The forward's ring: tiles 0 .. 2 issued before the loop and tile 0
    waited for; frame t (t >= 1) opens tile t / TF where t is a multiple of
    TF, which refills the slot of the tile before it with the tile two
    ahead; the end of frame t waits for all but the newest kTiles - 2 groups
    when frame t + 1 opens a tile, then the barrier. Every frame's row must
    be read from its tile's slot after that tile's group completed and a
    barrier passed, and no slot may be refilled before all reads of its
    tile."""
    TF = tile_frames(V)
    assert TF % 4 == 0 and TF >= 4 and TILES * TF * V * 4 <= RING_BYTES
    groups = []  # tile of each committed group, in order (None: empty)
    slot_tile = {}  # slot -> tile whose copies were issued into it
    done = set()  # tiles whose group completed in every thread
    visible = set()  # tiles completed before a barrier

    def commit(m):
        if m * TF < Tv:
            slot_tile[m % TILES] = m
        groups.append(m if m * TF < Tv else None)

    def wait_prior(n):
        for g in groups[: len(groups) - n]:
            if g is not None:
                done.add(g)

    def barrier():
        visible.update(done)

    def read(t):
        m = t // TF
        assert slot_tile[m % TILES] == m and m in visible

    for m in range(TILES):
        commit(m)
    wait_prior(TILES - 1)
    barrier()
    read(0)
    barrier()
    next_tile, tr = TILES, 1
    reads_left = {m: min(TF, Tv - m * TF) for m in range(-(-Tv // TF))}
    reads_left[0] -= 1
    for t in range(1, Tv):  # every warp's reads of frame t fall between the tile barriers around it
        if tr == TF:
            assert reads_left[t // TF - 1] == 0  # the slot's tile is fully read
            commit(next_tile)
            next_tile += 1
            tr = 0
        read(t)
        reads_left[t // TF] -= 1
        if tr + 1 == TF:  # the tile's last frame: the wait, then the block's only barrier in the tile
            wait_prior(TILES - 2)
            barrier()
        tr += 1
    assert not any(reads_left.values())


CROSS_SLOTS = 256  # csrc/ctc_viterbi.cu kCrossSlots


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("C, warps, TF, Tv, X", [(1, 26, 64, 700, CROSS_SLOTS), (7, 4, 64, 1500, CROSS_SLOTS),
                                                 (2, 2, 4, 90, 9), (3, 8, 40, 333, 81), (8, 1, 4, 200, 9)])
def test_ctc_edge_slots_under_any_interleaving(C, warps, TF, Tv, X, seed):
    """The hand-off between warps: warp w of block k may compute frame t once
    its predecessor's slot of frame t - 1 carries the tag t - 1 (the warp
    before it: slot (t - 1) % (TF + 1) of the block's slots; the first warp
    of block k > 0: slot (t - 1) % X of the slots the block before writes;
    the first warp of block 0 waits for no one); it then writes its own slot
    of frame t, and the last warp of a block with a block after it also that
    block's slot t % X, but only while t < read + X, `read` being what the
    block after last reported: at each tile barrier (a warp ending a tile
    waits there for the rest of its block), the frame below which its first
    warp has read every slot. Under random interleavings no warp deadlocks
    and every read returns the value written for the frame it waited for."""
    rng = np.random.default_rng(seed)
    D = TF + 1
    local, cross = {}, {}  # (block, slot, warp) -> (tag, value); (block, slot) -> (tag, value)
    read = [0] * C  # frames below which block k + 1 has read block k's slots
    for k in range(C):
        for w in range(warps):
            local[(k, 0, w)] = (0, (k, w, 0))
        if k > 0:
            cross[(k, 0)] = (0, (k - 1, warps - 1, 0))
    nxt = {(k, w): 1 for k in range(C) for w in range(warps)}
    at_barrier = {key: False for key in nxt}

    def pred(k, w, t):
        if w > 0:
            return local.get((k, (t - 1) % D, w - 1))
        return cross.get((k, (t - 1) % X)) if k > 0 else (t - 1, None)

    def expect(k, w, t):
        return (t - 1, (k, w - 1, t - 1)) if w > 0 else (t - 1, (k - 1, warps - 1, t - 1) if k > 0 else None)

    while min(nxt.values()) < Tv:
        runnable = []
        for (k, w), t in nxt.items():
            if t >= Tv or at_barrier[(k, w)]:
                continue
            if (pred(k, w, t) or (None,))[0] != t - 1:
                continue
            if w == warps - 1 and k + 1 < C and t >= read[k] + X:
                continue  # the producer waits for the block after
            runnable.append((k, w))
        if not runnable:  # whatever waits must be a complete tile barrier of some block
            released = False
            for k in range(C):
                live = [w for w in range(warps) if nxt[(k, w)] < Tv]
                if live and all(at_barrier[(k, w)] for w in live):
                    for w in live:
                        at_barrier[(k, w)] = False
                    if k > 0:
                        read[k - 1] = nxt[(k, 0)] - 1
                    released = True
            assert released, "deadlock"
            continue
        k, w = runnable[int(rng.integers(len(runnable)))]
        t = nxt[(k, w)]
        assert pred(k, w, t) == expect(k, w, t)
        local[(k, t % D, w)] = (t, (k, w, t))
        if w == warps - 1 and k + 1 < C:
            cross[(k + 1, t % X)] = (t, (k, w, t))
        nxt[(k, w)] += 1
        if (t + 1) % TF == 0 and t + 1 < Tv:
            at_barrier[(k, w)] = True
