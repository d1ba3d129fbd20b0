"""The schedules of kernels A (pitch candidates) and E (chunk cumsum),
modelled step by step in numpy and held to the plain PyTorch versions bit
for bit and to the JAX package's Pallas kernels in interpret mode.

The CUDA sources cannot run here. These models follow them lane by lane:
A (``csrc/pitch_candidates.cu``) as one warp per row, lags ``l + 32 q`` in
lane l's register q, rows with no lag above half the voicing threshold
stopped at once, neighbours by one shuffle each, compaction by ballot and
popcount, a rank against the whole list in rounds of 32 entries, the parabolic step on the
lane that holds the entry, zeros past the row's maxima; E (``csrc/chunk_cumsum.cu``) as one warp per 1024-column chunk,
column ``l + 32 j`` in lane l's register j, steps below 32 as one shuffle
per register from lane ``(l − s) mod 32``, steps from 32 up within the
lane. What the models get right here, the kernels are held to on the card
(``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prosody_control_french_tts_tpu.ops import pallas_kernels as jpk
from prosody_control_french_tts_tpu_torch.ops import candidates, chunk_cumsum as tcc

from test_torch_kernels import (
    CAND_LENGTHS, K_CAND, MAX_LAG, MIN_LAG, VTH, candidate_fixtures, maxima_counts, maxima_rows,
)

WARP = 32
TOL_A = 1e-6  # chip_smoke.TOL_A: kernel A's lag_f and strength


def _popc(x: int) -> int:
    return bin(x).count("1")


def plan_candidates(r, k, min_lag, max_lag, vth):
    """Kernel A's schedule on r [R, L] float32 → (lag_f, strength, valid
    uint8, per-row maxima count, per-row rank rounds)."""
    R, L = r.shape
    P = -(-L // WARP)
    half = np.float32(0.5 * vth)
    lane = np.arange(WARP)
    lag = lane[:, None] + WARP * np.arange(P)[None, :]  # [lane, q]
    need = (lag >= min_lag - 1) & (lag <= max_lag)
    below = [(1 << int(l)) - 1 for l in lane]
    cap = (max_lag - min_lag + 1) // 2 if max_lag > min_lag else 0
    f32 = np.float32
    lag_f = np.zeros((R, k), f32)
    strength = np.zeros((R, k), f32)
    valid = np.zeros((R, k), np.uint8)
    counts, rounds = np.zeros(R, int), np.zeros(R, int)
    for row in range(R):
        v = np.where(need, r[row][np.minimum(lag, L - 1)], f32(0)).astype(f32)
        entries, n = {}, 0
        # a row with no loaded lag above half the threshold holds no maximum
        for q in range(P) if (v > half).any() else ():
            c = v[:, q]
            # lane l reads lane l − 1; lane 31 sends register q − 1 (lane 0's r[i−1])
            send_lo = np.where((lane == WARP - 1) & (q > 0), v[:, max(q - 1, 0)], c)
            lo = send_lo[(lane - 1) % WARP]
            # lane l reads lane l + 1; lane 0 sends register q + 1 (lane 31's r[i+1])
            send_hi = np.where((lane == 0) & (q + 1 < P), v[:, min(q + 1, P - 1)], c)
            hi = send_hi[(lane + 1) % WARP]
            i = lag[:, q]
            is_max = (c > half) & (i >= min_lag) & (i < max_lag) & (c > lo) & (c >= hi)
            ballot = sum(1 << int(l) for l in lane[is_max])
            for l in lane[is_max]:
                j = n + _popc(ballot & below[l])
                assert j not in entries
                entries[j] = (c[l], int(i[l]), lo[l], hi[l])
            n += _popc(ballot)
        assert sorted(entries) == list(range(n)) and n <= cap
        vals = np.array([entries[j][0] for j in range(n)], f32)
        counts[row] = n
        for rnd in range(-(-n // WARP)):  # one round for n <= 32, more for the rest
            rounds[row] += 1
            for j in range(rnd * WARP, min(n, (rnd + 1) * WARP)):
                e = np.arange(n)
                rank = int(np.sum((vals > vals[j]) | ((vals == vals[j]) & (e < j))))
                if rank >= k:
                    continue
                rv, i, rl, rp = entries[j]
                dr = f32(0.5) * (rp - rl)
                d2r = (f32(2.0) * rv - rl) - rp
                offset = dr / d2r if abs(d2r) > f32(1e-12) else f32(0)
                assert valid[row, rank] == 0  # each rank is taken once
                lag_f[row, rank] = f32(i) + np.clip(offset, f32(-1), f32(1))
                strength[row, rank] = rv + (f32(0.5) * dr) * offset
                valid[row, rank] = 1
        for t in range(min(n, k), k):  # the zero padding
            assert valid[row, t] == 0
        assert valid[row, : min(n, k)].all()
    return lag_f, strength, valid, counts, rounds


def _plain(r, k, min_lag, max_lag):
    out = candidates.topk_parabolic_plain(torch.from_numpy(r), k, min_lag, max_lag, VTH)
    return [o.numpy() for o in out]


def _assert_plan_equals_plain(r, k, min_lag, max_lag):
    lag_f, strength, valid, counts, rounds = plan_candidates(r, k, min_lag, max_lag, VTH)
    want = _plain(r, k, min_lag, max_lag)
    np.testing.assert_array_equal(valid.astype(bool), want[2])
    assert lag_f.tobytes() == want[0].tobytes()
    assert strength.tobytes() == want[1].tobytes()
    return lag_f, strength, valid, counts, rounds


@pytest.mark.parametrize("seed", [3, 5, 6])
def test_candidates_plan_on_fixtures_equals_plain(seed):
    """The JAX package's fixture rows (oscillatory, flat, sparse, quantised
    ties) at the measure path's lags: bit for bit; the oscillatory rows
    take the overflow path (more than 32 maxima)."""
    r = candidate_fixtures(seed)
    *_, counts, rounds = _assert_plan_equals_plain(r, K_CAND, MIN_LAG, MAX_LAG)
    assert counts.max() > WARP and rounds.max() == 2 and (counts == 0).any()


@pytest.mark.parametrize("k", [1, K_CAND, 40])
@pytest.mark.parametrize("L", CAND_LENGTHS)
def test_candidates_plan_on_maxima_rows_equals_plain(L, k):
    """Rows with 0, 1, k − 1, k, k + 1, 32, 33 and (L − 1) // 2 maxima, with
    and without exact ties, at every per-lane count P = 1..32: bit for bit,
    every count reached, the overflow path taken where the row allows."""
    r = maxima_rows(L, k, seed=L * 100 + k)
    *_, counts, rounds = _assert_plan_equals_plain(r, k, 1, L - 1)
    np.testing.assert_array_equal(counts, np.repeat(maxima_counts(L, k), 2))
    assert rounds.max() == -(-counts.max() // WARP)


def test_candidates_plan_ties_cross_the_round_boundary():
    """40 equal peaks: entries 32..39 (the second round) lose to every entry
    of the first, so with k 36 the output is the 36 smallest lags in order."""
    L = 128
    r = np.full((1, L), 0.1, np.float32)
    peaks = np.arange(3, 3 + 2 * 40, 2)
    r[0, peaks] = 0.7
    lag_f, _, valid, counts, rounds = _assert_plan_equals_plain(r, 36, 1, L - 1)
    assert counts[0] == 40 and rounds[0] == 2 and valid.all()
    np.testing.assert_array_equal(np.rint(lag_f[0]), peaks[:36])


def test_candidates_plan_rows_above_threshold_without_maxima():
    """Rows above half the threshold with no interior maximum (a rising
    ramp, a plateau, a peak at max_lag) pass the row test and find none;
    a row above it only at min_lag − 1 and max_lag finds none either."""
    L = 297
    t = np.linspace(0.3, 0.9, L, dtype=np.float32)
    r = np.stack([t, np.full(L, 0.6, np.float32), np.where(np.arange(L) <= MAX_LAG, t, 0.0), np.zeros(L)]).astype(np.float32)
    r[3, [MIN_LAG - 1, MAX_LAG]] = 0.9
    *_, counts, _ = _assert_plan_equals_plain(r, K_CAND, MIN_LAG, MAX_LAG)
    np.testing.assert_array_equal(counts, 0)


@pytest.mark.parametrize("source", ["fixtures", "maxima_rows_297", "maxima_rows_512"])
def test_candidates_plan_matches_jax_kernel(source):
    """The plan against the Pallas kernel in interpret mode: valid equal,
    lag_f and strength within TOL_A."""
    if source == "fixtures":
        r, k, lo, hi = candidate_fixtures(7), K_CAND, MIN_LAG, MAX_LAG
    else:
        L = int(source.rsplit("_", 1)[1])
        r, k, lo, hi = maxima_rows(L, K_CAND, seed=L), K_CAND, 1, L - 1
    lag_f, strength, valid, _, _ = plan_candidates(r, k, lo, hi, VTH)
    lag_j, str_j, val_j = (np.asarray(a) for a in jpk.topk_parabolic(jnp.asarray(r), k, lo, hi, VTH, interpret=True))
    np.testing.assert_array_equal(valid.astype(bool), val_j)
    np.testing.assert_allclose(lag_f, lag_j, rtol=0, atol=TOL_A)
    np.testing.assert_allclose(strength, str_j, rtol=0, atol=TOL_A)


# ---------------------------------------------------------------------------
# kernel E
# ---------------------------------------------------------------------------


def source_of(lane, j, s):
    """Step s of kernel E: (source lane, source register) that the value
    added to lane ``lane``'s register j comes from, or None where column
    l + 32 j < s adds 0.0."""
    if s < WARP:
        m = (lane - s) % WARP
        reg = j if m < WARP - s else j - 1
        return None if reg < 0 else (m, reg)
    t = s // WARP
    return None if j < t else (lane, j - t)


def plan_chunk_cumsum(x):
    """Kernel E's schedule on x [R, C] float32: acc[chunk, lane, j] holds
    column lane + 32 j; registers updated from j = 31 down."""
    R, C = x.shape
    f32 = np.float32
    lane = np.arange(WARP)
    v = x.reshape(-1, WARP, WARP).transpose(0, 2, 1).copy()  # [chunk, lane, j]
    acc = v.copy()
    for b in range(5):  # steps 1..16: one shuffle a register
        s = 1 << b
        for j in range(WARP - 1, -1, -1):
            send = np.where(lane < WARP - s, acc[:, :, j], acc[:, :, max(j - 1, 0)])
            got = send[:, (lane - s) % WARP]
            acc[:, :, j] = acc[:, :, j] + np.where((j == 0) & (lane < s), f32(0), got)
    for b in range(5):  # steps 32..512: register j − t of the same lane
        t = 1 << b
        for j in range(WARP - 1, -1, -1):
            acc[:, :, j] = acc[:, :, j] + (acc[:, :, j - t] if j >= t else f32(0))
    return (acc - v).transpose(0, 2, 1).reshape(R, C)


def test_chunk_cumsum_source_lane_rule():
    """Each step's source (lane, register) holds column c − s of the
    destination's column c, every destination is fed once, and a source
    lane sends one register per shuffle."""
    for s in [1 << b for b in range(10)]:
        fed = set()
        for j in range(WARP):
            sent = {}
            for lane in range(WARP):
                c = lane + WARP * j
                src = source_of(lane, j, s)
                if c < s:
                    assert src is None or s < WARP and j == 0
                    continue
                m, reg = src
                assert m + WARP * reg == c - s
                assert sent.setdefault(m, reg) == reg
                fed.add(c)
        assert fed == set(range(s, 1024))


def _cumsum_inputs(kind, R, C, seed):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=(R, C)).astype(np.float32)
    if kind == "squared":
        return np.square(rng.normal(size=(R, C))).astype(np.float32)
    # cancelling: large values of both signs that sum to near zero, with
    # exact ±0.0 (the ladder's adds of 0.0 turn −0.0 into +0.0)
    x = (rng.choice([-1.0, 1.0], size=(R, C)) * 1e8 + rng.normal(size=(R, C))).astype(np.float32)
    x[:, 1::2] = -x[:, 0::2]
    x[:, 2::7] = -0.0
    x[:, 3::11] = 0.0
    return x


@pytest.mark.parametrize("kind", ["normal", "squared", "cancelling"])
def test_chunk_cumsum_plan_equals_plain_and_jax(kind):
    x = _cumsum_inputs(kind, 8, 3 * 1024, seed=len(kind))
    got = plan_chunk_cumsum(x)
    want = tcc.chunk_cumsum_plain(torch.from_numpy(x)).numpy()
    assert got.tobytes() == want.tobytes()
    want_j = np.asarray(jpk.chunk_cumsum(jnp.asarray(x), interpret=True))
    assert got.tobytes() == want_j.tobytes()
