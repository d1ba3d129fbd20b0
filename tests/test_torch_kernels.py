"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with a card and without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py -q

Here, without a card, the gpu-marked cases skip; the plain versions'
own contracts (tie order, padding) are checked on the CPU.
"""

import numpy as np
import pytest
import torch

from prosody_control_french_tts_tpu_torch.ops import (
    candidates, chunk_cumsum, ctc_loss, ctc_viterbi, decode_attn, flash_attention, frames, fused_ce, mask_ema, viterbi, vmem_attn,
)

K_CAND, MIN_LAG, MAX_LAG, VTH = 14, 72, 295, 0.45


@pytest.fixture
def cuda():
    """Decided inside the test: the kernel cases need a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def candidate_fixtures(seed):
    """Adversarial r rows (the JAX package's kernel fixtures): oscillatory
    rows with many maxima, flat rows with none, sparse rows with fewer than
    k, and quantised random rows with exact value ties."""
    rng = np.random.default_rng(seed)
    F, L = 96, 297
    t = np.arange(L, dtype=np.float32)
    rows = []
    for i in range(F):
        kind = i % 4
        if kind == 0:
            rows.append(0.8 * np.cos(2 * np.pi * t / (6 + i % 5)) + 0.1)
        elif kind == 1:
            rows.append(np.full(L, 0.01, np.float32))
        elif kind == 2:
            row = np.zeros(L, np.float32)
            for pk in (80, 140, 230):
                row[pk] = 0.9 - 0.1 * (pk / 100.0)
                row[pk - 1] = row[pk + 1] = 0.3
            rows.append(row)
        else:
            rows.append(np.round(rng.normal(size=L).astype(np.float32), 1) * 0.5)
    return np.stack(rows).astype(np.float32)


# kernel A's per-lane register counts P = ceil(L / 32): one L for each
# instantiation (P 1..32), with the edges 3, 32, 33, 297 (the measure path's),
# 512, 591 and 738 (the corpus features' and the eval contour's lags at
# 44.1 kHz, pitch floors 75 and 60 Hz) and 1024
CAND_LENGTHS = (3, 27, 32, 33, 64, 65, 127, 128, 129, 160, 192, 224, 256, 288, 297, 320, 352, 384, 416, 448, 480, 511,
                512, 544, 576, 591, 640, 672, 704, 738, 768, 800, 832, 864, 896, 928, 960, 992, 1023, 1024)


def maxima_counts(L, k):
    """The row kinds of kernel A's tests: rows with 0, 1, k − 1, k, k + 1,
    32 and 33 local maxima, and as many as interior lags [1, L − 1) hold
    (every other lag: (L − 1) // 2, about L/2), each capped at that most."""
    most = (L - 1) // 2
    return [min(m, most) for m in (0, 1, max(k - 1, 0), k, k + 1, 32, 33, most)]


def maxima_rows(L, k, seed):
    """r [2 · 8, L]: for each of :func:`maxima_counts`, a row with exactly
    that many local maxima above the voicing threshold at odd lags of
    [1, L − 1) (min_lag 1, max_lag L − 1), on a floor below it; once with
    distinct peak values, once with peaks from three levels, so that exact
    ties straddle the 32-entry rounds of the kernel's rank."""
    rng = np.random.default_rng(seed)
    odd = np.arange(1, L - 1, 2)
    rows = []
    for m in maxima_counts(L, k):
        for ties in (False, True):
            row = rng.uniform(0.0, 0.2, L).astype(np.float32)  # below 0.5 * VTH: no maxima
            lags = np.sort(rng.choice(odd, size=m, replace=False)) if m else odd[:0]
            if ties:
                row[lags] = rng.choice(np.array([0.5, 0.7, 0.9], np.float32), size=m)
            else:
                row[lags] = rng.uniform(0.3, 1.0, m).astype(np.float32)
            rows.append(row)
    return np.stack(rows)


def random_viterbi_inputs(seed, S=3, F=50, K=15):
    """δ, lf, voiced, freq [S, F, K] with unvoiced candidate 0, random
    unvoiced entries and candidates above the ceiling."""
    rng = np.random.default_rng(seed)
    freq = rng.uniform(80.0, 700.0, size=(S, F, K)).astype(np.float32)
    freq[..., 0] = 0.0
    freq[rng.random((S, F, K)) < 0.2] = 0.0
    delta = rng.normal(size=(S, F, K)).astype(np.float32)
    voiced = (freq > 0) & (freq <= 600.0)
    lf = np.log2(np.maximum(freq, 1e-6)).astype(np.float32)
    return delta, lf, voiced, freq


def tie_viterbi_inputs(seed, S, F, K):
    """Tie-heavy δ, lf, voiced, freq [S, F, K]: frequencies are powers of two
    (0 and 1,024 Hz unvoiced), so jump costs are exact multiples of the jump
    cost, and δ takes four values, -inf among them (ties at -inf)."""
    rng = np.random.default_rng(seed)
    freq = rng.choice(np.array([0, 64, 128, 256, 512, 1024], np.float32), size=(S, F, K))
    delta = rng.choice(np.array([-np.inf, 0.0, 0.5, 1.0], np.float32), size=(S, F, K), p=[0.1, 0.3, 0.3, 0.3])
    voiced = (freq > 0) & (freq <= 600.0)
    lf = np.log2(np.maximum(freq, 1e-6)).astype(np.float32)
    return delta, lf, voiced, freq


def test_candidates_tie_order_and_padding():
    """Exact ties go to the smallest lag; rows with fewer maxima than k are
    zero-padded with valid False."""
    L = 40
    r = np.zeros((2, L), np.float32)
    for lag in (10, 20, 30):  # three equal peaks
        r[0, lag] = 0.8
    r[1, 12] = 0.9
    lag_f, strength, valid = candidates.topk_parabolic(torch.from_numpy(r), 4, 2, L - 2, 0.45)
    np.testing.assert_array_equal(valid.numpy(), [[1, 1, 1, 0], [1, 0, 0, 0]])
    np.testing.assert_array_equal(lag_f.numpy()[0], [10, 20, 30, 0])
    np.testing.assert_array_equal(strength.numpy()[1, 1:], 0)


def test_library_builds_and_loads_once_under_concurrent_first_calls(monkeypatch):
    """Threads that reach ``kernels.library`` together (the viewer's preload
    pool) wait for one build and one load, and all get the same library."""
    import ctypes
    import sys
    import threading
    import time

    from prosody_control_french_tts_tpu_torch.ops import kernels

    builds, loads = [], []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.05)  # long enough for every thread to arrive meanwhile
        return "libpcft_kernels_stub.so"

    class FakeLib:
        def __getattr__(self, name):
            f = type("FakeFn", (), {})()
            setattr(self, name, f)
            return f

    def fake_cdll(path):
        loads.append(path)
        return FakeLib()

    monkeypatch.setattr(kernels, "_LIB", None)
    monkeypatch.setattr(kernels, "build", slow_build)
    monkeypatch.setattr(ctypes, "CDLL", fake_cdll)
    n = 16
    barrier = threading.Barrier(n)
    got = [None] * n

    def first_call(i):
        barrier.wait(timeout=30)
        got[i] = kernels.library()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_call, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and loads == ["libpcft_kernels_stub.so"]
    assert got[0] is not None and all(g is got[0] for g in got)
    assert got[0].pitch_candidates_launch.restype is ctypes.c_int
    assert kernels.library() is got[0] and len(builds) == 1


def test_viterbi_plain_padding_lanes_never_win():
    """Unvoiced picks come out as 0 Hz, voiced picks as one of the frame's
    voiced candidates."""
    delta, lf, voiced, freq = random_viterbi_inputs(2)
    f0 = viterbi.viterbi_path_plain(*(torch.from_numpy(a) for a in (delta, lf, voiced, freq)), 0.14, 0.35).numpy()
    assert f0.shape == (3, 50)
    ok = (f0 == 0) | np.any((freq == f0[..., None]) & voiced, axis=-1)
    assert ok.all()


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [5, 6])
def test_candidates_kernel_matches_plain(cuda, seed):
    """On the card: lag_f and strength within 1e-6, valid equal."""
    r = torch.from_numpy(candidate_fixtures(seed)).to(cuda)
    got = candidates.topk_parabolic(r, K_CAND, MIN_LAG, MAX_LAG, VTH)
    want = candidates.topk_parabolic_plain(r, K_CAND, MIN_LAG, MAX_LAG, VTH)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, K_CAND, 40])
@pytest.mark.parametrize("L", CAND_LENGTHS)
def test_candidates_kernel_on_maxima_rows(cuda, L, k):
    """Every per-lane instantiation (P 1..32), rows with 0 .. (L − 1) // 2
    maxima (the rank's overflow rounds past 32) and exact ties across the
    rounds: valid equal, lag_f and strength within 1e-6."""
    r = torch.from_numpy(maxima_rows(L, k, seed=L * 100 + k)).to(cuda)
    got = candidates.topk_parabolic(r, k, 1, L - 1, VTH)
    want = candidates.topk_parabolic_plain(r, k, 1, L - 1, VTH)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_candidates_kernel_at_the_measure_shape(cuda):
    """[47,150, 297], k 14, the measure path's lags: the fixture rows and the
    maxima rows tiled, each tile scaled by its own factor."""
    base = np.concatenate([candidate_fixtures(8), maxima_rows(297, K_CAND, seed=9)])
    reps = -(-47150 // base.shape[0])
    scale = np.random.default_rng(10).uniform(0.5, 1.0, reps).astype(np.float32)
    r = (np.tile(base, (reps, 1)) * np.repeat(scale, base.shape[0])[:, None])[:47150]
    r = torch.from_numpy(np.ascontiguousarray(r, np.float32)).to(cuda)
    got = candidates.topk_parabolic(r, K_CAND, MIN_LAG, MAX_LAG, VTH)
    want = candidates.topk_parabolic_plain(r, K_CAND, MIN_LAG, MAX_LAG, VTH)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)


VITERBI_SHAPES = [
    (5, 400, 15), (2, 1, 15), (3, 37, 32), (1, 20, 1),
    (2, 2, 15), (3, 17, 16), (2, 65, 16), (2, 129, 17), (2, 17, 32), (10, 4715, 15),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", VITERBI_SHAPES)
def test_viterbi_kernel_matches_plain(cuda, shape):
    """On the card: f0 equal in every frame, K from 1 to 32 (both
    instantiations), F = 1, 2, tiles of frames partly filled, and the
    measure voice's [10, 4,715, 15]."""
    S, F, K = shape
    args = [torch.from_numpy(a).to(cuda) for a in random_viterbi_inputs(4, S=S, F=F, K=K)]
    got = viterbi.viterbi_path(*args, 0.14 * 0.5, 0.35 * 0.5)
    want = viterbi.viterbi_path_plain(*args, 0.14 * 0.5, 0.35 * 0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 40, 1), (3, 40, 15), (2, 70, 16), (2, 33, 32), (2, 1, 15), (2, 2, 32)])
def test_viterbi_kernel_keeps_the_first_argmax_on_ties(cuda, shape):
    """On the card, tie-heavy inputs (exact ties, ties at -inf): the kernel's
    argmax tree takes the first index of every max, as the plain version's
    torch.argmax does; f0 equal in every frame, twice."""
    S, F, K = shape
    args = [torch.from_numpy(a).to(cuda) for a in tie_viterbi_inputs(7, S, F, K)]
    want = viterbi.viterbi_path_plain(*args, 0.14, 0.35)
    for _ in range(2):
        torch.testing.assert_close(viterbi.viterbi_path(*args, 0.14, 0.35), want, rtol=0, atol=0)


def decode_attn_inputs(B, H, KV, hd, S, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).to(device, dtype)
    kc = torch.from_numpy(rng.standard_normal((B, S, KV * hd)).astype(np.float32)).to(device, dtype)
    vc = torch.from_numpy(rng.standard_normal((B, S, KV * hd)).astype(np.float32)).to(device, dtype)
    return q, kc, vc


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "geom",
    [
        (4, 14, 2, 64, 96, (0, 1, 50, 95)),  # the bench geometry's head, group 7
        (3, 28, 4, 128, 192, (0, 100, 191)),  # the 7B geometry's head, group 7
        (2, 4, 1, 64, 48, (30,)),  # one KV head
        (1, 8, 1, 128, 700, (0, 5, 699)),  # group 8, many passes of the block
        (2, 10, 2, 64, 77, (31, 32, 76)),  # group 5, row counts around a pass's edge
        (2, 6, 6, 64, 33, (32,)),  # group 1
        (1, 7, 1, 128, 40, (0, 1, 3, 6, 39)),  # 8 blocks a cluster: pos with fewer live rows than blocks
        (1, 8, 1, 64, 20, (0, 2, 7, 19)),  # the same at hd 64, group 8
        (16, 28, 4, 128, 192, (64, 190)),  # the 7B serving shape
        (64, 14, 2, 64, 320, (64, 318)),  # the bench serving shape
    ],
)
def test_decode_attn_kernel_matches_plain(cuda, geom, dtype, tol):
    """On the card: kernel F within 2e-5 (float32) / 2e-2 (bfloat16) of its
    plain version, for group sizes that are no power of two, both head
    dims, pos = 0 and pos = S - 1."""
    B, H, KV, hd, S, positions = geom
    q, kc, vc = decode_attn_inputs(B, H, KV, hd, S, dtype, cuda)
    for pos in positions:
        got = decode_attn.decode_attention(q, kc, vc, pos, KV)
        torch.cuda.synchronize()
        want = decode_attn.decode_attention_plain(q, kc, vc, pos, KV)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_decode_attn_kernel_ignores_future_rows(cuda):
    """Rows beyond pos set to +-1e4 change nothing, bit for bit; pos = 0
    returns the first V row per KV head."""
    q, kc, vc = decode_attn_inputs(4, 14, 2, 64, 32, torch.float32, cuda)
    base = decode_attn.decode_attention(q, kc, vc, 10, 2)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[:, 11:] = 1e4
    vc2[:, 11:] = -1e4
    assert torch.equal(base, decode_attn.decode_attention(q, kc2, vc2, 10, 2))
    first = decode_attn.decode_attention(q, kc, vc, 0, 2)
    want = vc[:, 0].reshape(4, 2, 1, 64).expand(4, 2, 7, 64).reshape(4, 14, 64)
    torch.testing.assert_close(first, want, rtol=2e-6, atol=2e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("geom", [(16, 28, 4, 128, 192, 190), (64, 14, 2, 64, 320, 100), (1, 8, 1, 128, 40, 5)])
def test_decode_attn_bfloat16_is_deterministic_and_ignores_future_rows(cuda, geom):
    """bfloat16, clusters of several blocks: two calls give the same bits, and
    rows beyond pos set to +-1e4 change nothing."""
    B, H, KV, hd, S, pos = geom
    q, kc, vc = decode_attn_inputs(B, H, KV, hd, S, torch.bfloat16, cuda, seed=3)
    base = decode_attn.decode_attention(q, kc, vc, pos, KV)
    assert torch.equal(base, decode_attn.decode_attention(q, kc, vc, pos, KV))
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[:, pos + 1 :] = 1e4
    vc2[:, pos + 1 :] = -1e4
    assert torch.equal(base, decode_attn.decode_attention(q, kc2, vc2, pos, KV))


@pytest.mark.gpu
def test_decode_attn_wrapper_counts_and_checks(cuda):
    q, kc, vc = decode_attn_inputs(2, 14, 2, 64, 16, torch.bfloat16, cuda)
    n = decode_attn.launches
    decode_attn.decode_attention(q, kc, vc, 5, 2)
    assert decode_attn.launches == n + 1
    with pytest.raises(TypeError):
        decode_attn.decode_attention(q.half(), kc.half(), vc.half(), 5, 2)
    with pytest.raises(TypeError):
        decode_attn.decode_attention(q, kc.float(), vc, 5, 2)
    with pytest.raises(ValueError):
        decode_attn.decode_attention(q, kc.transpose(0, 1).contiguous().transpose(0, 1), vc, 5, 2)
    q32 = torch.zeros((2, 4, 32), device=cuda)
    c32 = torch.zeros((2, 16, 64), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        decode_attn.decode_attention(q32, c32, c32, 5, 2)
    assert decode_attn.launches == n + 1


@pytest.mark.gpu
def test_wrappers_count_launches_and_check_arguments(cuda):
    """Each kernel launch adds one to its wrapper's count; what the kernels
    do not take raises."""
    r = torch.from_numpy(candidate_fixtures(1)).to(cuda)
    n = candidates.launches
    candidates.topk_parabolic(r, K_CAND, MIN_LAG, MAX_LAG, VTH)
    assert candidates.launches == n + 1
    with pytest.raises(TypeError):
        candidates.topk_parabolic(r.double(), K_CAND, MIN_LAG, MAX_LAG, VTH)
    with pytest.raises(ValueError):
        candidates.topk_parabolic(r.t(), K_CAND, MIN_LAG, MAX_LAG, VTH)
    with pytest.raises(ValueError, match="exceeds the kernel's 1024 lags"):
        candidates.topk_parabolic(torch.zeros((2, 1025), device=cuda), K_CAND, MIN_LAG, MAX_LAG, VTH)
    args = [torch.from_numpy(a).to(cuda) for a in random_viterbi_inputs(0, K=33)]
    with pytest.raises(ValueError):
        viterbi.viterbi_path(*args, 0.1, 0.2)


# ---------------------------------------------------------------------------
# kernels G (causal attention) and H (fused linear cross-entropy)
# ---------------------------------------------------------------------------


def vmem_attn_inputs(B, L, H, KV, hd, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)  # noqa: E731
    return mk(B, L, H, hd), mk(B, L, KV, hd), mk(B, L, KV, hd), mk(B, L, H, hd)


def _attn_grads(fn, q, k, v, dout, scale):
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v, scale)
    out.backward(dout)
    return out.detach(), q.grad, k.grad, v.grad


VMEM_GEOMS = [
    (2, 256, 4, 2, 64),  # the CPU tests' shape
    (1, 512, 14, 2, 64),  # the bench geometry's heads, group 7, longest L
    (1, 512, 28, 4, 128),  # the 7B geometry's heads
    (3, 128, 6, 6, 128),  # group 1, shortest L of the model's dispatch
    (2, 96, 8, 1, 64),  # one KV head, L a multiple of 32 only
]


@pytest.mark.gpu
@pytest.mark.parametrize("geom", VMEM_GEOMS)
def test_vmem_attn_kernel_matches_plain_float32(cuda, geom):
    """On the card, float32: forward within 2e-5, dq/dk/dv within 1e-5 of the
    largest element of the plain version's gradient (autograd)."""
    B, L, H, KV, hd = geom
    q, k, v, dout = vmem_attn_inputs(B, L, H, KV, hd, torch.float32, cuda)
    scale = hd**-0.5
    got = _attn_grads(vmem_attn.causal_attention_vmem, q, k, v, dout, scale)
    torch.cuda.synchronize()
    want = _attn_grads(vmem_attn.causal_attention_vmem_plain, q, k, v, dout, scale)
    torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


VMEM_GEOMS_BF16 = VMEM_GEOMS + [
    (8, 512, 14, 2, 64),  # the bench training shape
    (2, 512, 14, 2, 128),  # hd 128 with group 7
]


@pytest.mark.gpu
@pytest.mark.parametrize("geom", VMEM_GEOMS_BF16)
def test_vmem_attn_kernel_matches_plain_bfloat16(cuda, geom):
    """On the card, bfloat16 (the tensor-core kernels; L 96 ends in a ragged
    64-row tile): forward within 5e-2 (one rounding of an output of magnitude
    up to ~4 is 1.6e-2); gradients within 3e-2 of the largest element: the
    kernel rounds ds and p to bfloat16 before its products as the TPU kernel
    does, autograd of the plain version rounds only p in the forward and every
    intermediate result instead."""
    B, L, H, KV, hd = geom
    q, k, v, dout = vmem_attn_inputs(B, L, H, KV, hd, torch.bfloat16, cuda, seed=1)
    scale = hd**-0.5
    got = _attn_grads(vmem_attn.causal_attention_vmem, q, k, v, dout, scale)
    torch.cuda.synchronize()
    want = _attn_grads(vmem_attn.causal_attention_vmem_plain, q, k, v, dout, scale)
    assert got[0].dtype == torch.bfloat16
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=0, atol=5e-2)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert float((g.float() - w.float()).abs().max()) <= 3e-2 * float(w.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("geom", [(2, 512, 28, 4, 128), (2, 96, 8, 1, 64)])
def test_vmem_attn_bfloat16_backward_is_deterministic(cuda, geom):
    """Two backward runs on the same inputs give bit-equal dq, dk and dv (no
    atomics: the group's dk/dv partials are summed in head order)."""
    B, L, H, KV, hd = geom
    q, k, v, dout = vmem_attn_inputs(B, L, H, KV, hd, torch.bfloat16, cuda, seed=3)
    first = _attn_grads(vmem_attn.causal_attention_vmem, q, k, v, dout, hd**-0.5)
    second = _attn_grads(vmem_attn.causal_attention_vmem, q, k, v, dout, hd**-0.5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_vmem_attn_kernel_is_causal_and_counts(cuda):
    """Perturbing the last key/value row moves only the last query row, bit
    for bit; each forward and each backward adds one to its own count; what
    the kernel does not take raises and counts nothing."""
    q, k, v, dout = vmem_attn_inputs(2, 128, 4, 2, 64, torch.float32, cuda, seed=5)
    n_f, n_b = vmem_attn.launches, vmem_attn.launches_bwd
    out0 = vmem_attn.causal_attention_vmem(q, k, v, 0.125)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1] += 3.0
    v2[:, -1] += 3.0
    out1 = vmem_attn.causal_attention_vmem(q, k2, v2, 0.125)
    assert torch.equal(out0[:, :-1], out1[:, :-1])
    assert float((out0[:, -1] - out1[:, -1]).abs().max()) > 1e-3
    assert (vmem_attn.launches, vmem_attn.launches_bwd) == (n_f + 2, n_b)
    _attn_grads(vmem_attn.causal_attention_vmem, q, k, v, dout, 0.125)
    assert (vmem_attn.launches, vmem_attn.launches_bwd) == (n_f + 3, n_b + 1)
    with pytest.raises(TypeError):
        vmem_attn.causal_attention_vmem(q.half(), k.half(), v.half(), 0.125)
    with pytest.raises(TypeError):
        vmem_attn.causal_attention_vmem(q, k.bfloat16(), v, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        vmem_attn.causal_attention_vmem(q[..., :32], k[..., :32], v[..., :32], 0.125)
    with pytest.raises(ValueError, match="multiple"):
        vmem_attn.causal_attention_vmem(q[:, :100], k[:, :100], v[:, :100], 0.125)
    with pytest.raises(ValueError, match="MAX_L"):
        big = torch.zeros((1, 640, 4, 64), device=cuda)
        vmem_attn.causal_attention_vmem(big, big[:, :, :2], big[:, :, :2], 0.125)
    assert (vmem_attn.launches, vmem_attn.launches_bwd) == (n_f + 3, n_b + 1)


def flash_inputs(B, H, L, hd, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, H, L, hd)).astype(np.float32)).to(device, dtype) for _ in range(4)]


def _flash(q, k, v, scale):
    return flash_attention.flash_attention(q, k, v, sm_scale=scale)


def _flash_plain(q, k, v, scale):
    return flash_attention.flash_attention_plain(q, k, v, scale)


FLASH_GEOMS = [
    (1, 3, 128, 64),  # one tile: the upstream single-step shape; B·H odd
    (3, 1, 768, 64),  # the bench geometry's L: 12 tiles of 64, not a power of two
    (1, 5, 1024, 128),  # stage A's L at the 7B head dim
    (1, 3, 2048, 128),  # twice stage A's L
    (2, 7, 384, 128),
]


def _row_err(got, want, floor=1e-3):
    """The largest row error over its scale: |got - want| / (|want| + floor *
    the largest |want|), |.| the 2-norm of a row of hd values."""
    d = (got.float() - want.float()).norm(dim=-1)
    n = want.float().norm(dim=-1)
    return float((d / (n + floor * n.max()).clamp_min(1e-30)).max())


def _err_over_plain(got, want, ref):
    """The largest over (b, h) of |got - ref| / |want - ref|, |.| the 2-norm
    over L x hd: the kernel's error against the float32 reference over the
    plain version's own."""
    d = (got.float() - ref).flatten(2).norm(dim=-1)
    n = (want.float() - ref).flatten(2).norm(dim=-1)
    return float((d / n.clamp_min(1e-30)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", FLASH_GEOMS)
def test_flash_attention_kernel_matches_plain(cuda, geom, dtype):
    """On the card. bfloat16 (tensor cores): the output within 2^-6 row by
    row (``_row_err``): p is rounded against the running max of 64-key tiles,
    not of the plain version's 128-key tiles, and the output rounds once more,
    each about 2^-9 relative and independent over the keys, so a row's error
    is a fixed share of the row at any L; a key tile dropped from a row of n
    keys moves it by about 8 / sqrt(n) (0.18 at n 2,048). dq, dk, dv: their
    error against the plain version in float32 on the same inputs at most
    twice the plain bf16 version's own, per (b, h) (``_err_over_plain``; the
    roundings of di and ds make dq's error a large share of dq where keys
    share a large part, in both versions). float32 (CUDA cores), kernel G's
    limits: the forward within 2e-5 and dq/dk/dv within 1e-5 of the plain
    gradient's largest element (sum order and expf only; 2e-5 is 2.5e3 times
    below a row's |o| at L 1,024, and dq's first rows are near zero by
    cancellation, so a row measure would read float32's rounding there)."""
    B, H, L, hd = geom
    q, k, v, dout = flash_inputs(B, H, L, hd, dtype, cuda, seed=L + hd)
    scale = hd**-0.5
    got = _attn_grads(_flash, q, k, v, dout, scale)
    torch.cuda.synchronize()
    want = _attn_grads(_flash_plain, q, k, v, dout, scale)
    ref = _attn_grads(_flash_plain, q.float(), k.float(), v.float(), dout.float(), scale)
    assert got[0].dtype == dtype and bool(torch.isfinite(got[0]).all())
    if dtype == torch.bfloat16:
        assert _row_err(got[0], want[0]) <= 2**-6
    else:
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=2e-5)
    for g, w, r in zip(got[1:], want[1:], ref[1:]):
        assert g.dtype == dtype and g.shape == w.shape and bool(torch.isfinite(g).all())
        if dtype == torch.bfloat16:
            assert _err_over_plain(g, w, r) <= 2.0
        else:
            assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", [(2, 28, 1024, 128), (1, 3, 768, 64)])
def test_flash_attention_backward_is_deterministic(cuda, geom, dtype):
    """Two backward runs on the same inputs give bit-equal dq, dk and dv: dq by
    query tile and dk/dv by key tile, no atomics."""
    B, H, L, hd = geom
    q, k, v, dout = flash_inputs(B, H, L, hd, dtype, cuda, seed=3)
    first = _attn_grads(_flash, q, k, v, dout, hd**-0.5)
    second = _attn_grads(_flash, q, k, v, dout, hd**-0.5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_attention_kernel_is_causal_counts_and_checks(cuda):
    """Changing the last 128 keys and values leaves every earlier output row
    bit-equal; each forward and each backward adds one to its own count; what
    the kernel does not take (hd 32, L not a multiple of 128, float16, mixed
    dtypes or devices) raises and counts nothing."""
    q, k, v, dout = flash_inputs(2, 3, 384, 64, torch.bfloat16, cuda, seed=5)
    n_f, n_b = flash_attention.launches, flash_attention.launches_bwd
    out0 = _flash(q, k, v, 0.125)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, -128:] += 3.0
    v2[:, :, -128:] -= 2.0
    out1 = _flash(q, k2, v2, 0.125)
    assert torch.equal(out0[:, :, :256], out1[:, :, :256])
    assert float((out0[:, :, -1] - out1[:, :, -1]).float().abs().max()) > 1e-2
    assert (flash_attention.launches, flash_attention.launches_bwd) == (n_f + 2, n_b)
    _attn_grads(_flash, q, k, v, dout, 0.125)
    assert (flash_attention.launches, flash_attention.launches_bwd) == (n_f + 3, n_b + 1)
    with pytest.raises(ValueError, match="head dim"):
        _flash(q[..., :32], k[..., :32], v[..., :32], 0.125)
    with pytest.raises(ValueError, match="multiple of 128"):
        _flash(q[:, :, :320], k[:, :, :320], v[:, :, :320], 0.125)
    with pytest.raises(TypeError):
        _flash(q.half(), k.half(), v.half(), 0.125)
    with pytest.raises(TypeError):
        _flash(q, k.float(), v, 0.125)
    with pytest.raises(ValueError, match="is on"):
        _flash(q, k.cpu(), v, 0.125)
    assert (flash_attention.launches, flash_attention.launches_bwd) == (n_f + 3, n_b + 1)


def _flash_gqa(q, k, v, scale):
    return flash_attention.flash_attention_gqa(q, k, v, scale)


def flash_gqa_inputs(B, H, KVH, L, hd, dtype, device, seed=0, packed=False):
    """q, dout [B, L, H, hd] and k, v [B, L, KVH, hd]; ``packed``: q, k, v
    are slices of one [B, L, (H + 2 KVH) hd] tensor, as the model's fused
    q|k|v projection gives them (strided rows, read in place)."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)  # noqa: E731
    if packed:
        qkv = mk(B, L, (H + 2 * KVH) * hd)
        q = qkv[..., : H * hd].unflatten(-1, (H, hd))
        k = qkv[..., H * hd : (H + KVH) * hd].unflatten(-1, (KVH, hd))
        v = qkv[..., (H + KVH) * hd :].unflatten(-1, (KVH, hd))
    else:
        q, k, v = mk(B, L, H, hd), mk(B, L, KVH, hd), mk(B, L, KVH, hd)
    return q, k, v, mk(B, L, H, hd)


def _err_over_plain_heads(got, want, ref):
    """_err_over_plain on the model's layout [B, L, heads, hd]: per (b, head)."""
    return _err_over_plain(got.transpose(1, 2), want.transpose(1, 2), ref.transpose(1, 2))


# (B, H, KV heads, L, hd): groups 1, 2 and 7 (Qwen's 28 / 4 and the bench's
# 14 / 2), L 128 and 2048, both head dims, the 7B layer
FLASH_GQA_GEOMS = [
    (1, 3, 3, 128, 64),
    (2, 4, 2, 128, 128),
    (1, 7, 1, 2048, 64),
    (1, 14, 2, 2048, 128),
    (2, 28, 4, 1024, 128),
    (3, 14, 2, 768, 64),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", FLASH_GQA_GEOMS)
def test_flash_attention_gqa_kernel_matches_plain(cuda, geom, dtype):
    """On the card, the model's entry (K/V read at KVH heads, the group's dk
    and dv summed in the kernels) against its plain composition, at the
    limits of test_flash_attention_kernel_matches_plain: bf16 forward row by
    row within 2^-6, bf16 gradients within twice the plain bf16 version's own
    error per (b, head) (query heads for dq, KV heads for dk and dv); float32
    forward within 2e-5, gradients within 1e-5 of the largest element."""
    B, H, KVH, L, hd = geom
    q, k, v, dout = flash_gqa_inputs(B, H, KVH, L, hd, dtype, cuda, seed=L + hd + H)
    scale = hd**-0.5
    got = _attn_grads(_flash_gqa, q, k, v, dout, scale)
    torch.cuda.synchronize()
    want = _attn_grads(flash_attention.flash_attention_gqa_plain, q, k, v, dout, scale)
    ref = _attn_grads(flash_attention.flash_attention_gqa_plain, q.float(), k.float(), v.float(), dout.float(), scale)
    assert got[0].dtype == dtype and got[0].shape == q.shape and bool(torch.isfinite(got[0]).all())
    if dtype == torch.bfloat16:
        assert _row_err(got[0], want[0]) <= 2**-6
    else:
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=2e-5)
    for g, w, r in zip(got[1:], want[1:], ref[1:]):
        assert g.dtype == dtype and g.shape == w.shape and bool(torch.isfinite(g).all())
        if dtype == torch.bfloat16:
            assert _err_over_plain_heads(g, w, r) <= 2.0
        else:
            assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gqa_reads_packed_qkv_in_place(cuda, dtype):
    """q, k, v as slices of one fused q|k|v tensor (rows (H + 2 KVH) hd
    apart, the model's fused_qkv layout) give the same bits as contiguous
    copies, forward and backward, and the backward is bit-equal twice."""
    q, k, v, dout = flash_gqa_inputs(2, 14, 2, 768, 64, dtype, cuda, seed=9, packed=True)
    assert not v.is_contiguous()
    got = _attn_grads(_flash_gqa, q, k, v, dout, 0.125)
    want = _attn_grads(_flash_gqa, q.contiguous(), k.contiguous(), v.contiguous(), dout, 0.125)
    again = _attn_grads(_flash_gqa, q, k, v, dout, 0.125)
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.gpu
def test_flash_attention_gqa_counts_and_checks(cuda):
    """Each forward and each backward of the model's entry adds one to the
    same counts as the upstream entry; what the kernels do not take (hd 32,
    H not a multiple of KVH, L 320, float16, a stride TMA refuses) raises and
    counts nothing."""
    q, k, v, dout = flash_gqa_inputs(1, 4, 2, 384, 64, torch.bfloat16, cuda, seed=4)
    n_f, n_b = flash_attention.launches, flash_attention.launches_bwd
    _attn_grads(_flash_gqa, q, k, v, dout, 0.125)
    assert (flash_attention.launches, flash_attention.launches_bwd) == (n_f + 1, n_b + 1)
    with pytest.raises(ValueError, match="head dim"):
        _flash_gqa(q[..., :32], k[..., :32], v[..., :32], 0.125)
    with pytest.raises(ValueError, match="multiple of 2 KV heads"):
        _flash_gqa(q[:, :, :3], k, v, 0.125)
    with pytest.raises(ValueError, match="multiple of 128"):
        _flash_gqa(q[:, :320], k[:, :320], v[:, :320], 0.125)
    with pytest.raises(TypeError):
        _flash_gqa(q.half(), k.half(), v.half(), 0.125)
    wide = torch.zeros((1, 256, 2, 68), device=cuda, dtype=torch.bfloat16)[..., :64]  # rows 136 elements apart: not 16-byte multiples
    with pytest.raises(ValueError, match="TMA"):
        _flash_gqa(torch.zeros((1, 256, 4, 68), device=cuda, dtype=torch.bfloat16)[..., :64], wide, wide, 0.125)
    assert (flash_attention.launches, flash_attention.launches_bwd) == (n_f + 1, n_b + 1)


def fused_ce_inputs(N, D, V, dtype, device, seed=1, spread=1.0):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy((rng.standard_normal((N, D)) * 0.3 * spread).astype(np.float32)).to(device, dtype)
    w = torch.from_numpy((rng.standard_normal((D, V)) * 0.05 * spread).astype(np.float32)).to(device, dtype)
    tgt = torch.from_numpy(rng.integers(0, V, N).astype(np.int32)).to(device)
    g = torch.from_numpy((rng.random(N) > 0.3).astype(np.float32)).to(device)
    return h, w, tgt, g / g.sum()


def _ce_grad(fn, h, w, tgt, g):
    h = h.detach().clone().requires_grad_(True)
    nll = fn(h, w, tgt)
    nll.backward(g)
    return nll.detach(), h.grad


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape",
    [
        (300, 256, 1024),  # the CPU tests' shape: a ragged row tile
        (8, 128, 512),  # the smallest the gate admits
        (100, 256, 1024),
        (256, 256, 1024),
        (515, 384, 9216),  # two backward chunks (8192 + 1024), five row tiles
    ],
)
def test_fused_ce_kernel_matches_plain_float32(cuda, shape):
    """On the card, float32: rows within 1e-5, dh within 1e-5 of its largest
    element, for row counts that fill no tile and a vocabulary that spans
    more than one backward chunk."""
    N, D, V = shape
    h, w, tgt, g = fused_ce_inputs(N, D, V, torch.float32, cuda)
    tgt[0] = V - 1  # a target in the last vocabulary column
    tgt[-1] = 0
    got, got_dh = _ce_grad(fused_ce.linear_ce_rows, h, w, tgt, g)
    torch.cuda.synchronize()
    want, want_dh = _ce_grad(fused_ce.linear_ce_rows_plain, h, w, tgt, g)
    assert got.shape == (N,) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert got_dh.shape == (N, D) and got_dh.dtype == torch.float32
    assert float((got_dh - want_dh).abs().max()) <= 1e-5 * float(want_dh.abs().max())


@pytest.mark.gpu
def test_fused_ce_kernel_extreme_logits(cuda):
    """Logits scaled x12 (magnitudes of several hundred): the online rescale
    across tiles and splits must hold; rows within 1e-4."""
    h, w, tgt, _ = fused_ce_inputs(300, 256, 1024, torch.float32, cuda, seed=2, spread=12.0)
    got = fused_ce.linear_ce_rows(h, w, tgt)
    want = fused_ce.linear_ce_rows_plain(h, w, tgt)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(300, 256, 2048), (515, 384, 9216), (8, 128, 512)])
def test_fused_ce_kernel_matches_plain_bfloat16(cuda, shape):
    """On the card, bfloat16 (the tensor-core tile): the products are exact in
    float32 on both sides, so rows agree within 1e-4 (sum order only); dh
    within 2e-2 of its largest element: the kernel rounds the coefficients to
    bfloat16 before the second product (2^-9 relative each) and dh itself is
    rounded to bfloat16."""
    h, w, tgt, g = fused_ce_inputs(*shape, torch.bfloat16, cuda, seed=3)
    tgt[0] = shape[2] - 1
    got, got_dh = _ce_grad(fused_ce.linear_ce_rows, h, w, tgt, g)
    want, want_dh = _ce_grad(fused_ce.linear_ce_rows_plain, h, w, tgt, g)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert got_dh.dtype == torch.bfloat16
    assert float((got_dh.float() - want_dh.float()).abs().max()) <= 2e-2 * float(want_dh.float().abs().max())


@pytest.mark.gpu
def test_fused_ce_wrapper_counts_and_checks(cuda):
    h, w, tgt, g = fused_ce_inputs(64, 128, 512, torch.float32, cuda)
    n_f, n_b = fused_ce.launches, fused_ce.launches_bwd
    _ce_grad(fused_ce.linear_ce_rows, h, w, tgt, g)
    assert (fused_ce.launches, fused_ce.launches_bwd) == (n_f + 1, n_b + 1)
    with pytest.raises(ValueError, match="frozen"):
        fused_ce.linear_ce_rows(h, w.clone().requires_grad_(True), tgt)
    with pytest.raises(TypeError):
        fused_ce.linear_ce_rows(h, w.bfloat16(), tgt)
    with pytest.raises(TypeError):
        fused_ce.linear_ce_rows(h.half(), w.half(), tgt)
    with pytest.raises(ValueError, match="multiple"):
        fused_ce.linear_ce_rows(h[:, :64], w[:64], tgt)
    assert (fused_ce.launches, fused_ce.launches_bwd) == (n_f + 1, n_b + 1)


def test_fused_ce_split_plan_covers_the_vocabulary():
    """The forward grid's plan, for both routes (bfloat16: 256-column tiles;
    float32: 128-column tiles; one block per SM): every column tile belongs
    to one split, no split is empty, and small row counts get more splits."""
    for tile, slots in ((fused_ce.TILE_BF16, 132), (fused_ce.TILE, 132)):
        for n, v in ((2044, 152064), (4088, 32768), (8, 512), (300, 1024)):
            splits, per = fused_ce.split_plan(n, v, tile, slots)
            tiles = v // tile
            assert splits >= 1 and per >= 1
            assert (splits - 1) * per < tiles <= splits * per
        assert fused_ce.split_plan(8, 152064, tile, slots)[0] > fused_ce.split_plan(4088, 152064, tile, slots)[0]


FUSED_CE_EDGES = [
    (1, 128, 512),  # one row; D 128: two 64-deep stages, fewer than the ring's four
    (63, 128, 1024),  # a partial first warpgroup
    (65, 256, 2048),  # one row into the second warpgroup
    (2044, 128, 512),  # the 7B row count (last row tile 124); two vocabulary tiles
    (2044, 128, 65536),  # eight tiles a block at D 128: the ring wraps within a block's walk
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, tol, gtol", [(torch.float32, 1e-5, 1e-5), (torch.bfloat16, 1e-4, 2e-2)])
@pytest.mark.parametrize("shape", FUSED_CE_EDGES)
def test_fused_ce_kernel_edges(cuda, shape, dtype, tol, gtol):
    """The edges of the tiles, the ring and the plans, both types, with
    targets in the first and last vocabulary columns: rows within tol, dh
    within gtol of its largest element (the tolerances of the tests above)."""
    N, D, V = shape
    h, w, tgt, g = fused_ce_inputs(N, D, V, dtype, cuda, seed=4)
    g[0] = 1.0 / N  # row 0 carries a gradient (alone at N 1, where g / g.sum() can be 0 / 0)
    tgt[0] = V - 1
    if N > 1:
        tgt[1] = 0
        tgt[-1] = V - 1
    got, got_dh = _ce_grad(fused_ce.linear_ce_rows, h, w, tgt, g)
    torch.cuda.synchronize()
    want, want_dh = _ce_grad(fused_ce.linear_ce_rows_plain, h, w, tgt, g)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert got_dh.shape == (N, D) and got_dh.dtype == dtype
    assert float((got_dh.float() - want_dh.float()).abs().max()) <= gtol * float(want_dh.float().abs().max())


def _h_7b_width(cuda, seed):
    """D 3,584 and the 7B row count over two backward chunks of 8,448."""
    return fused_ce_inputs(2044, 3584, 16896, torch.bfloat16, cuda, seed=seed)


@pytest.mark.gpu
def test_fused_ce_bfloat16_matches_plain_at_7b_width(cuda):
    h, w, tgt, g = _h_7b_width(cuda, 5)
    tgt[0] = w.shape[1] - 1
    got, got_dh = _ce_grad(fused_ce.linear_ce_rows, h, w, tgt, g)
    want, want_dh = _ce_grad(fused_ce.linear_ce_rows_plain, h, w, tgt, g)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert float((got_dh.float() - want_dh.float()).abs().max()) <= 2e-2 * float(want_dh.float().abs().max())


@pytest.mark.gpu
def test_fused_ce_bfloat16_backward_is_deterministic(cuda):
    """No atomics: two backwards on the same inputs give the same bits."""
    h, w, tgt, g = _h_7b_width(cuda, 6)
    first = _ce_grad(fused_ce.linear_ce_rows, h, w, tgt, g)
    second = _ce_grad(fused_ce.linear_ce_rows, h, w, tgt, g)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


# ---------------------------------------------------------------------------
# kernels C/D (frame gather, one CUDA kernel) and E (chunk cumsum)
# ---------------------------------------------------------------------------


def frames_inputs(B, T, W, F, seed, edges=False):
    """x [B, T] (or [T] for B None), starts in [0, T − W], a Hann window."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T,) if B is None else (B, T)).astype(np.float32)
    shape = (F,) if B is None else (B, F)
    starts = rng.integers(0, T - W + 1, size=shape).astype(np.int32)
    if edges:
        e = np.array([0, 1, 1023, 1024, 1025, 2047, 2048, T - W], np.int32)
        starts[..., : e.size] = e
    win = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(W) / W)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(starts), torch.from_numpy(win)


@pytest.mark.gpu
@pytest.mark.parametrize("fn", ["extract_frames", "extract_frames_aligned", "frames_op"])
@pytest.mark.parametrize("geom", [(None, 8192, 256, 37, False), (None, 50000, 880, 37, True), (2, 8192, 256, 37, False),
                                  (2, 50000, 880, 41, True), (3, 1000, 1000, 5, False)])
def test_frames_kernel_equals_plain(cuda, fn, geom):
    """Kernels C and D share one CUDA kernel: equal to the plain gather bit
    for bit (one gather and one product per element)."""
    x, s, w = frames_inputs(*geom[:4], seed=geom[1] + geom[3], edges=geom[4])
    want = frames.extract_frames_plain(x, s, w)
    n = frames.launches
    got = getattr(frames, fn)(x.to(cuda), s.to(cuda), w.to(cuda), w.shape[0])
    torch.cuda.synchronize()
    assert frames.launches == n + 1
    assert got.shape == want.shape and torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_frames_kernel_clips_outside_the_contract(cuda):
    """Starts below 0 or past T − W read the clipped samples, as the plain
    gather does."""
    x, _, w = frames_inputs(None, 3000, 512, 1, seed=3)
    s = torch.tensor([-700, -1, 0, 2488, 2489, 2999, 5000], dtype=torch.int32)
    got = frames.frames_op(x.to(cuda), s.to(cuda), w.to(cuda))
    assert torch.equal(got.cpu(), frames.extract_frames_plain(x, s, w))


@pytest.mark.gpu
def test_frames_wrapper_checks(cuda):
    x, s, w = (t.to(cuda) for t in frames_inputs(None, 4096, 256, 4, seed=1))
    with pytest.raises(TypeError):
        frames.frames_op(x, s.long(), w)
    with pytest.raises(ValueError):
        frames.frames_op(x, s, torch.ones(frames.MAX_W + 1, device=cuda))
    with pytest.raises(ValueError):
        frames.frames_op(x, s.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 1024), (16, 4096), (24, 3072), (16, 65536), (16, 1040384), (65544, 1024)])
@pytest.mark.parametrize("square", [False, True])
def test_chunk_cumsum_kernel_equals_plain(cuda, shape, square):
    """Kernel E keeps the TPU kernel's shift-add ladder with round-to-nearest
    adds: equal to the plain version bit for bit, at the measure voice's
    [16, 1,040,384] and past the 65,535 rows of the earlier 2-D grid."""
    x = torch.from_numpy(np.random.default_rng(shape[1] + square).normal(size=shape).astype(np.float32)).to(cuda)
    if square:
        x = x * x
    want = chunk_cumsum.chunk_cumsum_plain(x)
    n = chunk_cumsum.launches
    got = chunk_cumsum.chunk_cumsum(x)
    torch.cuda.synchronize()
    assert chunk_cumsum.launches == n + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 1024), (16, 1040384)])
def test_chunk_cumsum_kernel_on_cancelling_inputs(cuda, shape):
    """Values of ±1e8 that cancel pairwise, with exact −0.0 and +0.0 (an add
    of 0.0 turns −0.0 into +0.0): equal bit for bit, signs of zero included."""
    rng = np.random.default_rng(shape[1])
    x = (rng.choice([-1.0, 1.0], size=shape) * 1e8 + rng.normal(size=shape)).astype(np.float32)
    x[:, 1::2] = -x[:, 0::2]
    x[:, 2::7] = -0.0
    x[:, 3::11] = 0.0
    x = torch.from_numpy(x).to(cuda)
    got = chunk_cumsum.chunk_cumsum(x)
    want = chunk_cumsum.chunk_cumsum_plain(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_chunk_cumsum_wrapper_checks(cuda):
    with pytest.raises(ValueError):
        chunk_cumsum.chunk_cumsum(torch.zeros((8, 1000), device=cuda))
    with pytest.raises(TypeError):
        chunk_cumsum.chunk_cumsum(torch.zeros((8, 1024), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        chunk_cumsum.chunk_cumsum(torch.zeros((1024, 8), device=cuda).t())


# ---------------------------------------------------------------------------
# mask_ema (the spectral gate's two-way time smoothing; no TPU kernel)
# ---------------------------------------------------------------------------


def mask_fixture(F, T, seed):
    """A gate-like mask: sigmoid values, exact zeros and ones, and values
    whose products by smooth fall below float32's normal range."""
    rng = np.random.default_rng(seed)
    m = (1.0 / (1.0 + np.exp(-rng.normal(scale=4.0, size=(F, T))))).astype(np.float32)
    m[:, ::13] = 0.0
    m[::3, 5::17] = 1.0
    m[::7, 3::11] = 3e-38
    return m


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(513, 1), (513, 2), (513, 31), (513, 32), (513, 33), (513, 347), (1, 100), (33, 1000),
                                   (64, 257), (513, 27478)])
@pytest.mark.parametrize("smooth", [0.5, 0.3])
def test_mask_ema_kernel_equals_plain(cuda, shape, smooth):
    """Bit for bit (every multiply and add rounded on its own in both), at
    edge tile counts, with a partial last block of bins (513 = 16 x 32 + 1)
    and at the 159.5 s recording's 27,478 frames."""
    m = torch.from_numpy(mask_fixture(*shape, seed=shape[0] * 7 + shape[1])).to(cuda)
    want = mask_ema.mask_ema_plain(m, smooth)
    n = mask_ema.launches
    got = mask_ema.mask_ema(m, smooth)
    torch.cuda.synchronize()
    assert mask_ema.launches == n + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_mask_ema_kernel_is_deterministic_and_checks(cuda):
    m = torch.from_numpy(mask_fixture(513, 4000, seed=1)).to(cuda)
    a, b = mask_ema.mask_ema(m), mask_ema.mask_ema(m)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    with pytest.raises(TypeError):
        mask_ema.mask_ema(m.double())
    with pytest.raises(ValueError):
        mask_ema.mask_ema(m.t())
    with pytest.raises(ValueError):
        mask_ema.mask_ema(m[None])


def sparse_ones(F, T, every=500):
    """Exact zeros with a 1 every ``every`` frames: restarted chains meet
    the true one late, near the subnormal floor."""
    m = np.zeros((F, T), np.float32)
    m[:, ::every] = 1.0
    return m


@pytest.mark.gpu
@pytest.mark.parametrize("case", [("fixture", 513, 6000, 0.999), ("fixture", 513, 1027, 0.999), ("fixture", 33, 6000, 0.99),
                                  ("zeros", 64, 6000, 0.5), ("zeros", 513, 27478, 0.5)])
def test_mask_ema_kernel_fixups_stay_exact(cuda, case):
    """Chunks that enter with another state than the true one are recomputed
    by the fix-up launches, bit for bit: smooth near 1 (nearly every chunk)
    and long stretches of exact zeros; the fix-up count is read."""
    kind, F, T, smooth = case
    m_np = mask_fixture(F, T, seed=F + T) if kind == "fixture" else sparse_ones(F, T)
    m = torch.from_numpy(m_np).to(cuda)
    want = mask_ema.mask_ema_plain(m, smooth)
    mask_ema.reset_fixups()
    got = mask_ema.mask_ema(m, smooth)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    fixes = mask_ema.fixup_count()
    if kind == "fixture":  # smooth near 1: every chunk past the warm-up's reach, both passes
        assert fixes > 0.9 * 2 * F * (-(-T // 256) - 2)
    else:
        assert fixes > 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(513, 255), (513, 256), (513, 257), (7, 1027), (513, 5001), (2, 8194)])
@pytest.mark.parametrize("smooth", [0.5, 0.9])
def test_mask_ema_kernel_chunk_edges(cuda, shape, smooth):
    """T below one chunk, one chunk, one chunk and a frame, T not a
    multiple of 4, a partial last block of chunks; no fix-up at smooth 0.5
    on the fixture."""
    m = torch.from_numpy(mask_fixture(*shape, seed=shape[1])).to(cuda)
    want = mask_ema.mask_ema_plain(m, smooth)
    mask_ema.reset_fixups()
    got = mask_ema.mask_ema(m, smooth)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if smooth == 0.5:
        assert mask_ema.fixup_count() == 0


# ---------------------------------------------------------------------------
# ctc_viterbi (the CTC aligner's forced-alignment Viterbi; no TPU kernel)
# ---------------------------------------------------------------------------


def ctc_fixture(T, L, seed, V=47, ties=False, equal_columns=False):
    """Frame log-softmax [T, V] and labels [L]: every fifth label repeats
    the one before it (the skip is forbidden there); ``ties`` quantises the
    logits so that candidates meet exactly, ``equal_columns`` makes every
    column of a frame equal."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(scale=3.0, size=(T, V)).astype(np.float32)
    if ties:
        logits = np.round(logits)
    if equal_columns:
        logits[:] = logits[:, :1]
    lp = torch.log_softmax(torch.from_numpy(logits), dim=-1)
    labels = rng.integers(1, 8 if ties else V, size=L)
    labels[4::5] = labels[3::5][: len(labels[4::5])]
    return lp, torch.from_numpy(labels.astype(np.int32))


def ctc_kernel_vs_plain(cuda, lp, labels, input_len, label_len):
    """The kernel on the card against the plain version on the CPU: states
    and score bit for bit."""
    want_states, want_score = ctc_viterbi.ctc_forced_align_plain(lp, labels, input_len, label_len)
    n = ctc_viterbi.launches
    got_states, got_score = ctc_viterbi.ctc_forced_align(lp.to(cuda), labels.to(cuda), input_len, label_len)
    torch.cuda.synchronize()
    assert ctc_viterbi.launches == n + 1
    assert torch.equal(got_states.cpu(), want_states)
    assert got_score.cpu().view(torch.int32).item() == want_score.view(torch.int32).item()


def test_ctc_plain_tie_order():
    """Equal candidates: stay beats s - 1, which beats s - 2; a repeated
    label forbids the skip over the blank between its copies."""
    lp = torch.zeros((3, 4))  # every emission 0: every candidate ties
    # frame 1: state 1 stays (not 0 -> 1), state 3 skips from 1; frame 2:
    # state 4 comes from 3, and the last blank wins the tie at the end
    states, score = ctc_viterbi.ctc_forced_align_plain(lp, torch.tensor([1, 2]), 3, 2)
    assert states.tolist() == [1, 3, 4] and score.item() == 0.0
    states, _ = ctc_viterbi.ctc_forced_align_plain(lp, torch.tensor([1, 1]), 3, 2)
    assert states.tolist() == [1, 2, 3]  # the repeat must pass through the blank
    # label_len 2 of 4 (padding) and input_len 2 of 3: the last frame keeps the final state
    states, _ = ctc_viterbi.ctc_forced_align_plain(lp, torch.tensor([1, 2, 0, 0]), 2, 2)
    assert states.tolist() == [1, 3, 3]


# (L, T): S = 2L + 1 from 1 to 2,049 and T from 1 to 8,192 (states a thread
# 2, 4; one and several warps), 4,401 states at 7,300 frames (Final
# Transcribe of a 146 s OUT.wav: 8 states a thread) and 16,383 (16 a thread)
CTC_SHAPES = [(0, 1), (0, 9), (1, 1), (1, 2), (2, 5), (15, 64), (31, 33), (32, 100), (63, 257), (64, 1000),
              (300, 700), (511, 2000), (1024, 8192), (2200, 7300), (8191, 300)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CTC_SHAPES)
@pytest.mark.parametrize("ties", [False, True])
def test_ctc_viterbi_kernel_equals_plain(cuda, shape, ties):
    L, T = shape
    lp, labels = ctc_fixture(T, L, seed=L * 31 + T, ties=ties)
    ctc_kernel_vs_plain(cuda, lp, labels, T, L)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(31, 200), (64, 1000), (1000, 4000)])
def test_ctc_viterbi_kernel_frozen_frames_padded_labels_equal_columns(cuda, shape):
    """Frames past input_len (alpha frozen, the final state kept), labels
    padded to a multiple of 32 past label_len, and frames whose columns are
    all equal (every candidate ties every frame)."""
    L, T = shape
    Lp = (L + 31) // 32 * 32 + 32
    lp, labels = ctc_fixture(T, Lp, seed=L + T, ties=True)
    for input_len, label_len in ((T, L), (T // 2, L // 2), (T - 1, Lp), (1, L), (T + 5, 0)):
        ctc_kernel_vs_plain(cuda, lp, labels, input_len, min(label_len, Lp))
    lp_eq, labels = ctc_fixture(T, L, seed=L + T + 1, equal_columns=True)
    ctc_kernel_vs_plain(cuda, lp_eq, labels, T, L)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(15, 64), (300, 700), (2200, 7300)])
def test_ctc_viterbi_kernel_v48_and_unaligned_rows(cuda, shape):
    """V 48 (the aligner's vocabulary: 192-byte rows, 16-byte copies) and a
    sequence whose rows do not start 16-byte aligned (4-byte copies)."""
    L, T = shape
    lp, labels = ctc_fixture(T, L, seed=L + 3 * T, V=48, ties=True)
    ctc_kernel_vs_plain(cuda, lp, labels, T, L)
    lp47, labels47 = ctc_fixture(T + 1, L, seed=L + T, V=47)
    want_states, want_score = ctc_viterbi.ctc_forced_align_plain(lp47[1:], labels47, T, L)
    got_states, got_score = ctc_viterbi.ctc_forced_align(lp47.to(cuda)[1:], labels47, T, L)  # starts 188 bytes in
    torch.cuda.synchronize()
    assert torch.equal(got_states.cpu(), want_states)
    assert got_score.cpu().view(torch.int32).item() == want_score.view(torch.int32).item()


def ctc_host_inputs(labels, blank=0):
    ext = ctc_viterbi.expand_labels(labels.long(), blank)
    s_idx = torch.arange(ext.shape[0])
    skip = (s_idx >= 2) & (s_idx % 2 == 1) & (ext != torch.roll(ext, 2))
    return ext, skip


@pytest.mark.gpu
@pytest.mark.parametrize("V", [47, 48])
def test_ctc_viterbi_kernel_every_instantiation(cuda, V):
    """2, 4, 8 and 16 states a thread (the launch's explicit kK), each on
    clusters of 1, 2, 3 and 8 blocks, at the same 401 states: states and
    score bit-equal to the plain version."""
    from prosody_control_french_tts_tpu_torch.ops import kernels

    T, L = 500, 200
    lp, labels = ctc_fixture(T, L, seed=V, V=V, ties=True)
    ext, skip = ctc_host_inputs(labels)
    S = ext.shape[0]
    want_states, want_score = ctc_viterbi.ctc_forced_align_plain(lp, labels, T - 7, L)
    lib = kernels.library()
    lp_d = lp[None].to(cuda)
    meta = torch.cat([torch.tensor([T - 7, L]), ext, skip.long()]).int().to(cuda)
    for kK in (2, 4, 8, 16):
        for C in (1, 2, 3, 8):  # at 8 blocks and 2 states a thread, the last block holds no state
            back = torch.empty((1, lib.ctc_viterbi_back_words(T, S, kK, C)), dtype=torch.int32, device=cuda)
            states = torch.empty((1, T), dtype=torch.int32, device=cuda)
            score = torch.empty((1,), dtype=torch.float32, device=cuda)
            rc = lib.ctc_viterbi_launch(lp_d.data_ptr(), meta[2:].data_ptr(), meta[2 + S:].data_ptr(), meta.data_ptr(),
                                        meta[1:].data_ptr(), back.data_ptr(), states.data_ptr(), score.data_ptr(), 1, T,
                                        S, V, kK, C, kernels.stream_ptr(lp_d))
            kernels.check(rc, "ctc_viterbi")
            torch.cuda.synchronize()
            assert torch.equal(states[0].cpu(), want_states), (kK, C)
            assert score.cpu().view(torch.int32).item() == want_score.view(torch.int32).item()


@pytest.mark.gpu
def test_ctc_viterbi_kernel_batch_and_checks(cuda):
    """Several sequences in one launch (one block each, rows of odd length so
    that some sequences start unaligned), each equal to its own plain
    alignment; the wrapper counts launches and refuses what the kernel
    cannot take."""
    B, T, L = 5, 301, 40
    lp, labels = ctc_fixture(T, L, seed=7, ties=True)
    ext, skip = ctc_host_inputs(labels)
    emit = lp[:, ext]
    in_lens = torch.tensor([301, 1, 150, 299, 77], dtype=torch.int32)
    lab_lens = torch.tensor([40, 0, 20, 39, 40], dtype=torch.int32)
    lp_b = lp[None].repeat(B, 1, 1).to(cuda)
    n = ctc_viterbi.launches
    states, score = ctc_viterbi.ctc_viterbi(lp_b, ext[None].repeat(B, 1), skip[None].repeat(B, 1), in_lens, lab_lens)
    assert ctc_viterbi.launches == n + 1
    for b in range(B):
        ws, wsc = ctc_viterbi.ctc_viterbi_plain(emit, skip, int(in_lens[b]), int(lab_lens[b]))
        assert torch.equal(states[b].cpu(), ws)
        assert score[b].cpu().view(torch.int32).item() == wsc.view(torch.int32).item()
    a, _ = ctc_viterbi.ctc_viterbi(lp_b[:1], ext[None], skip[None], in_lens[:1], lab_lens[:1])
    b2, _ = ctc_viterbi.ctc_viterbi(lp_b[:1], ext[None], skip[None], in_lens[:1], lab_lens[:1])
    assert torch.equal(a, b2)
    big = ctc_viterbi.MAX_STATES + 2
    with pytest.raises(ValueError, match="exceed"):
        ctc_viterbi.ctc_viterbi(torch.zeros((1, 4, 8), device=cuda), torch.zeros((1, big), dtype=torch.int32),
                                torch.zeros((1, big), dtype=torch.bool), torch.tensor([4]), torch.tensor([1]))
    with pytest.raises(ValueError, match="label_len"):
        ctc_viterbi.ctc_viterbi(lp_b[:1], ext[None], skip[None], in_lens[:1], torch.tensor([L + 1]))
    with pytest.raises(ValueError, match="outside"):
        ctc_viterbi.ctc_viterbi(lp_b[:1, :, :5].contiguous(), ext[None], skip[None], in_lens[:1], lab_lens[:1])
    odd_blank = ext.clone()
    odd_blank[2] = 1
    with pytest.raises(ValueError, match="even states"):
        ctc_viterbi.ctc_viterbi(lp_b[:1], odd_blank[None], skip[None], in_lens[:1], lab_lens[:1])
    with pytest.raises(ValueError, match="host"):
        ctc_viterbi.ctc_viterbi(lp_b[:1], ext[None].to(cuda), skip[None], in_lens[:1], lab_lens[:1])
    with pytest.raises(ValueError, match="classes"):
        ctc_viterbi.ctc_viterbi(torch.zeros((1, 4, 4096), device=cuda), ext[None], skip[None], in_lens[:1], lab_lens[:1])
    with pytest.raises(TypeError):
        ctc_viterbi.ctc_viterbi(lp_b[:1].double(), ext[None], skip[None], in_lens[:1], lab_lens[:1])
    with pytest.raises(ValueError, match="CUDA"):
        ctc_viterbi.ctc_viterbi(lp[None], ext[None], skip[None], in_lens[:1], lab_lens[:1])


# ctc_loss: (T, V, L, input_len, label_len, labels or None). Random feasible
# inputs at train_ctc's 20 s cap (1,000 frames, S 601) and padded, label_len 0
# and 1, repeated labels, an infeasible alignment, one frame, and S at each
# states-a-thread count up to the kernel's limit (4,095).
CTC_LOSS_CASES = [
    (50, 10, 8, 50, 8, None),
    (200, 47, 60, 180, 55, None),
    (1000, 47, 300, 1000, 300, None),
    (1000, 47, 300, 700, 250, None),
    (40, 10, 5, 40, 0, None),
    (40, 10, 5, 40, 1, None),
    (30, 5, 6, 30, 6, [1, 1, 2, 2, 1, 1]),
    (10, 10, 15, 10, 15, None),
    (9, 6, 3, 1, 2, None),
    (1100, 48, 512, 1100, 512, None),
    (2200, 48, 1024, 2200, 1024, None),
    (4200, 48, 2047, 4200, 2047, None),
]


def _ctc_loss_inputs(T, V, L, seed, labels=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, V)).astype(np.float32) * 3.0
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    lab = np.asarray(labels, np.int64) if labels is not None else rng.integers(1, V, L)
    return torch.from_numpy(lp.astype(np.float32)), torch.from_numpy(lab)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CTC_LOSS_CASES, ids=lambda c: f"T{c[0]}-V{c[1]}-L{c[2]}-in{c[3]}-lab{c[4]}")
def test_ctc_loss_kernel_matches_plain(cuda, case):
    """Loss within 1e-5 relative, d loss / d log_probs within 1e-5 · max(1,
    loss / 100) absolute, or 1e-5 of its largest entry on an infeasible
    alignment (the same float32 recursion; exp and log1p may differ in the
    last bit, and the rounding of α grows with its size, about the loss),
    two launches a call."""
    T, V, L, inp, lab, labels = case
    lp, labels = _ctc_loss_inputs(T, V, L, T + L, labels)
    want_lp = lp.to(cuda).requires_grad_(True)
    want = ctc_loss.ctc_loss_plain(want_lp, labels.to(cuda), inp, lab)
    want.backward()
    got_lp = lp.to(cuda).requires_grad_(True)
    n0 = ctc_loss.launches
    got = ctc_loss.ctc_loss(got_lp, labels, inp, lab)
    got.backward()
    torch.cuda.synchronize()
    assert ctc_loss.launches == n0 + 2
    w, g = float(want), float(got)
    assert abs(g - w) <= 1e-5 * abs(w), (g, w)
    scale = max(1.0, float(want_lp.grad.abs().max())) if w > 1e29 else max(1.0, abs(w) / 100.0)
    assert float((got_lp.grad - want_lp.grad).abs().max()) <= 1e-5 * scale


@pytest.mark.gpu
def test_ctc_loss_kernel_refuses_past_its_states(cuda):
    lp, labels = _ctc_loss_inputs(4200, 48, 2048, 0)
    n0 = ctc_loss.launches
    with pytest.raises(ValueError, match="4096"):
        ctc_loss.ctc_loss(lp.to(cuda), labels, 4200, 2048)
    with pytest.raises(ValueError, match="outside"):
        ctc_loss.ctc_loss(lp[:, :10].contiguous().to(cuda), labels[:5] + 20, 4200, 5)
    assert ctc_loss.launches == n0
