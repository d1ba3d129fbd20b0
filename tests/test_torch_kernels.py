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

from prosody_control_french_tts_tpu_torch.ops import candidates, decode_attn, viterbi

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
@pytest.mark.parametrize("shape", [(5, 400, 15), (2, 1, 15), (3, 37, 32), (1, 20, 1)])
def test_viterbi_kernel_matches_plain(cuda, shape):
    """On the card: f0 equal in every frame, K from 1 to 32 and F = 1."""
    S, F, K = shape
    args = [torch.from_numpy(a).to(cuda) for a in random_viterbi_inputs(4, S=S, F=F, K=K)]
    got = viterbi.viterbi_path(*args, 0.14 * 0.5, 0.35 * 0.5)
    want = viterbi.viterbi_path_plain(*args, 0.14 * 0.5, 0.35 * 0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


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
    args = [torch.from_numpy(a).to(cuda) for a in random_viterbi_inputs(0, K=33)]
    with pytest.raises(ValueError):
        viterbi.viterbi_path(*args, 0.1, 0.2)
