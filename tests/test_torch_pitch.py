"""The PyTorch port's Boersma pitch against the JAX package's on the CPU.

Inputs are made with numpy from a seed and handed to both sides. The FFTs
of the two sides round differently in the last bits (pocketfft under both,
other plans), so candidates are compared with tolerances and tracks by the
share of agreeing frames.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prosody_control_french_tts_tpu.ops import pitch as jp
from prosody_control_french_tts_tpu_torch.ops import pitch as tp

SR = 44100


def _speechlike(seed, seconds=1.5, lead=0.2):
    """A harmonic source with a gliding F0, noise and a silent lead-in."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = 140 + 60 * np.sin(2 * np.pi * 0.8 * t)
    ph = 2 * np.pi * np.cumsum(f0) / SR
    x = sum(np.sin(h * ph) / h for h in range(1, 8)) * 0.3 + 0.01 * rng.normal(size=n)
    x[: int(lead * SR)] = 0.0
    return x.astype(np.float32)


def test_host_constants_equal():
    """Geometry and float64-derived constants are the same numbers."""
    for T in (24576, 57344, 1040384):
        gj = jp._geometry(T, SR, jp.PitchParams())
        assert tp._geometry(T, SR, tp.PitchParams()) == gj
    np.testing.assert_array_equal(tp._hanning(880), jp._hanning(880))
    np.testing.assert_array_equal(tp._cos_lag_matrix(2048, 297), jp._cos_lag_matrix(2048, 297))
    np.testing.assert_array_equal(tp._window_ac_ratio(880, 297), jp._window_ac_ratio(880, 297))
    g = jp._geometry(57344, SR, jp.PitchParams())
    assert tp._affine_frame_classes(g, 57344) == jp._affine_frame_classes(g, 57344)


def test_frames_match_gather():
    """The strided framing equals a zero-padded gather at the rational frame
    starts — the definition the JAX package's framing implements."""
    T = 24576
    x = np.random.default_rng(0).normal(size=(2, T)).astype(np.float32)
    g = tp._geometry(T, SR, tp.PitchParams())
    cls = tp._affine_frame_classes(g, T)
    xp = torch.nn.functional.pad(torch.from_numpy(x), (0, cls["pad_to"] - T))
    got = tp._frames_uniform(xp, cls)
    want = np.asarray(jp._frames_uniform(jnp.asarray(np.pad(x[0], (0, cls["pad_to"] - T))), cls))
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert got.shape == (2, g["n_frames"], g["nsamp_window"])


def _check_pitch_frames(time_step, strided):
    X = np.stack([_speechlike(1), _speechlike(2, lead=0.4)])
    X = np.pad(X, ((0, 0), (0, 24576 * 3 - X.shape[1])))
    T = X.shape[1]
    lens = np.array([int(1.5 * SR), int(1.2 * SR)], np.float32)
    pj, pt = jp.PitchParams(time_step=time_step), tp.PitchParams(time_step=time_step)
    assert (tp._affine_frame_classes(tp._geometry(T, SR, pt), T) is not None) == strided
    fj, sj, ij, vj = (np.asarray(a) for a in jax.vmap(lambda a, n: jp._pitch_frames(a, SR, T, pj, n))(jnp.asarray(X), jnp.asarray(lens)))
    ft, st, it, vt = (a.numpy() for a in tp._pitch_frames(torch.from_numpy(X), SR, T, pt, torch.from_numpy(lens)))
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(it, ij, rtol=0, atol=1e-5)
    agree = np.isclose(ft, fj, rtol=1e-4, atol=0) & np.isclose(st, sj, rtol=0, atol=1e-4)
    assert agree.mean() >= 0.995, agree.mean()


def test_pitch_frames_match_jax():
    """Per-frame candidates on the strided framing (dt/dx = 441 at the
    default time step): intensity within 1e-5, and the candidate frequencies
    within 1e-4 relative (FFT last-bit differences move the parabolic peak
    by ~1e-6 of a lag) wherever both sides agree that a candidate exists —
    ≥ 99.5 % of entries."""
    _check_pitch_frames(None, strided=True)


def test_pitch_frames_gather_branch_match_jax():
    """The same comparison with the same tolerances on the gather framing:
    a 10.1 ms step gives dt/dx = 445.41, which no small q makes integral."""
    _check_pitch_frames(0.0101, strided=False)


@pytest.mark.parametrize("seed", [3, 4])
def test_praat_pitch_matches_jax(seed):
    """The track of praat_pitch: ≥ 99.5 % of frames agree (same voicing and
    F0 within 1e-3 relative), median voiced F0 within 1e-3 relative."""
    x = _speechlike(seed, seconds=1.0 + 0.5 * (seed % 2))
    tj = jp.praat_pitch(x, SR)
    tt = tp.praat_pitch(x, SR, device="cpu")
    fj, ft = np.asarray(tj.f0), tt.f0.numpy()
    np.testing.assert_allclose(tt.times, tj.times, rtol=0, atol=1e-12)
    agree = ((fj == 0) & (ft == 0)) | np.isclose(ft, fj, rtol=1e-3, atol=0)
    assert agree.mean() >= 0.995, agree.mean()
    assert (fj > 0).sum() > 10
    mj, mt = np.median(fj[fj > 0]), np.median(ft[ft > 0])
    assert abs(mt - mj) <= 1e-3 * mj


def test_praat_pitch_batched_lengths():
    """A ragged batch: frames past a row's length come out unvoiced, and the
    batched rows match the JAX package's batched call."""
    x = np.stack([_speechlike(5), _speechlike(6)])
    lens = np.array([x.shape[1], int(0.9 * SR)], np.float32)
    tj = jp.praat_pitch(x, SR, lengths=lens)
    tt = tp.praat_pitch(x, SR, lengths=lens, device="cpu")
    fj, ft = np.asarray(tj.f0), tt.f0.numpy()
    past = tt.times + 0.5 * 880 / SR > 0.9 + 1e-6
    assert (ft[1, past] == 0).all()
    agree = ((fj == 0) & (ft == 0)) | np.isclose(ft, fj, rtol=1e-3, atol=0)
    assert agree.mean() >= 0.995, agree.mean()


def test_masked_median_matches_numpy_and_jax():
    """Sort-based masked median: exact against np.median and the JAX
    package's (same order statistics of the same float32 values)."""
    rng = np.random.default_rng(7)
    v = rng.uniform(80, 400, size=(4, 5, 60)).astype(np.float32)
    m = rng.random((4, 5, 60)) < 0.4
    m[0, 0] = False
    got = tp.masked_median(torch.from_numpy(v), torch.from_numpy(m)).numpy()
    want = np.asarray(jp.masked_median(jnp.asarray(v), jnp.asarray(m)))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 0.0
    np.testing.assert_allclose(got[1, 2], np.median(v[1, 2][m[1, 2]]).astype(np.float32), rtol=1e-7)


def test_median_pitch_in_windows_matches_jax():
    """Same track, same windows: equal medians ([t0, t1) frame-centre
    windows, 0 where nothing is voiced)."""
    rng = np.random.default_rng(8)
    F = 200
    times = 0.01 + np.arange(F) * 0.005
    f0 = np.where(rng.random((2, F)) < 0.6, rng.uniform(100, 300, size=(2, F)), 0).astype(np.float32)
    win = np.sort(rng.uniform(0, 1.0, size=(2, 6, 2)), axis=-1).astype(np.float32)
    mask = rng.random((2, 6)) < 0.8
    want = np.asarray(jp.median_pitch_in_windows(jp.PitchTrack(jnp.asarray(f0), times, 0.005), jnp.asarray(win), jnp.asarray(mask)))
    got = tp.median_pitch_in_windows(tp.PitchTrack(torch.from_numpy(f0), times, 0.005), torch.from_numpy(win), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
