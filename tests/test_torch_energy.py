"""The PyTorch port's silence scan (``ops/energy.py``) and its window-local
range sums against the JAX package.

JAX ``detect_silence`` has two paths: the native double-precision scan for a
numpy input (the shared library loads on this host) and the float32 device
scan for a ``jnp`` input. The port always takes the device path; its ranges
are held equal to both on seeded signals, with silent gaps of zeros between
the voiced parts (the breath noise of a synthetic voice sits within a few
levels of the −50 dBFS threshold).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prosody_control_french_tts_tpu.ops import cumsum as jcs, energy as je
from prosody_control_french_tts_tpu_torch.ops import cumsum as tcs, energy as te

SR = 44100


def voiced_with_gaps(seed, n_parts, part_s=(1.0, 4.0), gap_s=(1.1, 2.5), rate=SR, quiet_noise=True):
    """Harmonic parts at random levels (−6 to −35 dBFS) separated by gaps of
    zeros (some with noise near −66 dBFS), quantised to int16 as wav audio is."""
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(n_parts):
        n = int(rng.uniform(*part_s) * rate)
        t = np.arange(n) / rate
        f0 = rng.uniform(100, 250)
        amp = 10 ** (rng.uniform(-35, -6) / 20)
        env = np.sin(np.pi * np.arange(n) / n) ** 0.3
        parts.append((amp * env * sum(np.sin(2 * np.pi * h * f0 * t) / h for h in range(1, 6))).astype(np.float32))
        g = np.zeros(int(rng.uniform(*gap_s) * rate), np.float32)
        if quiet_noise and i % 3 == 1:
            g += (0.0005 * rng.normal(size=g.size)).astype(np.float32)
        parts.append(g)
    x = np.concatenate(parts)
    return (np.round(x * 32768.0) / 32768.0).astype(np.float32)


@pytest.mark.parametrize("rate,window_ms", [(44100, 1000), (22050, 100), (16000, 120), (48000, 300)])
def test_window_rms_sq_within_one_level_of_jax(rate, window_ms):
    """floor(sqrt(mean square)·32768) per window: within 1 of the JAX device
    scan (float32 sums in another order; the JAX package's own bound
    between its two paths)."""
    x = voiced_with_gaps(rate + window_ms, 4, rate=rate)
    Tp = 1 << (x.size - 1).bit_length()
    xp = np.pad(x, (0, Tp - x.size))
    want = np.asarray(je._window_rms_sq(jnp.asarray(xp), rate, window_ms))
    got = te._window_rms_sq(torch.from_numpy(xp), rate, window_ms).numpy()
    assert got.shape == want.shape
    lv = lambda a: np.floor(np.sqrt(np.maximum(a, 0.0)) * 32768.0)  # noqa: E731
    assert np.abs(lv(got) - lv(want)).max() <= 1.0


def test_window_rms_sq_int16_upload_is_lossless():
    """The int16 image of wav audio gives the same window sums as its
    float32 samples."""
    x = voiced_with_gaps(5, 3)
    q = (x * 32768).astype(np.int16)
    a = te._window_rms_sq(torch.from_numpy(x), SR, 1000)
    b = te._window_rms_sq(torch.from_numpy(q), SR, 1000)
    assert torch.equal(a, b)


def test_range_sum_local_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 30000)).astype(np.float32)
    lo = rng.integers(0, 30000, size=(2, 50))
    hi = np.minimum(lo + rng.integers(0, 5000, size=(2, 50)), 30000)
    want = np.asarray(jcs.chunked_cumsum_sq(jnp.asarray(x)).range_sum_local(jnp.asarray(lo), jnp.asarray(hi), 5001))
    got = tcs.chunked_cumsum_sq(torch.from_numpy(x)).range_sum_local(torch.from_numpy(lo), torch.from_numpy(hi), 5001).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    ref = np.array([[np.square(x[b, l:h].astype(np.float64)).sum() for l, h in zip(lo[b], hi[b])] for b in range(2)])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("seed,n_parts,min_sil,thresh,keep", [
    (1, 6, 1000, -50.0, 300),
    (2, 8, 500, -45.0, 100),
    (3, 5, 1000, -40.0, 200),
    (4, 10, 300, -60.0, 50),
])
def test_silence_ranges_equal_both_jax_paths(seed, n_parts, min_sil, thresh, keep):
    x = voiced_with_gaps(seed, n_parts)
    for fn, args in (
        ("detect_silence", (SR, min_sil, thresh)),
        ("detect_nonsilent", (SR, min_sil, thresh)),
        ("split_on_silence_ranges", (SR, min_sil, thresh, keep)),
    ):
        native = getattr(je, fn)(x, *args)
        device = getattr(je, fn)(jnp.asarray(x), *args)
        got = getattr(te, fn)(x, *args, device="cpu")
        assert native == device, (fn, "the two JAX paths disagree")
        assert got == native, fn
    assert len(te.split_on_silence_ranges(x, SR, min_sil, thresh, keep, device="cpu")) >= 2


def test_silence_ranges_on_float_audio():
    """A float32 signal with no exact int16 image takes the float32 upload."""
    x = voiced_with_gaps(6, 5) + np.float32(1e-7)
    x[np.abs(x) < 2e-7] = 0.0
    assert te.f32_to_i16_exact(np.pad(x, (0, 5))) is None
    want = je.split_on_silence_ranges(jnp.asarray(x), SR, 1000, -50.0, 300)
    assert te.split_on_silence_ranges(x, SR, 1000, -50.0, 300, device="cpu") == want


def test_silence_ranges_six_minutes():
    """A 6.2 min recording at 44.1 kHz (past 2²⁴ samples of index products):
    the ranges equal both JAX paths."""
    x = voiced_with_gaps(7, 160, part_s=(1.0, 2.0), gap_s=(1.05, 1.2))
    x = x[: int(6.2 * 60 * SR)]
    assert x.size > 6 * 60 * SR
    native = je.split_on_silence_ranges(x, SR, 1000, -50.0, 300)
    device = je.split_on_silence_ranges(jnp.asarray(x), SR, 1000, -50.0, 300)
    got = te.split_on_silence_ranges(x, SR, 1000, -50.0, 300, device="cpu")
    assert native == device
    assert got == native
    assert len(got) > 100


def test_short_and_silent_inputs():
    assert te.detect_silence(np.zeros(100, np.float32), SR, 1000, -50.0, device="cpu") == []
    z = np.zeros(3 * SR, np.float32)
    assert te.detect_nonsilent(z, SR, 1000, -50.0, device="cpu") == je.detect_nonsilent(z, SR, 1000, -50.0) == []
    assert te.split_on_silence_ranges(z, SR, device="cpu") == []


def test_rms_and_dbfs_match_jax():
    x = voiced_with_gaps(9, 2)
    assert te.rms(x) == je.rms(x)
    assert te.dbfs(x) == je.dbfs(x)
    assert te.dbfs(np.zeros(10, np.float32)) == -np.inf
