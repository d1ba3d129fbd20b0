"""The PyTorch port's spectral-gate denoiser (``audio/denoise.py``) and its
mask smoothing (``ops/mask_ema.py``) against the JAX package's, on the CPU.

Tolerances: the denoised signal within 1e-5 of the input's peak (both sides
float32: another FFT library, and the noise floor's sort); the plain mask
smoothing equal bit for bit to the JAX package's ``lax.scan`` recurrence at
the denoiser's smooth 0.5 (every product by 0.5 is exact, so a fused
multiply-add cannot round otherwise) and within 1e-6 at 0.3. On the card
``tests/test_torch_kernels.py`` holds the CUDA kernel to the plain version
bit for bit.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prosody_control_french_tts_tpu.utils.wavio import Audio as JAudio
from prosody_control_french_tts_tpu_torch.audio import denoise as tdenoise
from prosody_control_french_tts_tpu_torch.ops import mask_ema
from prosody_control_french_tts_tpu_torch.utils.wavio import Audio as TAudio

jdenoise = importlib.import_module("prosody_control_french_tts_tpu.audio.denoise")


def _tone_and_noise(rate, seed, seconds=2.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    tone = 0.3 * np.sin(2 * np.pi * 220.0 * t) * ((t > 0.5) & (t < 1.5))
    return (tone + 0.02 * rng.normal(size=t.size)).astype(np.float32)


@pytest.mark.parametrize("rate", [22050, 44100])
def test_denoise_matches_jax(rate):
    x = _tone_and_noise(rate, rate)
    want = np.asarray(jdenoise.denoise(JAudio(x, rate)).samples)
    got = tdenoise.denoise(TAudio(x, rate), device="cpu")
    assert got.rate == rate and got.samples.dtype == np.float32
    assert got.samples.shape == want.shape == x.shape
    assert np.max(np.abs(got.samples - want)) < 1e-5 * np.max(np.abs(x))


def test_denoise_options_match_jax():
    x = _tone_and_noise(16000, 5, seconds=1.5)
    kw = dict(n_fft=512, hop=128, noise_quantile=0.2, threshold_db=6.0, softness_db=2.0, smooth=0.3)
    want = np.asarray(jdenoise.denoise(JAudio(x, 16000), **kw).samples)
    got = tdenoise.denoise(TAudio(x, 16000), device="cpu", **kw).samples
    assert np.max(np.abs(got - want)) < 1e-5 * np.max(np.abs(x))


def test_denoise_cleans_the_gaps():
    """The tone stays, the noise between drops (as the JAX package's
    tests/test_aligners.py asks of its own)."""
    rate = 22050
    x = _tone_and_noise(rate, 9)
    y = tdenoise.denoise(TAudio(x, rate), device="cpu").samples
    t = np.arange(x.size) / rate
    gap = (t < 0.4) | (t > 1.6)
    assert np.mean(y[gap] ** 2) < 0.5 * np.mean(x[gap] ** 2)


def test_silence_stays_silent():
    out = tdenoise.denoise(TAudio(np.zeros(22050), 22050), device="cpu")
    assert np.abs(out.samples).max() < 1e-6


def test_quantile_matches_jnp_quantile():
    rng = np.random.default_rng(2)
    x = np.abs(rng.normal(size=(33, 347))).astype(np.float32)
    for q in (0.1, 0.5, 0.93):
        want = np.asarray(jnp.quantile(jnp.asarray(x), q, axis=-1, keepdims=True))
        got = tdenoise._quantile_linear(torch.from_numpy(x), q).numpy()
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) <= 1e-6 * np.max(x)


def _jax_ema(mask, smooth):
    """The JAX package's smoothing, as audio/denoise.py:_denoise_core
    writes it (a lax.scan over frames, backward then forward)."""

    def ema(m):
        def step(prev, cur):
            v = smooth * prev + (1 - smooth) * cur
            return v, v

        _, out = jax.lax.scan(step, m[:, 0], m.T[1:])
        return jnp.concatenate([m[:, :1], out.T], axis=1)

    return np.asarray(jax.jit(lambda m: ema(ema(m[:, ::-1])[:, ::-1]))(jnp.asarray(mask)))


@pytest.mark.parametrize("shape", [(513, 347), (7, 1), (33, 2), (40, 65)])
def test_mask_ema_plain_matches_the_jax_scan(shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    m = rng.uniform(size=shape).astype(np.float32)
    m[:, ::7] = 0.0  # exact zeros and tiny values, as a gate's mask holds
    m[::5, 1::9] = 1e-30
    got = mask_ema.mask_ema_plain(torch.from_numpy(m), 0.5).numpy()
    assert np.array_equal(got, _jax_ema(m, 0.5))


def test_mask_ema_plain_other_smooth():
    m = np.random.default_rng(1).uniform(size=(64, 200)).astype(np.float32)
    got = mask_ema.mask_ema_plain(torch.from_numpy(m), 0.3).numpy()
    assert np.max(np.abs(got - _jax_ema(m, 0.3))) < 1e-6


def test_mask_ema_wrapper_takes_the_plain_version_on_the_cpu():
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing; it refuses other dtypes, shapes and devices."""
    m = torch.rand(9, 40)
    before = mask_ema.launches
    assert torch.equal(mask_ema.mask_ema(m), mask_ema.mask_ema_plain(m))
    assert mask_ema.launches == before
    with pytest.raises(TypeError):
        mask_ema.mask_ema(m.double())
    with pytest.raises(ValueError):
        mask_ema.mask_ema(m[None])
    with pytest.raises(ValueError, match="unsupported device"):
        mask_ema.mask_ema(torch.empty((9, 40), device="meta"))


def test_denoise_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdenoise.denoise(TAudio(np.zeros(4410, np.float32), 44100))
