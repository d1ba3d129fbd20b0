"""The PyTorch port's frame gather (TPU kernels C and D) and chunk cumsum
(TPU kernel E) against the JAX package's Pallas kernels in interpret mode.

Inputs are made with numpy from a seed and handed to both sides. On the CPU
the port's wrappers run their plain versions; the CUDA kernels are held
against those plain versions on the card in test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prosody_control_french_tts_tpu.ops import pallas_kernels as jpk
from prosody_control_french_tts_tpu_torch.ops import chunk_cumsum as tcc, frames as tfr


def _hann(W):
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(W) / W)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


EDGES = lambda T, W: np.array([0, 1, 1023, 1024, 1025, 2047, 2048, T - W], np.int32)  # noqa: E731


def test_extract_frames_matches_jax_kernel_c():
    """Kernel C, the JAX test's shape (T 8192, W 256, F 37): 1e-6, the JAX
    kernel's own bound against its gather."""
    rng = np.random.default_rng(11)
    T, W, F = 8192, 256, 37
    x = rng.normal(size=T).astype(np.float32)
    starts = rng.integers(0, T - W, size=F).astype(np.int32)
    win = _hann(W)
    want = np.asarray(jpk.extract_frames(jnp.asarray(x), jnp.asarray(starts), jnp.asarray(win), W, interpret=True))
    got = tfr.extract_frames(_t(x), _t(starts), _t(win), W).numpy()
    assert got.shape == (F, W)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn", ["extract_frames_aligned", "extract_frames"])
def test_frames_match_jax_kernel_d_exactly(fn):
    """Kernel D at the production window (T 50,000, W 880) with the
    alignment-edge starts: equal bit for bit (both wrappers share one
    kernel, so both are held to D)."""
    rng = np.random.default_rng(12)
    T, W, F = 50000, 880, 37
    x = rng.normal(size=T).astype(np.float32)
    edges = EDGES(T, W)
    starts = np.concatenate([edges, rng.integers(0, T - W, size=F - edges.size)]).astype(np.int32)
    win = _hann(W)
    want = np.asarray(jpk.extract_frames_aligned(jnp.asarray(x), jnp.asarray(starts), jnp.asarray(win), W, interpret=True))
    got = getattr(tfr, fn)(_t(x), _t(starts), _t(win), W).numpy()
    assert np.array_equal(got, want)


def test_frames_op_matches_jax_under_vmap():
    """frames_op over B 2 rows against the JAX dispatcher under vmap:
    exactly."""
    rng = np.random.default_rng(13)
    B, T, W, F = 2, 8192, 256, 37
    x = rng.normal(size=(B, T)).astype(np.float32)
    starts = rng.integers(0, T - W, size=(B, F)).astype(np.int32)
    win = _hann(W)
    jwin = jnp.asarray(win)
    want = np.asarray(jax.vmap(lambda a, s: jpk.frames_op(a, s, jwin, W))(jnp.asarray(x), jnp.asarray(starts)))
    got = tfr.frames_op(_t(x), _t(starts), _t(win), W).numpy()
    assert got.shape == (B, F, W)
    assert np.array_equal(got, want)


def test_frames_plain_clips_like_the_reference():
    """Outside the contract domain the port keeps the reference gather's
    clip(start + j, 0, T − 1)."""
    rng = np.random.default_rng(14)
    T, W = 1000, 64
    x = rng.normal(size=T).astype(np.float32)
    starts = np.array([-5, 0, T - W, T - 10, T + 3], np.int32)
    win = _hann(W)
    want = np.asarray(jpk.extract_frames_reference(jnp.asarray(x), jnp.asarray(starts), jnp.asarray(win), W))
    assert np.array_equal(tfr.extract_frames_plain(_t(x), _t(starts), _t(win)).numpy(), want)


def test_chunk_cumsum_matches_jax_kernel_e_exactly():
    """Kernel E's plain version repeats the TPU kernel's shift-add ladder:
    equal bit for bit to the Pallas kernel in interpret mode, and within
    2e-3 of numpy's sequential cumsum (the JAX test's bound)."""
    x = np.random.default_rng(3).normal(size=(16, 4 * 1024)).astype(np.float32)
    want = np.asarray(jpk.chunk_cumsum(jnp.asarray(x), interpret=True))
    got = tcc.chunk_cumsum(_t(x)).numpy()
    assert np.array_equal(got, want)
    xr = x.reshape(16, 4, 1024)
    ref = (np.cumsum(xr, axis=-1) - xr).reshape(16, 4 * 1024)
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_chunk_cumsum_matches_jax_on_squared_audio():
    """Kernel E on x² of a speech-like signal (its intended use): exact."""
    rng = np.random.default_rng(4)
    t = np.arange(8 * 3 * 1024) / 44100.0
    x = (0.4 * np.sin(2 * np.pi * 180 * t) + 0.003 * rng.normal(size=t.size)).astype(np.float32)
    x2 = np.square(x).reshape(8, 3 * 1024)
    want = np.asarray(jpk.chunk_cumsum(jnp.asarray(x2), interpret=True))
    assert np.array_equal(tcc.chunk_cumsum_plain(_t(x2)).numpy(), want)


@pytest.mark.parametrize(
    "shape,dtype,exc",
    [((12, 1024), torch.float32, ValueError), ((8, 1000), torch.float32, ValueError),
     ((8 * 1024,), torch.float32, ValueError), ((8, 1024), torch.float64, TypeError),
     ((0, 1024), torch.float32, ValueError)],
)
def test_chunk_cumsum_refuses_bad_shapes(shape, dtype, exc):
    with pytest.raises(exc):
        tcc.chunk_cumsum(torch.zeros(shape, dtype=dtype))


def test_frames_refuse_bad_arguments():
    x = torch.zeros(100)
    s = torch.zeros(3, dtype=torch.int32)
    w = torch.ones(8)
    with pytest.raises(TypeError):
        tfr.frames_op(x, s.long(), w)
    with pytest.raises(TypeError):
        tfr.frames_op(x.double(), s, w)
    with pytest.raises(ValueError):
        tfr.extract_frames(x, s, w, 9)
    with pytest.raises(ValueError):
        tfr.extract_frames_aligned(torch.zeros(2, 100), torch.zeros(3, 4, dtype=torch.int32), w)
    with pytest.raises(ValueError):
        tfr.frames_op(x, s[None], w)
