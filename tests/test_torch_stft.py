"""The PyTorch port's STFT family (``ops/stft.py``) against the JAX
package's, on the same seeded float32 signals, on the CPU.

Tolerances: complex STFT and the overlap-add inverse within 1e-5 of the
largest |value| (both sides run a float32 real FFT, in other libraries);
the power spectrogram within 1e-5 of its maximum, in dB within 1e-3 dB
wherever the bin is above −100 dB of the maximum; the mel filterbank
(numpy on both sides) exactly.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prosody_control_french_tts_tpu_torch.ops import stft as tstft

jstft = importlib.import_module("prosody_control_french_tts_tpu.ops.stft")

GEOMS = [(1024, 256), (400, 160)]
LENGTHS = [30001, 4097, 301]  # odd; the last shorter than n_fft / 2 at 1024 (reflection past the edge)
REL = 1e-5


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * rng.normal(size=n) + 0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


@pytest.mark.parametrize("n_fft,hop", GEOMS)
@pytest.mark.parametrize("n", LENGTHS)
def test_stft_matches_jax(n_fft, hop, n):
    x = _signal(n, n)
    want = np.asarray(jstft.stft(jnp.asarray(x), n_fft, hop))
    got = tstft.stft(torch.from_numpy(x), n_fft, hop).numpy()
    assert got.shape == want.shape == (1 + n_fft // 2, 1 + n // hop)
    assert _rel(want, got) < REL


def test_stft_batched_rows_and_no_centre():
    x = np.stack([_signal(5000, 1), _signal(5000, 2)])
    got = tstft.stft(torch.from_numpy(x), 1024, 256, center=False).numpy()
    want = np.asarray(jstft.stft(jnp.asarray(x), 1024, 256, center=False))
    assert got.shape == want.shape
    assert _rel(want, got) < REL


@pytest.mark.parametrize("n_fft,hop", GEOMS)
@pytest.mark.parametrize("n", LENGTHS)
def test_istft_overlap_add_matches_jax(n_fft, hop, n):
    """The same spectrum into both inverses."""
    spec = np.array(jstft.stft(jnp.asarray(_signal(n, n + 1)), n_fft, hop))
    want = np.asarray(jstft.istft_overlap_add(jnp.asarray(spec), n_fft, hop, n))
    got = tstft.istft_overlap_add(torch.from_numpy(spec), n_fft, hop, n).numpy()
    assert got.shape == want.shape == (n,)
    assert _rel(want, got) < REL


@pytest.mark.parametrize("n_fft,hop", GEOMS)
def test_round_trip(n_fft, hop):
    """stft then istft gives the signal back away from the edges (as the
    JAX package's tests/test_separator.py checks its own)."""
    x = _signal(30001, 5)
    y = tstft.istft_overlap_add(tstft.stft(torch.from_numpy(x), n_fft, hop), n_fft, hop, x.size).numpy()
    assert np.max(np.abs(y[n_fft:-n_fft] - x[n_fft:-n_fft])) < 1e-4


def test_overlap_add_sums_from_the_earliest_frame():
    """Frames whose sums are order-sensitive in float32: the result equals a
    sequential scatter-add over the frames, bit for bit."""
    rng = np.random.default_rng(3)
    frames = (rng.normal(size=(9, 10)) * 10.0 ** rng.integers(-6, 6, size=(9, 10))).astype(np.float32)
    want = np.zeros(44, np.float32)
    for f in range(9):
        for j in range(10):
            want[f * 4 + j] += frames[f, j]
    got = tstft._overlap_add(torch.from_numpy(frames), 4, 44).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_fft,hop", GEOMS)
def test_spectrogram_matches_jax(n_fft, hop):
    x = _signal(12001, 7)
    want = np.asarray(jstft.spectrogram(jnp.asarray(x), n_fft, hop, db=False))
    got = tstft.spectrogram(torch.from_numpy(x), n_fft, hop, db=False).numpy()
    assert _rel(want, got) < REL
    want_db = np.asarray(jstft.spectrogram(jnp.asarray(x), n_fft, hop))
    got_db = tstft.spectrogram(torch.from_numpy(x), n_fft, hop).numpy()
    live = want_db > -100.0
    assert live.mean() > 0.9
    assert np.max(np.abs(want_db - got_db)[live]) < 1e-3


@pytest.mark.parametrize("sr,n_fft,n_mels,fmax", [(16000, 400, 80, None), (44100, 1024, 128, 8000.0), (22050, 1024, 40, None)])
def test_mel_filterbank_equal(sr, n_fft, n_mels, fmax):
    want = jstft.mel_filterbank(sr, n_fft, n_mels, fmax=fmax)
    got = tstft.mel_filterbank(sr, n_fft, n_mels, fmax=fmax)
    assert got.dtype == np.float32
    assert np.array_equal(got, want)
