"""The port's log-mel front end and DTW against the JAX package's, on the CPU.

``log_mel``: the JAX package takes the power spectrum as split-precision
products (about 1e-5 relative), the port as float32 products; the two agree
within 1e-3 in the scaled log units (max; measured 3.2e-4) and 2e-5 on
average (measured 7e-6). The DTW and the token↔frame partition DP add in
the XLA CPU order (``ops.dtw.blocked_cumsum``), so their matrices, spans
and paths are held bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosody_control_french_tts_tpu.align.synth_speech import synth_sentence
from prosody_control_french_tts_tpu.ops import dtw as jdtw
from prosody_control_french_tts_tpu.ops.stft import log_mel as jlog_mel
from prosody_control_french_tts_tpu_torch.ops import dtw as tdtw
from prosody_control_french_tts_tpu_torch.ops.stft import log_mel as tlog_mel

TOL_MEL_MAX, TOL_MEL_MEAN = 1e-3, 2e-5


def _speech_and_noise():
    a, _ = synth_sentence("la musique commence demain matin", seed=444_000)
    noise = (np.random.default_rng(0).standard_normal(a.shape[0]) * 0.1).astype(np.float32)
    return np.stack([a, noise]).astype(np.float32)


@pytest.mark.parametrize("batched", [False, True])
def test_log_mel_matches_jax(batched):
    x = _speech_and_noise()
    x = x if batched else x[0]
    want = np.asarray(jlog_mel(jnp.asarray(x), 16000, n_fft=400, hop_length=160, n_mels=80))
    got = tlog_mel(torch.from_numpy(x), 16000, n_fft=400, hop_length=160, n_mels=80).numpy()
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert err.max() <= TOL_MEL_MAX and err.mean() <= TOL_MEL_MEAN, (err.max(), err.mean())


@pytest.mark.parametrize("n", [1, 7, 16, 17, 100, 256, 513, 1500])
def test_blocked_cumsum_is_the_xla_cumsum(n):
    x = (np.random.default_rng(n).standard_normal((4, n)) * np.random.default_rng(n + 1).uniform(0, 1, (4, n)))
    x = x.astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(tdtw.blocked_cumsum(torch.from_numpy(x)).numpy(), want)


def _attention_costs(B, L, F, seed):
    """Normalised random attention rows, negated, as the aligner's costs."""
    w = np.random.default_rng(seed).uniform(0, 1, (B, L, F)).astype(np.float32) ** 4
    return -(w / w.sum(-1, keepdims=True))


def _diagonal_costs(n_tok=4, n_fr=40, F=64, L=16):
    """tests/test_aligners.py's synthetic cross-attention: token i attends
    to frames [10i, 10i + 10); padded to [L, F] with zero costs."""
    c = np.zeros((1, L, F), np.float32)
    for i in range(n_tok):
        c[0, i, 10 * i : 10 * i + 10] = -0.1
    return c


@pytest.mark.parametrize("shape", [(3, 16, 256), (2, 5, 37), (4, 32, 512)])
def test_partition_costs_and_backtrack_equal(shape):
    cost = _attention_costs(*shape, seed=sum(shape))
    want = np.asarray(jdtw.monotonic_partition_costs_batched(jnp.asarray(cost)))
    got = tdtw.monotonic_partition_costs_batched(torch.from_numpy(cost)).numpy()
    np.testing.assert_array_equal(got, want)
    one = tdtw.monotonic_partition_costs(torch.from_numpy(cost[0])).numpy()
    np.testing.assert_array_equal(one, np.asarray(jdtw.monotonic_partition_costs(jnp.asarray(cost[0]))))
    for b in range(shape[0]):
        nt, nf = shape[1] - b, shape[2] - 3 * b
        np.testing.assert_array_equal(tdtw.monotonic_partition_backtrack(got[b, : nt + 1, : nf + 1]),
                                      jdtw.monotonic_partition_backtrack(want[b, : nt + 1, : nf + 1]))


@pytest.mark.parametrize("case", ["random", "diagonal"])
def test_partition_spans_batched_equal(case):
    """Spans with padded token and frame counts, every item equal."""
    if case == "random":
        cost = _attention_costs(4, 32, 512, seed=3)
        n_tok = np.array([32, 29, 2, 1], np.int32)
        n_fr = np.array([512, 462, 30, 7], np.int32)
    else:
        cost = _diagonal_costs()
        n_tok, n_fr = np.array([4], np.int32), np.array([40], np.int32)
    want = np.asarray(jdtw.monotonic_partition_spans_batched(jnp.asarray(cost), jnp.asarray(n_tok), jnp.asarray(n_fr)))
    got = tdtw.monotonic_partition_spans_batched(torch.from_numpy(cost), torch.from_numpy(n_tok), torch.from_numpy(n_fr))
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "diagonal":
        assert got[0, :4].tolist() == [[0, 10], [10, 20], [20, 30], [30, 40]]


def test_dtw_distance_and_path_equal():
    rng = np.random.default_rng(5)
    for n, m in ((50, 70), (1, 9), (33, 33)):
        a, b = rng.standard_normal(n).astype(np.float32), rng.standard_normal(m).astype(np.float32)
        assert tdtw.dtw_distance(a, b, device="cpu") == jdtw.dtw_distance(a, b)
        assert tdtw.dtw_path(a, b, device="cpu") == jdtw.dtw_path(a, b)
