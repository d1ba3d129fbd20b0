"""The PyTorch port's ops against the JAX package: kernel A's and kernel B's
plain versions, prefix sums, range maxima, PCM and loudness.

Inputs are made with numpy from a seed and handed to both sides as numpy
arrays. Each comparison states its tolerance. The kernels themselves are
held against these plain versions on the card in test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prosody_control_french_tts_tpu.ops import cumsum as jcs, loudness as jl, pcm as jpcm, rangemax as jrm
from prosody_control_french_tts_tpu.ops import pitch as jp
from prosody_control_french_tts_tpu.ops.pallas_kernels import topk_parabolic as j_topk
from prosody_control_french_tts_tpu.ops.viterbi_pallas import viterbi_pallas_batched
from prosody_control_french_tts_tpu_torch.ops import candidates, cumsum as tcs, loudness as tl, pcm as tpcm
from prosody_control_french_tts_tpu_torch.ops import pitch as tp, rangemax as trm

from test_torch_kernels import K_CAND, MAX_LAG, MIN_LAG, VTH, candidate_fixtures

SR = 44100


# ---------------------------------------------------------------------------
# kernel A: pitch candidates
# ---------------------------------------------------------------------------

def _jax_xla_stage(r, k, min_lag, max_lag, vth):
    """The JAX package's XLA candidate stage (ops/pitch.py _pitch_frames),
    with its iterated first-index top-k, zeroed where invalid."""
    r = jnp.asarray(r)
    L = r.shape[-1]
    lag = jnp.arange(L)
    interior = (lag >= min_lag) & (lag < max_lag)
    r_m1 = jnp.concatenate([r[:, :1], r[:, :-1]], axis=-1)
    r_p1 = jnp.concatenate([r[:, 1:], r[:, -1:]], axis=-1)
    is_max = (r > r_m1) & (r >= r_p1) & (r > 0.5 * vth) & interior[None, :]
    top_val, top_lag = jp._top_k(jnp.where(is_max, r, -jnp.inf), k, force="iter")
    valid = jnp.isfinite(top_val)
    safe = jnp.clip(top_lag, 1, L - 2)
    rv = jnp.take_along_axis(r, safe, axis=-1)
    rl = jnp.take_along_axis(r, safe - 1, axis=-1)
    rr = jnp.take_along_axis(r, safe + 1, axis=-1)
    dr = 0.5 * (rr - rl)
    d2r = 2.0 * rv - rl - rr
    off = jnp.where(jnp.abs(d2r) > 1e-12, dr / d2r, 0.0)
    lag_f = safe.astype(jnp.float32) + jnp.clip(off, -1.0, 1.0)
    st = rv + 0.5 * dr * off
    return [np.asarray(a) for a in (jnp.where(valid, lag_f, 0.0), jnp.where(valid, st, 0.0), valid)]


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla_stage"])
def test_candidates_plain_matches_jax(reference):
    """valid equal; lag_f within 1e-5 and strength within 1e-6 (the JAX
    kernel's own tolerances against its XLA stage: the same float32
    operations, compiled by different compilers)."""
    r = candidate_fixtures(3)
    if reference == "pallas_interpret":
        out = j_topk(jnp.asarray(r), K_CAND, MIN_LAG, MAX_LAG, VTH, interpret=True)
        lag_j, str_j, val_j = (np.asarray(a) for a in out)
    else:
        lag_j, str_j, val_j = _jax_xla_stage(r, K_CAND, MIN_LAG, MAX_LAG, VTH)
    lag_t, str_t, val_t = candidates.topk_parabolic(torch.from_numpy(r), K_CAND, MIN_LAG, MAX_LAG, VTH)
    np.testing.assert_array_equal(val_t.numpy(), val_j)
    np.testing.assert_allclose(lag_t.numpy(), lag_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(str_t.numpy(), str_j, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# kernel B: the Viterbi path finder
# ---------------------------------------------------------------------------


def _tone_batch(seed):
    """The JAX package's path-finder fixture: three 1.1 s two-harmonic tones
    with noise and a silent lead-in (voiced/unvoiced transitions)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * 1.1)) / SR
    sigs = []
    for f in (170.0, 230.0, 320.0):
        x = 0.5 * np.sin(2 * np.pi * f * t) + 0.2 * np.sin(4 * np.pi * f * t)
        x = x + 0.05 * rng.normal(size=t.size)
        x[: SR // 5] = 0.0
        sigs.append(x.astype(np.float32))
    return np.stack(sigs)


def _jax_candidates(X):
    pp = jp.PitchParams()
    g = jp._geometry(X.shape[1], SR, pp)
    freq, st, inten, _ = jax.vmap(lambda a: jp._pitch_frames(a, SR, X.shape[1], pp))(jnp.asarray(X))
    return pp, g, freq, st, inten


def _port_path(freq, st, inten, dt):
    pp = tp.PitchParams()
    return tp.viterbi_batched(
        torch.from_numpy(np.array(freq)), torch.from_numpy(np.array(st)),
        torch.from_numpy(np.array(inten)), pp, dt,
    ).numpy()


@pytest.mark.parametrize("reference", ["sequential", "pallas_interpret"])
def test_viterbi_plain_matches_jax(reference):
    """Every frame equal: the same candidates go through the same recurrence
    (the jump cost as |lf_j − lf_k| with lf = log2 f, as the Pallas kernel
    writes it)."""
    pp, g, freq, st, inten = _jax_candidates(_tone_batch(7))
    if reference == "sequential":
        want = np.asarray(jax.vmap(lambda f, s, i: jp._viterbi_sequential(f, s, i, pp, g["dt"]))(freq, st, inten))
    else:
        want = np.asarray(viterbi_pallas_batched(freq, st, inten, pp, g["dt"], interpret=True))
    np.testing.assert_array_equal(_port_path(freq, st, inten, g["dt"]), want)


def test_viterbi_plain_matches_sequential_with_silence():
    """A 1.2 s tone with noise and a quarter-second silent lead-in (the
    JAX package's sequential-vs-parallel fixture): every frame equal."""
    rng = np.random.default_rng(11)
    t = np.arange(int(SR * 1.2)) / SR
    x = (0.5 * np.sin(2 * np.pi * 210.0 * t) + 0.05 * rng.normal(size=t.size)).astype(np.float32)
    x[: SR // 4] = 0.0
    pp, g, freq, st, inten = _jax_candidates(x[None])
    want = np.asarray(jp._viterbi_sequential(freq[0], st[0], inten[0], pp, g["dt"]))
    np.testing.assert_array_equal(_port_path(freq, st, inten, g["dt"])[0], want)


# ---------------------------------------------------------------------------
# prefix sums, range maxima, PCM
# ---------------------------------------------------------------------------


def test_chunked_cumsum_matches_jax():
    """Prefix and range sums within 1e-5 relative to the signal's total
    energy scale (different compilers sum a chunk in different orders)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 30000)).astype(np.float32) ** 2
    lo = rng.integers(0, 30000, size=(2, 64))
    hi = np.minimum(lo + rng.integers(0, 5000, size=(2, 64)), 30000)
    want = np.asarray(jcs.ChunkedCumsum.build(jnp.asarray(x)).range_sum(jnp.asarray(lo), jnp.asarray(hi)))
    got = tcs.ChunkedCumsum.build(torch.from_numpy(x)).range_sum(torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(x.sum(axis=-1).max()) * 1e-3)


def test_rangemax_matches_jax_exactly():
    """A maximum does not depend on order: equal bit for bit, including empty
    and edge windows."""
    rng = np.random.default_rng(1)
    T = 50000
    x = rng.normal(size=(2, T)).astype(np.float32)
    lo = np.concatenate([rng.integers(0, T, size=(2, 60)), np.array([[0, T], [T - 1, 5]])], axis=1)
    hi = np.concatenate([np.minimum(lo[:, :60] + rng.integers(0, 9000, size=(2, 60)), T), np.array([[T, T], [T, 5]])], axis=1)
    want = np.asarray(jrm.RangeMax.build(jnp.asarray(x)).query(jnp.asarray(lo), jnp.asarray(hi)))
    got = trm.RangeMax.build(torch.from_numpy(x)).query(torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
    np.testing.assert_array_equal(got, want)


def test_pcm_round_trip_matches_jax():
    """The int16 image round-trips exactly and equals the JAX package's."""
    rng = np.random.default_rng(2)
    q = rng.integers(-32768, 32768, size=4096).astype(np.int16)
    x = jpcm.i16_to_f32(q)
    np.testing.assert_array_equal(tpcm.i16_to_f32(q), x)
    np.testing.assert_array_equal(tpcm.i16_to_f32(torch.from_numpy(q)).numpy(), x)
    np.testing.assert_array_equal(tpcm.f32_to_i16_exact(x), q)
    assert tpcm.f32_to_i16_exact(x + np.float32(1e-7)) is None


# ---------------------------------------------------------------------------
# loudness
# ---------------------------------------------------------------------------


def test_k_weight_matches_jax():
    """K-weighted samples within 1e-5 relative to the signal's peak
    (pocketfft under both, with different plans)."""
    rng = np.random.default_rng(3)
    x = (0.3 * rng.normal(size=(2, 24576))).astype(np.float32)
    want = np.asarray(jl.k_weight(jnp.asarray(x), SR, num_samples=24576))
    got = tl.k_weight(torch.from_numpy(x), SR, num_samples=24576).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("rate", [44100, 11025])
def test_windowed_loudness_matches_jax(rate):
    """Grid-cumsum path (44.1 kHz: integer block stride) and fallback path
    (11.025 kHz: 1102.5-sample stride): LUFS within 0.01 dB, validity equal."""
    rng = np.random.default_rng(4)
    T = 3 * rate
    x = (0.2 * rng.normal(size=(2, T)) * np.linspace(0.1, 1.0, T)).astype(np.float32)
    st = rng.integers(0, T // 2, size=(2, 6)).astype(np.int32)
    en = np.minimum(st + rng.integers(rate // 10, 2 * rate, size=(2, 6)), T).astype(np.int32)
    peaks = rng.uniform(0.5, 1.0, size=(2, 6)).astype(np.float32)
    mb = jl.max_blocks_for(T, rate)
    y = np.array(jl.k_weight(jnp.asarray(x), rate))
    lj, vj = jl.windowed_loudness(jnp.asarray(y), rate, jnp.asarray(st), jnp.asarray(en), jnp.asarray(peaks), max_blocks=mb)
    lt, vt = tl.windowed_loudness(torch.from_numpy(y), rate, torch.from_numpy(st), torch.from_numpy(en), torch.from_numpy(peaks), mb)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=0.01)


def test_num_blocks_ties_to_even():
    """pyloudnorm's block count rounds half to even, as Python's round."""
    dur = np.array([0.0, 0.39, 0.4, 0.45, 0.55, 0.65, 1.0], np.float32) * SR
    want = np.asarray(jl._num_blocks(jnp.asarray(dur), SR))
    np.testing.assert_array_equal(tl._num_blocks(torch.from_numpy(dur), SR).numpy(), want)


class TestBS1770Conformance:
    """The analytic EBU-Tech-3341-style vectors of the JAX package's
    conformance tests, on the port: the expected LUFS values are known by
    construction (997 Hz calibration tone), within the same 0.1/0.12 dB."""

    SR = 48000

    def _sine(self, amp, secs, f=997.0, sr=None):
        sr = sr or self.SR
        t = np.arange(int(secs * sr)) / sr
        return (amp * np.sin(2 * np.pi * f * t)).astype(np.float32)

    def _lufs(self, x, sr=None):
        return tl.integrated_loudness(x, sr or self.SR, device="cpu")

    def test_full_scale_sine_is_minus_3(self):
        assert abs(self._lufs(self._sine(1.0, 20)) - (-3.01)) < 0.1

    def test_minus20_sine_tracks_linearly(self):
        assert abs(self._lufs(self._sine(0.1, 20)) - (-23.01)) < 0.1

    def test_absolute_gate_drops_minus72_tails(self):
        a72 = 10 ** ((-72 + 3.01) / 20)
        x = np.concatenate([self._sine(a72, 10), self._sine(0.1, 60), self._sine(a72, 10)])
        assert abs(self._lufs(x) - (-23.0)) < 0.12

    def test_relative_gate_drops_minus36_blocks(self):
        a36 = 10 ** ((-36 + 3.01) / 20)
        x = np.concatenate([self._sine(a36, 10), self._sine(0.1, 60), self._sine(a36, 10)])
        assert abs(self._lufs(x) - (-23.0)) < 0.12

    def test_pipeline_rate_calibration(self):
        assert abs(self._lufs(self._sine(0.1, 20, sr=44100), 44100) - (-23.01)) < 0.1

    def test_short_signal_raises(self):
        with pytest.raises(ValueError):
            self._lufs(self._sine(0.1, 0.3))
