"""``PitchParams.sinc_refine_steps > 0`` in the port against the JAX package
on the CPU: the parabolic lags of kernel A's plain version, then Newton steps
on the Hann-windowed sinc interpolant of r (the JAX package's
``_sinc_refine``), the interpolant's value as the strength.

The Newton step is -r'(τ)/r''(τ), sums of 33 products each, and the
two sides evaluate sin, cos and the sums in other roundings (XLA's
vectorised sin/cos on one side). Where the peak is well curved the lags
agree within 1e-3 samples; where it is flat (r within ~1e-4 of 1 over a
sample, as on the steady stretches of these voices), float32 cannot place
its maximum closer than the rounding of r' over r'', and the two sides
stop up to a few hundredths of a sample apart (once a whole sample: one
candidate of 259 whose second step went the other way) with values equal
within 1e-5. Measured on four voices at 1 and 2 steps: 94.2–96.7 % of the
candidates within 1e-3 samples, their F0 within 2.2e-4 relative but for
that one (3.7e-3). So the candidates are held to: lags within 1e-3 samples
on at least 90 %, F0 within 1e-3 relative and strengths within 1e-4 on at
least 99 %; on one r for both sides, lags within 1e-3 samples and values
within 1e-5 on at least 98 % (98.96 % and 99.48 % measured at 2 steps). The path
finder's track is held as the parabolic one is
(``tests/test_torch_pitch.py``): equal voicing and F0 within 1e-3 relative
on at least 99.5 % of frames, the voiced median within 1e-3 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prosody_control_french_tts_tpu.ops import pitch as jp
from prosody_control_french_tts_tpu_torch.ops import pitch as tp

SR = 44100


def _speechlike(seed, seconds=1.5, lead=0.2, f_mid=140.0):
    """A harmonic source with a gliding F0, noise and a silent lead-in."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = f_mid + 60 * np.sin(2 * np.pi * 0.8 * t)
    ph = 2 * np.pi * np.cumsum(f0) / SR
    x = sum(np.sin(h * ph) / h for h in range(1, 8)) * 0.3 + 0.01 * rng.normal(size=n)
    x[: int(lead * SR)] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("steps", [1, 2])
def test_refined_candidates_match_jax(steps):
    x = _speechlike(11)
    T = x.shape[0]
    pj, pt = jp.PitchParams(sinc_refine_steps=steps), tp.PitchParams(sinc_refine_steps=steps)
    fj, sj, _, vj = (np.asarray(a) for a in jp._pitch_frames(jnp.asarray(x), SR, T, pj))
    ft, st, _, vt = (a[0].numpy() for a in tp._pitch_frames(torch.from_numpy(x)[None], SR, T, pt))
    np.testing.assert_array_equal(vt, vj)
    both = (fj > 0) & (ft > 0)
    assert both.sum() > 100 and ((fj > 0) == (ft > 0)).mean() >= 0.995
    lag_err = np.abs(SR / ft[both] - SR / fj[both])
    assert (lag_err <= 1e-3).mean() >= 0.9, lag_err
    close = np.isclose(ft[both], fj[both], rtol=1e-3, atol=0) & np.isclose(st[both], sj[both], rtol=0, atol=1e-4)
    assert close.mean() >= 0.99, close.mean()
    # the refinement moved the lags off the parabola
    fp, _, _, _ = (a[0].numpy() for a in tp._pitch_frames(torch.from_numpy(x)[None], SR, T, tp.PitchParams()))
    moved = np.abs(SR / ft[both] - SR / fp[both])
    assert np.median(moved) > 1e-3


def test_sinc_refine_matches_jax_on_the_same_r():
    """The refinement alone, on one r for both sides (cosine rows, lags near
    their peaks): lags within 1e-3 samples and values within 1e-5 on at
    least 98 % of entries, every lag within a sample of its start."""
    rng = np.random.default_rng(3)
    L = 300
    t = np.arange(L, dtype=np.float32)
    r = np.stack([np.cos(2 * np.pi * t / p) * np.exp(-t / 900) for p in rng.uniform(40, 140, size=64)]).astype(np.float32)
    lag0 = np.stack([p * np.arange(1, 4) for p in rng.uniform(40, 90, size=64)]).astype(np.float32)
    lag0 += rng.uniform(-0.4, 0.4, size=lag0.shape).astype(np.float32)
    jl, jv = jax.vmap(lambda rf, lf: jp._sinc_refine(rf, lf, 2, 16))(jnp.asarray(r), jnp.asarray(lag0))
    tl, tv = tp._sinc_refine(torch.from_numpy(r), torch.from_numpy(lag0), 2, 16)
    assert (np.abs(tl.numpy() - np.asarray(jl)) <= 1e-3).mean() >= 0.98
    assert (np.abs(tv.numpy() - np.asarray(jv)) <= 1e-5).mean() >= 0.98
    assert (np.abs(tl.numpy() - lag0) <= 1.0 + 1e-6).all()


@pytest.mark.parametrize("seed,f_mid", [(4, 140.0), (5, 220.0)])
def test_praat_pitch_sinc_matches_jax(seed, f_mid):
    """The refined track: ≥ 99.5 % of frames with equal voicing and F0 within
    1e-3 relative, the voiced median within 1e-3 relative."""
    x = _speechlike(seed, seconds=1.2, f_mid=f_mid)
    tj = jp.praat_pitch(x, SR, jp.PitchParams(sinc_refine_steps=2))
    tt = tp.praat_pitch(x, SR, tp.PitchParams(sinc_refine_steps=2), device="cpu")
    fj, ft = np.asarray(tj.f0), tt.f0.numpy()
    agree = ((fj == 0) & (ft == 0)) | np.isclose(ft, fj, rtol=1e-3, atol=0)
    assert agree.mean() >= 0.995, agree.mean()
    assert (fj > 0).sum() > 10
    mj, mt = np.median(fj[fj > 0]), np.median(ft[ft > 0])
    assert abs(mt - mj) <= 1e-3 * mj
    # and the refined track is not the parabolic one
    fp = tp.praat_pitch(x, SR, device="cpu").f0.numpy()
    assert not np.array_equal(fp, ft)
