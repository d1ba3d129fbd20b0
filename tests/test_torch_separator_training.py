"""The training half of the port's MaskNet separator
(``audio/separate.py``) against the JAX package's, on the same inputs.

The mixtures are host numpy in both packages, so the beds, the pairs and
SI-SNR are held bit for bit. The STFT magnitudes of ``_prep_batches`` are
held to 1e-6 of the largest (float32 DFTs in other libraries), the valid
masks exactly. One train step from the converted flax initialisation: the
power-compressed loss to 1e-4 relative and each parameter's gradient to a
cosine of 0.999 (MaskNet's bfloat16 convolutions round in other places in
XLA and PyTorch). The recipe itself runs tiny (four mixtures, one epoch,
its gates set so that they cannot fail at that size) and writes a float16
checkpoint in the JAX layout that the JAX separator loads; the masks of
the two agree within MaskNet's inference limit (0.02, as in
``test_torch_separate.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prosody_control_french_tts_tpu.audio import separate as J
from prosody_control_french_tts_tpu_torch import convert
from prosody_control_french_tts_tpu_torch.audio import separate as T
from prosody_control_french_tts_tpu_torch.models.schedules import ScheduledAdam, cosine_decay_schedule


def _equal_pairs(a, b):
    return len(a) == len(b) and all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) for x, y in zip(a, b))


def test_synth_music_is_bit_equal():
    assert np.array_equal(T.synth_music(2.1, seed=3), J.synth_music(2.1, seed=3))
    assert T.BED_KINDS == J.BED_KINDS


@pytest.mark.parametrize("kind", J.BED_KINDS)
def test_synth_bed_is_bit_equal(kind):
    assert np.array_equal(T.synth_bed(1.7, seed=11, kind=kind), J.synth_bed(1.7, seed=11, kind=kind))
    with pytest.raises(ValueError):
        T.synth_bed(1.0, kind="rain")


def test_mix_and_si_snr_are_equal():
    rng = np.random.default_rng(0)
    speech, bed = rng.standard_normal(8000).astype(np.float32), rng.standard_normal(9000).astype(np.float32)
    assert np.array_equal(T._mix_at_snr(speech, bed, 3.5), J._mix_at_snr(speech, bed, 3.5))
    est = speech + 0.3 * rng.standard_normal(8000).astype(np.float32)
    assert T.si_snr_db(est, speech) == J.si_snr_db(est, speech)


@pytest.mark.parametrize("realistic", [False, True])
def test_make_pairs_are_bit_equal(realistic):
    """realistic=True without the real corpus: both fall back to synthetic
    vocals (the JAX package's default corpus directory is absent here)."""
    assert T.real_speech_windows() == [] and J.real_speech_windows() == []
    assert _equal_pairs(T._make_pairs(3, 9, realistic=realistic), J._make_pairs(3, 9, realistic=realistic))


@pytest.fixture(scope="module")
def batches():
    pairs = J._make_pairs(4, 3, realistic=False)
    return J._prep_batches(pairs, 2), T._prep_batches(pairs, 2)


def test_prep_batches_match_jax(batches):
    (jm, jc, jv), (tm, tc, tv) = batches
    assert jm.shape == tm.shape and np.array_equal(jv, tv)
    assert np.abs(jm - tm).max() <= 1e-6 * np.abs(jm).max()
    assert np.abs(jc - tc).max() <= 1e-6 * np.abs(jc).max()


def test_train_step_matches_jax(batches):
    (mix, clean, valid), _ = batches
    jm = J.MaskNet(dim=32, layers=2)
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((16, 513)))
    tm = T.MaskNet(dim=32, layers=2)
    tm.load_state_dict(convert.masknet_params_from_jax(jax.tree.map(np.asarray, jp)))

    def jloss(p, m, c, v):  # audio/separate.py:451-459
        mask = jm.apply(p, jnp.log10(m + 1e-6))
        comp = lambda z: jnp.power(z + 1e-4, 0.3)  # noqa: E731
        err = (comp(mask * m) - comp(c)) * v[..., None]
        return jnp.sum(err * err) / jnp.maximum(jnp.sum(v) * m.shape[-1], 1)

    grad_fn = jax.jit(jax.value_and_grad(jloss))
    tx = optax.adam(optax.cosine_decay_schedule(3e-4, 4, alpha=0.05))
    opt, p = tx.init(jp), jp
    topt = ScheduledAdam(tm.parameters(), cosine_decay_schedule(3e-4, 4, alpha=0.05))
    for i in range(2):
        idx = np.array([i % 2, (i + 1) % 2])
        loss, g = grad_fn(p, mix[idx], clean[idx], valid[idx])
        upd, opt = tx.update(g, opt)
        p = optax.apply_updates(p, upd)
        m, c, v = (torch.from_numpy(np.asarray(a)) for a in (mix[idx], clean[idx], valid[idx]))
        topt.zero_grad()
        tl = T.masknet_loss(tm(torch.log10(m + 1e-6)), m, c, v)
        tl.backward()
        assert float(tl) == pytest.approx(float(loss), rel=1e-4)
        jg = convert.masknet_params_from_jax(jax.tree.map(np.asarray, g))
        for k, w in tm.named_parameters():
            a, b = w.grad.flatten().double(), jg[k].flatten().double()
            assert float(a @ b / (a.norm() * b.norm())) > 0.999, k
        topt.step()


def test_tiny_pretrain_writes_a_checkpoint_jax_loads(tmp_path):
    out = tmp_path / "masknet.npz"
    sep, gain = T.pretrain_masknet(out, n_mixtures=4, epochs=1, batch=2, seed=1, realistic=False,
                                   target_si_snr_gain_db=-1e9, device="cpu")
    assert np.isfinite(gain) and len(sep.losses) == 1 and np.isfinite(sep.losses[0])
    data = np.load(out)
    assert all(data[k].dtype == np.float16 for k in data.files)
    assert sorted(data.files) == sorted(np.load(J.PACKAGED_WEIGHTS).files)
    js = J.MaskSeparator(weights_path=out)
    ts = T.MaskSeparator(weights_path=out, device="cpu")
    x = np.random.default_rng(2).standard_normal((40, 513)).astype(np.float32)
    want = np.asarray(js.model.apply(js.params, jnp.asarray(x)))
    with torch.no_grad():
        got = ts.model(torch.from_numpy(x)).numpy()
    assert np.abs(want - got).max() <= 0.02
