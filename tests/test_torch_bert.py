"""The PyTorch port's break tagger and sentence encoder (``models/bert.py``)
and its trainer (``models/break_trainer.py``) against the JAX package's
flax modules, on the CPU, at small sizes, from the same numpy inputs and the
same (converted) flax initialisation.

Tolerances, measured here and stated:

- ``BreakTagger`` logits within 2e-2 of the flax module run eagerly (each
  operation rounded to its declared type), with the port's gelu rounded op
  by op as XLA rounds it there (``gelu_tanh_bf16``): that holds every
  rounding point of the flax model (measured: at most 3.5e-3).
- The JAX package runs the tagger jitted, and XLA then keeps excess
  precision inside its fused elementwise chains: its jitted and eager
  forwards of the same parameters disagree by up to 3.4e-2 at these sizes
  (measured over three seeds per geometry). The shipped port (its ``gelu``
  rounds once, ``F.gelu``) is held to the jitted forward within 6e-2
  (measured: at most 4.1e-2), and to the same BREAK decision wherever the
  flax margin |l1 − l0| exceeds 0.05;
- ``SentenceEncoder`` embeddings: cosine ≥ 0.9999 (measured ≥ 0.999995);
- ``cross_entropy_loss`` within 1e-6;
- ``train_tagger`` at dropout 0.0 over 5 AdamW steps: the losses within
  1e-2 relative;
- ``evaluate_tagger``: equal metrics from equal logits.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prosody_control_french_tts_tpu.models import bert as jbert
from prosody_control_french_tts_tpu.models import break_trainer as jtrainer
from prosody_control_french_tts_tpu.models.datasets import BreakTagDataset as JDataset
from prosody_control_french_tts_tpu_torch import convert
from prosody_control_french_tts_tpu_torch.audio.separate import gelu_tanh_bf16
from prosody_control_french_tts_tpu_torch.models import bert as tbert
from prosody_control_french_tts_tpu_torch.models import break_trainer as ttrainer
from prosody_control_french_tts_tpu_torch.models.datasets import BreakTagDataset as TDataset

TOL_LOGITS = 2e-2  # against the eager flax forward, gelu rounded op by op on both sides
TOL_LOGITS_SHIPPED = 6e-2  # against the jitted flax forward: its own spread from eager is up to 3.4e-2
MARGIN = 0.05
MIN_COS = 0.9999
TOL_CE = 1e-6
TOL_TRAIN = 1e-2

GEOMS = {  # hidden, layers, heads, ffn, L
    "h32-l1": (32, 1, 2, 64, 16),
    "h64-l2": (64, 2, 4, 128, 32),
    "h128-l2": (128, 2, 4, 512, 32),
}
VOCAB = 97


def configs(geom, dropout=0.1):
    hidden, layers, heads, ffn, L = GEOMS[geom]
    kw = dict(vocab_size=VOCAB, hidden=hidden, layers=layers, heads=heads, ffn=ffn, max_len=L, dropout=dropout)
    return jbert.BertConfig(**kw), tbert.BertConfig(**kw)


def batch(L, B=6, seed=0):
    """Random ids with ragged live lengths (at least 4 live tokens a row)."""
    rng = np.random.default_rng(seed)
    mask = np.arange(L)[None] < rng.integers(4, L + 1, size=B)[:, None]
    ids = np.where(mask, rng.integers(5, VOCAB, size=(B, L)), 0).astype(np.int32)
    return ids, mask


def flax_init(module, seed, ids, mask):
    return jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.asarray(ids[:1]), jnp.asarray(mask[:1]))


def flax_apply(module, params, ids, mask, jit=True):
    """The flax forward jitted, as the JAX package runs it, or eagerly (every
    operation rounded to its declared type)."""
    fn = jax.jit(module.apply) if jit else module.apply
    return np.asarray(fn(params, jnp.asarray(ids), jnp.asarray(mask)))


def port_module(cls, cfg, params):
    m = cls(cfg, seed=None, device="cpu").eval()
    m.load_state_dict(convert.bert_params_from_jax(jax.tree.map(np.asarray, params)))
    return m


def both_logits(geom, seed=0, jit=True):
    jc, tc = configs(geom)
    ids, mask = batch(jc.max_len, seed=seed)
    params = flax_init(jbert.BreakTagger(jc), seed, ids, mask)
    want = flax_apply(jbert.BreakTagger(jc), params, ids, mask, jit)
    model = port_module(tbert.BreakTagger, tc, params)
    return want, model, ids, mask


def run(model, ids, mask):
    with torch.no_grad():
        return model(torch.as_tensor(ids), torch.as_tensor(mask)).numpy()


@pytest.mark.parametrize("geom", list(GEOMS))
def test_break_tagger_rounding_points_match_flax(geom, monkeypatch):
    want, model, ids, mask = both_logits(geom, jit=False)
    monkeypatch.setattr(tbert, "gelu", gelu_tanh_bf16)
    got = run(model, ids, mask)
    assert got.dtype == np.float32 and got.shape == want.shape == (*ids.shape, 2)
    err = float(np.abs(got - want).max())
    assert err <= TOL_LOGITS, err


@pytest.mark.parametrize("geom", list(GEOMS))
def test_break_tagger_logits_and_decisions_match_flax(geom):
    want, model, ids, mask = both_logits(geom, seed=1)
    got = run(model, ids, mask)
    err = float(np.abs(got - want).max())
    assert err <= TOL_LOGITS_SHIPPED, err
    sure = np.abs(want[..., 1] - want[..., 0]) > MARGIN
    assert (got.argmax(-1) == want.argmax(-1))[sure].all()
    assert sure.mean() > 0.5


@pytest.mark.parametrize("geom", list(GEOMS))
def test_sentence_encoder_matches_flax(geom):
    jc, tc = configs(geom)
    ids, mask = batch(jc.max_len, seed=2)
    params = flax_init(jbert.SentenceEncoder(jc), 5, ids, mask)
    want = flax_apply(jbert.SentenceEncoder(jc), params, ids, mask)
    got = run(port_module(tbert.SentenceEncoder, tc, params), ids, mask)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    cos = (got * want).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(want, axis=-1)
    assert cos.min() >= MIN_COS, cos.min()


def test_sentence_encoder_clamps_an_all_masked_row():
    """A row with no live token pools to zero; the 1e-6 clamp keeps it
    finite on both sides."""
    jc, tc = configs("h32-l1")
    ids, mask = batch(jc.max_len, B=2, seed=3)
    mask[1] = False
    params = flax_init(jbert.SentenceEncoder(jc), 0, ids, mask)
    want = flax_apply(jbert.SentenceEncoder(jc), params, ids, mask)
    got = run(port_module(tbert.SentenceEncoder, tc, params), ids, mask)
    assert np.isfinite(got).all() and np.abs(got[1]).max() == np.abs(want[1]).max() == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_cross_entropy_loss_matches(seed):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.normal(size=(4, 16, 2))).astype(np.float32)
    labels = rng.integers(0, 2, size=(4, 16)).astype(np.int32)
    labels[rng.random((4, 16)) < 0.4] = -100
    mask = rng.random((4, 16)) < 0.8
    want = float(jbert.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)))
    got = float(tbert.cross_entropy_loss(torch.as_tensor(logits), torch.as_tensor(labels), torch.as_tensor(mask)))
    assert abs(got - want) <= TOL_CE, (got, want)
    empty = tbert.cross_entropy_loss(torch.as_tensor(logits), torch.full((4, 16), -100), torch.as_tensor(mask))
    assert float(empty) == 0.0


def test_converters_round_trip_and_refuse_unknown_leaves():
    jc, tc = configs("h64-l2")
    ids, mask = batch(jc.max_len)
    params = jax.tree.map(np.asarray, flax_init(jbert.BreakTagger(jc), 0, ids, mask))
    state = convert.bert_params_from_jax(params)
    assert set(state) == set(tbert.BreakTagger(tc, seed=None, device="cpu").state_dict())
    flat = convert.bert_params_to_jax(state, tc)
    leaves = {"/".join(k.key for k in path): v for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(flat) == set(leaves)
    for k, v in leaves.items():
        assert flat[k].dtype == np.float32 and np.array_equal(flat[k], v), k
    bad = {"params": dict(params["params"], extra={"kernel": np.zeros((2, 2), np.float32)})}
    with pytest.raises(ValueError, match="unknown leaf"):
        convert.bert_params_from_jax(bad)
    with pytest.raises(ValueError, match="unknown leaf"):
        convert.bert_params_to_jax({**state, "encoder.stray": torch.zeros(2)}, tc)


def test_port_init_follows_flax_statistics():
    """The port's own initialisation (used when no converted parameters are
    given) draws each leaf with flax's scale, and a seed fixes it."""
    jc, tc = configs("h128-l2")
    ids, mask = batch(jc.max_len)
    want = convert.bert_params_from_jax(jax.tree.map(np.asarray, flax_init(jbert.BreakTagger(jc), 0, ids, mask)))
    got = tbert.BreakTagger(tc, seed=0, device="cpu").state_dict()
    again = tbert.BreakTagger(tc, seed=0, device="cpu").state_dict()
    for k, v in got.items():
        assert torch.equal(v, again[k]), k
        assert abs(float(v.std()) - float(want[k].std())) <= 0.1 * float(want[k].std()) + 1e-7, k
        assert float(v.mean()) == pytest.approx(float(want[k].mean()), abs=0.02), k


def train_data(L, n=8, seed=4):
    ids, mask = batch(L, B=n, seed=seed)
    rng = np.random.default_rng(seed)
    labels = np.where(mask & (rng.random(ids.shape) < 0.7), rng.integers(0, 2, size=ids.shape), -100).astype(np.int32)
    return ids, mask, labels


def test_train_tagger_matches_flax_over_five_steps(monkeypatch):
    """Dropout 0, the same converted initialisation, five AdamW steps (one a
    epoch, the whole set a batch): the flax trainer's loss at step 1 (its
    initial parameters) and step 5 (returned) against the port's losses."""
    jc, tc = configs("h64-l2", dropout=0.0)
    ids, mask, labels = train_data(jc.max_len)
    params = flax_init(jbert.BreakTagger(jc), 7, ids, mask)
    loss0 = float(jbert.cross_entropy_loss(flax_apply(jbert.BreakTagger(jc), params, ids, mask), jnp.asarray(labels),
                                           jnp.asarray(mask)))
    _, jparams, loss5 = jtrainer.train_tagger(JDataset(ids, mask, labels), jc, epochs=5, batch_size=8, lr=1e-3, seed=7)

    monkeypatch.setattr(ttrainer, "init_tagger", lambda cfg, seed, device: port_module(tbert.BreakTagger, cfg, params))
    losses = []
    model, state, last = ttrainer.train_tagger(TDataset(ids, mask, labels), tc, epochs=5, batch_size=8, lr=1e-3, seed=7,
                                               device="cpu", losses=losses)
    assert len(losses) == 5 and last == losses[-1]
    assert losses[0] == pytest.approx(loss0, rel=TOL_TRAIN)
    assert losses[-1] == pytest.approx(loss5, rel=TOL_TRAIN)
    assert losses[-1] < losses[0]
    # the trained weights (measured: losses within 1.2e-3 relative, logits within 2.4e-2)
    want = flax_apply(jbert.BreakTagger(jc), jparams, ids, mask)
    assert np.abs(run(model, ids, mask) - want).max() <= TOL_LOGITS_SHIPPED


def test_train_tagger_dropout_draws_from_its_seed():
    """With dropout the masks come from a generator seeded with ``seed``:
    one seed gives the same losses twice, and the masks change the loss."""
    _, tc = configs("h32-l1", dropout=0.3)
    ids, mask, labels = train_data(tc.max_len)
    ds = TDataset(ids, mask, labels)
    runs = []
    for cfg in (tc, tc, dataclasses.replace(tc, dropout=0.0)):
        losses = []
        ttrainer.train_tagger(ds, cfg, epochs=2, batch_size=4, seed=3, device="cpu", losses=losses)
        runs.append(losses)
    assert runs[0] == runs[1]
    assert runs[0][0] != runs[2][0]


class _FixedLogits:
    """Logits that are a fixed function of the ids, for both frameworks."""

    @staticmethod
    def values(ids):
        x = (ids * 37 % 11).astype(np.float32) / 4.0
        return np.stack([x - 1.0, 1.0 - x], -1)


class _JaxFixed(_FixedLogits):
    def apply(self, params, ids, mask):
        x = (ids * 37 % 11).astype(jnp.float32) / 4.0
        return jnp.stack([x - 1.0, 1.0 - x], -1)


class _TorchFixed(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.dummy = torch.nn.Parameter(torch.zeros(1))

    def forward(self, ids, mask):
        x = (ids * 37 % 11).float() / 4.0
        return torch.stack([x - 1.0, 1.0 - x], -1)


def test_evaluate_tagger_metrics_equal_given_equal_logits():
    ids, mask, labels = train_data(32, n=70, seed=9)
    want = jtrainer.evaluate_tagger(_JaxFixed(), {}, JDataset(ids, mask, labels))
    got = ttrainer.evaluate_tagger(_TorchFixed(), None, TDataset(ids, mask, labels))
    assert got.__dict__ == want.__dict__
    assert 0.0 < got.f1 < 1.0


def test_sentences_per_second_runs_on_the_cpu_when_asked():
    _, tc = configs("h32-l1")
    ids, mask, labels = train_data(tc.max_len, n=3)
    model = tbert.BreakTagger(tc, seed=0, device="cpu")
    rate = ttrainer.sentences_per_second(model, None, TDataset(ids, mask, labels), batch_size=8, iters=2, device="cpu")
    assert rate > 0
    with pytest.raises(ValueError, match="device"):
        ttrainer.sentences_per_second(model, None, TDataset(ids, mask, labels), device="meta")
