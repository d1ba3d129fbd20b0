"""The PyTorch port's BiLSTM prosody regressor (``models/bilstm.py``) and its
runner (``models/bilstm_runner.py``) against the JAX package's, on the CPU,
from the same numpy inputs and the same (converted) flax initialisation.

Tolerances, measured here and stated: ``BiLSTMProsody`` outputs within 1e-5
(float32 on both sides; measured at most 6e-8 at embed 32); the validation
history of ``train_bilstm`` over 3 epochs of Adam within 1e-4 (measured
below 1e-6); ``embed_sentences`` cosine ≥ 0.9999 per sentence.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prosody_control_french_tts_tpu.models import bert as jbert
from prosody_control_french_tts_tpu.models import bilstm as jbilstm
from prosody_control_french_tts_tpu.models import bilstm_runner as jrunner
from prosody_control_french_tts_tpu.models.tokenizer import WordPieceTokenizer as JTokenizer
from prosody_control_french_tts_tpu_torch import convert
from prosody_control_french_tts_tpu_torch.models import bert as tbert
from prosody_control_french_tts_tpu_torch.models import bilstm as tbilstm
from prosody_control_french_tts_tpu_torch.models import bilstm_runner as trunner
from prosody_control_french_tts_tpu_torch.models.tokenizer import WordPieceTokenizer as TTokenizer

TOL_OUT = 1e-5
TOL_HISTORY = 1e-4
MIN_COS = 0.9999


def flax_params(embed_dim, seed, x):
    model = jbilstm.BiLSTMProsody(jbilstm.BiLSTMConfig(embed_dim=embed_dim))
    return jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.asarray(x[:1]))


def port_regressor(embed_dim, params):
    m = tbilstm.BiLSTMProsody(tbilstm.BiLSTMConfig(embed_dim=embed_dim), seed=None, device="cpu").eval()
    m.load_state_dict(convert.bilstm_params_from_jax(jax.tree.map(np.asarray, params)))
    return m


@pytest.mark.parametrize("B,T,D", [(5, 1, 32), (5, 3, 64), (8, 4, 128)])
def test_bilstm_prosody_matches_flax(B, T, D):
    x = np.random.default_rng(D).normal(size=(B, T, D)).astype(np.float32)
    params = flax_params(D, T, x)
    model = jbilstm.BiLSTMProsody(jbilstm.BiLSTMConfig(embed_dim=D))
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port_regressor(D, params)(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (B, 3)
    assert np.abs(got - want).max() <= TOL_OUT


def test_reverse_half_reads_one_step_at_the_last_position():
    """The flax model reads its reversed cell after one step (the last
    element alone): changing earlier elements moves only the forward half."""
    D = 16
    x = np.random.default_rng(0).normal(size=(2, 3, D)).astype(np.float32)
    m = tbilstm.BiLSTMProsody(tbilstm.BiLSTMConfig(embed_dim=D), seed=0, device="cpu")
    with torch.no_grad():
        ys_a, _ = m.lstm(m.norm(torch.as_tensor(x)))
        x2 = x.copy()
        x2[:, 0] += 1.0
        ys_b, _ = m.lstm(m.norm(torch.as_tensor(x2)))
        alone, _ = m.lstm(m.norm(torch.as_tensor(x[:, -1:])))
    H = m.cfg.hidden
    assert torch.equal(ys_a[:, -1, H:], ys_b[:, -1, H:])
    assert not torch.equal(ys_a[:, -1, :H], ys_b[:, -1, :H])
    torch.testing.assert_close(ys_a[:, -1, H:], alone[:, -1, H:], rtol=0, atol=1e-6)


def test_converter_refuses_unknown_and_missing_leaves():
    x = np.zeros((1, 2, 8), np.float32)
    params = jax.tree.map(np.asarray, flax_params(8, 0, x))
    inner = params["params"]
    state = convert.bilstm_params_from_jax(params)
    assert set(state) == set(tbilstm.BiLSTMProsody(tbilstm.BiLSTMConfig(embed_dim=8), seed=None, device="cpu").state_dict())
    assert float(state["lstm.bias_ih_l0"].abs().max()) == 0.0
    with pytest.raises(ValueError, match="unknown leaf"):
        convert.bilstm_params_from_jax({**inner, "Dense_2": {"kernel": np.zeros((2, 2), np.float32)}})
    with pytest.raises(ValueError, match="unknown leaf"):
        bad_cell = dict(inner["fwd"]["cell"], ii={"kernel": inner["fwd"]["cell"]["ii"]["kernel"], "bias": np.zeros(40, np.float32)})
        convert.bilstm_params_from_jax({**inner, "fwd": {"cell": bad_cell}})
    with pytest.raises(ValueError, match="lacks"):
        cell = {k: v for k, v in inner["bwd"]["cell"].items() if k != "hg"}
        convert.bilstm_params_from_jax({**inner, "bwd": {"cell": cell}})


def test_port_init_follows_flax_statistics():
    D = 64
    x = np.zeros((1, 2, D), np.float32)
    want = convert.bilstm_params_from_jax(jax.tree.map(np.asarray, flax_params(D, 0, x)))
    got = tbilstm.BiLSTMProsody(tbilstm.BiLSTMConfig(embed_dim=D), seed=0, device="cpu").state_dict()
    for k, v in got.items():
        assert abs(float(v.std()) - float(want[k].std())) <= 0.15 * float(want[k].std()) + 1e-7, k
    w_hh = got["lstm.weight_hh_l0"][:40]  # one gate's recurrent kernel: orthogonal
    torch.testing.assert_close(w_hh @ w_hh.T, torch.eye(40), rtol=0, atol=1e-5)


def test_train_bilstm_history_matches_flax(monkeypatch):
    rng = np.random.default_rng(5)
    D, seed = 32, 3
    xs = rng.normal(size=(60, 2, D)).astype(np.float32)
    ys = rng.normal(size=(60, 3)).astype(np.float32)
    jparams, jhist = jbilstm.train_bilstm(xs, ys, seed=seed, epochs=3, batch_size=16)
    init = flax_params(D, seed, xs)
    monkeypatch.setattr(tbilstm, "init_bilstm", lambda cfg, s, device: port_regressor(cfg.embed_dim, init))
    state, hist = tbilstm.train_bilstm(xs, ys, seed=seed, epochs=3, batch_size=16, device="cpu")
    assert len(hist) == len(jhist) == 3
    assert np.abs(np.asarray(hist) - np.asarray(jhist)).max() <= TOL_HISTORY, (hist, jhist)
    # the best-validation parameters are the ones kept, on both sides
    model = jbilstm.BiLSTMProsody(jbilstm.BiLSTMConfig(embed_dim=D))
    want = np.asarray(jax.jit(model.apply)(jparams, jnp.asarray(xs)))
    m = tbilstm.BiLSTMProsody(tbilstm.BiLSTMConfig(embed_dim=D), seed=None, device="cpu")
    m.load_state_dict(state)
    with torch.no_grad():
        assert np.abs(m(torch.as_tensor(xs)).numpy() - want).max() <= 10 * TOL_HISTORY


@pytest.mark.parametrize("seq_len", [1, 3, 7])
def test_windows_and_calibration_equal(seq_len):
    rng = np.random.default_rng(seq_len)
    emb = rng.normal(size=(6, 4)).astype(np.float32)
    tgt = (rng.normal(size=(6, 3)) * [1, 2, 3]).astype(np.float32)
    for a, b in zip(tbilstm.sliding_windows(emb, tgt, seq_len), jbilstm.sliding_windows(emb, tgt, seq_len)):
        assert a.shape == b.shape and np.array_equal(a, b)
    tgt[:, 1] = 2.0  # a constant column keeps sd 1
    (za, (mua, sda)), (zb, (mub, sdb)) = tbilstm.zscore_calibrate(tgt), jbilstm.zscore_calibrate(tgt)
    assert np.array_equal(za, zb) and np.array_equal(mua, mub) and np.array_equal(sda, sdb)


def test_embed_sentences_matches_flax(monkeypatch):
    texts = ["bonjour le monde", "la voix parle bien fort", "un deux trois", "le chat dort sur la maison rouge"] * 3
    jtok = JTokenizer.train(texts, vocab_size=120, min_freq=1)
    ttok = TTokenizer(vocab=dict(jtok.vocab))
    want = jrunner.embed_sentences(texts, jtok, batch=5, seed=4)
    cfg_j = jbert.BertConfig.tiny(vocab_size=len(jtok))
    ids = np.zeros((1, cfg_j.max_len), np.int32)
    params = jax.jit(jbert.SentenceEncoder(cfg_j).init)(jax.random.PRNGKey(4), jnp.asarray(ids), jnp.asarray(ids != 0))

    def converted(cfg, seed, device):
        enc = tbert.SentenceEncoder(cfg, seed=None, device=device)
        enc.load_state_dict(convert.bert_params_from_jax(jax.tree.map(np.asarray, params)))
        return enc

    monkeypatch.setattr(trunner, "init_encoder", converted)
    got = trunner.embed_sentences(texts, ttok, batch=5, seed=4, device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    cos = (got * want).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(want, axis=-1)
    assert cos.min() >= MIN_COS
    # given parameters, the encoder is built from them
    again = trunner.embed_sentences(texts, ttok, params=converted(tbert.BertConfig.tiny(len(ttok)), 0, "cpu").state_dict(),
                                    batch=5, device="cpu")
    np.testing.assert_array_equal(again, got)
