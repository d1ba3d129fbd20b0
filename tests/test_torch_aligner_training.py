"""The training halves of the port's acoustic aligners against the JAX
package's, on the same numpy inputs: the CTC aligner's per-project recipe
(``align/train_ctc.py``, ``CTCAligner.make_train_step``), the packaged
CTC recipe (``align/pretrain_ctc.py``), the packaged Whisper recipe
(``align/pretrain_whisper.py``) and their checkpoints.

Tolerances, each for its reason:

- the recipes' losses, fed identical logits, weights and masks: 1e-6
  relative (float32 sums in another order);
- Adam and the schedules, fed identical gradients: 1e-6 of the parameters'
  size (``torch.optim.Adam`` rounds its bias corrections in float64 where
  optax uses float32);
- one train step of each model from the converted flax initialisation at
  small widths: the bfloat16 layers round in other places in XLA and
  PyTorch (the CTC logits differ by up to 0.05, ``test_torch_ctc.py``), so
  the first loss is held to 1e-3 relative, each parameter's gradient to a
  cosine of 0.99 with JAX's (but the attention's key bias, whose gradient
  is 0 but for rounding: the softmax ignores what it adds to a query's
  every score), and a short loss curve to 5e-2 relative;
- host preparation: targets, ids and masks exactly, mels within
  ``log_mel``'s 1e-3 (``test_torch_log_mel_dtw.py``);
- checkpoints across the packages: the model's outputs within the
  inference tests' limits (CTC and Whisper logits 0.05).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prosody_control_french_tts_tpu.align import pretrain_ctc as j_pc
from prosody_control_french_tts_tpu.align.ctc import ctc_loss as jax_ctc_loss
from prosody_control_french_tts_tpu.align import pretrain_whisper as j_pw
from prosody_control_french_tts_tpu.align.ctc_aligner import CTCAligner as JCTC
from prosody_control_french_tts_tpu.align.ctc_aligner import save_params as j_save_params
from prosody_control_french_tts_tpu.align.synth_speech import SynthSpec, sample_sentences
from prosody_control_french_tts_tpu.align.whisper_jax import WhisperAligner as JW
from prosody_control_french_tts_tpu.align.whisper_jax import WhisperConfig as JWC
from prosody_control_french_tts_tpu.models.bpe_tokenizer import byte_level_french as j_tok
from prosody_control_french_tts_tpu.utils import wavio as j_wavio
from prosody_control_french_tts_tpu_torch import convert
from prosody_control_french_tts_tpu_torch.align import ctc_aligner as t_ca
from prosody_control_french_tts_tpu_torch.align import pretrain_ctc as t_pc
from prosody_control_french_tts_tpu_torch.align import pretrain_whisper as t_pw
from prosody_control_french_tts_tpu_torch.align.ctc_aligner import CTCAligner as TCTC
from prosody_control_french_tts_tpu_torch.align.train_ctc import train_ctc_aligner
from prosody_control_french_tts_tpu_torch.align.whisper import WhisperAligner as TW
from prosody_control_french_tts_tpu_torch.align.whisper import WhisperConfig as TWC
from prosody_control_french_tts_tpu_torch.models import schedules
from prosody_control_french_tts_tpu_torch.models.bpe_tokenizer import byte_level_french as t_tok
from prosody_control_french_tts_tpu_torch.utils.wavio import Audio as TAudio

SR = 16000


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tone_word_audio(freqs, dur=0.25, gap=0.15):
    """The JAX suite's tone words: 'aa' at 300 Hz, 'bb' at 1200 Hz."""
    chunks = []
    for f in freqs:
        t = np.arange(int(SR * dur)) / SR
        chunks.append(0.5 * np.sin(2 * np.pi * f * t))
        chunks.append(np.zeros(int(SR * gap)))
    return np.concatenate(chunks).astype(np.float32)


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return 1.0 if na == nb == 0 else float(a @ b / (na * nb))


# -- the recipes' losses on identical inputs ------------------------------


def _jax_frame_ce(logits, tgt):  # align/pretrain_ctc.py:102-107
    logp = jax.nn.log_softmax(logits, axis=-1)
    valid = tgt >= 0
    safe = jnp.maximum(tgt, 0)
    ce = -jnp.take_along_axis(logp, safe[..., None], axis=-1)[..., 0]
    return jnp.sum(jnp.where(valid, ce, 0.0)) / jnp.maximum(jnp.sum(valid), 1)


def _jax_whisper_loss(logits, cross, ids, n_text, att_target, att_weight):  # align/pretrain_whisper.py:195-217
    L = ids.shape[1]
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    ll = jnp.take_along_axis(logp, ids[:, 1:][..., None], axis=-1)[..., 0]
    ll = 0.9 * ll + 0.1 * jnp.mean(logp, axis=-1)
    tmask = jnp.arange(L - 1)[None, :] <= n_text[:, None]
    ce = -jnp.sum(ll * tmask) / jnp.maximum(jnp.sum(tmask), 1.0)
    w = jnp.mean(jnp.stack([c.mean(axis=1) for c in cross]), axis=0)
    mass = jnp.sum(w * att_target, axis=-1)
    amask = (jnp.arange(L - 1)[None, :] >= 1) & (jnp.arange(L - 1)[None, :] <= n_text[:, None])
    att = -jnp.sum(jnp.log(mass + 1e-8) * amask) / jnp.maximum(jnp.sum(amask), 1.0)
    return ce + att_weight * att, ce, att


def test_frame_ce_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 40, 47)).astype(np.float32) * 3
    tgt = rng.integers(0, 47, (3, 40)).astype(np.int32)
    tgt[0, 30:] = -1
    tgt[2, 5:] = -1
    want = float(_jax_frame_ce(jnp.asarray(logits), jnp.asarray(tgt)))
    got = float(t_pc.frame_ce_loss(torch.from_numpy(logits), torch.from_numpy(tgt)))
    assert got == pytest.approx(want, rel=1e-6)


def test_whisper_loss_matches_jax():
    rng = np.random.default_rng(1)
    B, L, V, H, Fr, layers = 2, 12, 40, 2, 30, 3
    logits = rng.standard_normal((B, L - 1, V)).astype(np.float32) * 2
    cross = [rng.dirichlet(np.ones(Fr), size=(B, H, L - 1)).astype(np.float32) for _ in range(layers)]
    ids = rng.integers(0, V, (B, L)).astype(np.int32)
    n_text = np.array([7, 10], np.int32)
    tgt = (rng.random((B, L - 1, Fr)) < 0.2).astype(np.float32)
    want = _jax_whisper_loss(jnp.asarray(logits), [jnp.asarray(c) for c in cross], jnp.asarray(ids),
                             jnp.asarray(n_text), jnp.asarray(tgt), 0.5)
    got = t_pw.whisper_loss(torch.from_numpy(logits), [torch.from_numpy(c) for c in cross], torch.from_numpy(ids),
                            torch.from_numpy(n_text), torch.from_numpy(tgt), 0.5)
    for w, g in zip(want, got):
        assert float(g) == pytest.approx(float(w), rel=1e-6)


# -- the optimiser and the schedules ---------------------------------------


@pytest.mark.parametrize("kind", ["constant", "warmup_cosine", "cosine"])
def test_adam_and_schedules_match_optax(kind):
    rng = np.random.default_rng(2)
    lr, steps = 3e-4, 12
    if kind == "constant":
        j_sched, t_sched = lr, (lambda c: lr)
    elif kind == "warmup_cosine":
        warm = min(50, max(steps // 10, 1))  # align/pretrain_whisper.py:182
        j_sched = optax.warmup_cosine_decay_schedule(0.0, lr, warm, max(steps, warm + 1), lr * 0.1)
        t_sched = t_pw.whisper_schedule(lr, steps)
        assert t_sched(0) == 0.0  # the first update's learning rate
    else:
        j_sched, t_sched = optax.cosine_decay_schedule(lr, steps, alpha=0.05), schedules.cosine_decay_schedule(lr, steps, 0.05)
    if callable(j_sched):
        for c in range(steps + 3):
            assert t_sched(c) == pytest.approx(float(j_sched(c)), rel=1e-6, abs=1e-12)
    p0 = rng.standard_normal((5, 7)).astype(np.float32) * 0.1
    grads = [rng.standard_normal((5, 7)).astype(np.float32) * 10.0 ** rng.uniform(-4, 1) for _ in range(steps)]
    tx = optax.adam(j_sched)
    p, opt = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = schedules.ScheduledAdam([w], t_sched)
    for g in grads:
        upd, opt = tx.update(jnp.asarray(g), opt)
        p = optax.apply_updates(p, upd)
        w.grad = torch.from_numpy(g.copy())
        topt.step()
    assert np.abs(w.detach().numpy() - np.asarray(p)).max() <= 1e-6 * max(1.0, np.abs(p0).max())


# -- host preparation ------------------------------------------------------


def test_frame_targets_and_ctc_prep_match_jax():
    ja, ta = JCTC(dim=48, layers=1), TCTC(dim=48, layers=1, device="cpu")
    spans = [(0.011, 0.05, "a"), (0.05, 0.093, "b"), (0.2, 0.31, " "), (0.31, 0.4, "é")]
    assert np.array_equal(t_pc._frame_targets(spans, 25, ta.vocab), j_pc._frame_targets(spans, 25, ja.vocab))
    sents = sample_sentences(6, seed=3, min_words=2, max_words=3)
    jm, jt = j_pc._prep_batches(ja, sents, SynthSpec(), 2, 3)
    tm, tt = t_pc._prep_batches(ta, sents, SynthSpec(), 2, 3)
    assert np.array_equal(jt, tt) and jm.shape == tm.shape
    assert np.abs(np.asarray(jm) - tm).max() <= 1e-3


@pytest.fixture(scope="module")
def whisper_pair():
    cfg_j, cfg_t = JWC.test(vocab_size=1864), TWC.test(vocab_size=1864)
    return JW(cfg_j, tokenizer=j_tok()), TW(cfg_t, tokenizer=t_tok(), device="cpu")


@pytest.fixture(scope="module")
def whisper_batches(whisper_pair):
    ja, ta = whisper_pair
    sents = sample_sentences(6, seed=0, min_words=2, max_words=3)
    return j_pw._prep_batches(ja, sents, SynthSpec(), 2, 0), t_pw._prep_batches(ta, sents, SynthSpec(), 2, 0)


def test_whisper_prep_matches_jax(whisper_batches):
    jb, tb = whisper_batches
    assert [a.shape for a in jb] == [a.shape for a in tb]
    for a, b in zip(jb[1:], tb[1:]):
        assert np.array_equal(a, b)
    assert np.abs(jb[0] - tb[0]).max() <= 1e-3
    sent = "le chat"
    chars = [(0.1 * i, 0.1 * i + 0.1, c) for i, c in enumerate(sent)]
    assert t_pw._byte_char_spans(sent, chars) == j_pw._byte_char_spans(sent, chars)
    assert t_pw._byte_char_spans("été", [(0, 0.1, "é"), (0.1, 0.2, "t"), (0.2, 0.3, "é")]) == j_pw._byte_char_spans(
        "été", [(0, 0.1, "é"), (0.1, 0.2, "t"), (0.2, 0.3, "é")])
    assert t_pw._byte_char_spans("ab", [(0, 0.1, "a")]) is None
    assert t_pw.synth_fr_config().__dict__.keys() == j_pw.synth_fr_config().__dict__.keys()
    assert {k: v for k, v in t_pw.synth_fr_config().__dict__.items() if k != "dtype"} == {
        k: v for k, v in j_pw.synth_fr_config().__dict__.items() if k != "dtype"}


# -- one train step of each model, and a short loss curve --------------------


def test_ctc_train_step_matches_jax():
    ja = JCTC(dim=48, layers=1)
    ja.init_params(jax.random.PRNGKey(0))
    ta = TCTC(dim=48, layers=1, device="cpu")
    ta.init_params(0)
    ta.model.load_state_dict(convert.ctc_params_from_jax(_np_tree(ja.params)))
    x = _tone_word_audio([300.0, 1200.0])
    mel_j = ja.features(j_wavio.Audio(x, SR))
    mel = torch.from_numpy(np.asarray(mel_j))
    labels, _ = ja.vocab.word_spans(["aa", "bb"])
    n = mel.shape[0] // 2
    args_j = (mel_j, jnp.int32(n), jnp.asarray(labels, jnp.int32), jnp.int32(len(labels)))

    def loss_fn(p):
        logp = jax.nn.log_softmax(ja.model.apply(p, mel_j), axis=-1)
        return jax_ctc_loss(logp, args_j[2], args_j[1], args_j[3])

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(ja.params)
    t_model = ta.model
    t_model.zero_grad()
    tl = t_ca.ctc_loss(torch.log_softmax(t_model(mel), -1), labels, n, len(labels))
    tl.backward()
    assert float(tl) == pytest.approx(float(jl), rel=1e-3)
    jg = convert.ctc_params_from_jax(_np_tree(jg))
    for k, p in t_model.named_parameters():
        if not k.endswith("attn.key.bias"):
            assert _cos(p.grad.numpy(), jg[k].numpy()) > 0.99, k

    init, jstep = ja.make_train_step(lr=3e-3)
    opt, params = init(ja.params), ja.params
    tstep = ta.make_train_step(lr=3e-3)
    t_model.zero_grad()
    for _ in range(5):
        params, opt, jl = jstep(params, opt, *args_j)
        tl = tstep(mel, n, labels, len(labels))
        assert float(tl) == pytest.approx(float(jl), rel=5e-2)


def test_pretrain_ctc_step_matches_jax():
    ja = JCTC(dim=48, layers=1)
    ja.init_params(jax.random.PRNGKey(1))
    ta = TCTC(dim=48, layers=1, device="cpu")
    ta.init_params(1)
    ta.model.load_state_dict(convert.ctc_params_from_jax(_np_tree(ja.params)))
    sents = sample_sentences(4, seed=5, min_words=2, max_words=3)
    mel, tgt = j_pc._prep_batches(ja, sents, SynthSpec(), 2, 5)
    tx, jstep = j_pc._make_step(ja, 1e-3)
    params, opt = ja.params, tx.init(ja.params)
    tstep = t_pc._make_step(ta, 1e-3)
    for i in range(4):
        idx = np.array([i % 4, (i + 1) % 4])
        params, opt, jl = jstep(params, opt, jnp.asarray(mel[idx]), jnp.asarray(tgt[idx]))
        tl = tstep(torch.from_numpy(mel[idx]), torch.from_numpy(tgt[idx]))
        assert float(tl) == pytest.approx(float(jl), rel=1e-3 if i == 0 else 5e-2)


def test_whisper_train_step_matches_jax(whisper_pair, whisper_batches):
    ja, ta = whisper_pair
    (mel, ids, n_text, tgt), _ = whisper_batches
    params = ja.model.init(jax.random.PRNGKey(0), jnp.asarray(mel[:1]), jnp.asarray(ids[:1, :-1]))
    ta.init_params(0)
    ta.load_params(_np_tree(params))
    ta.model.train()
    tx, jstep = j_pw._make_step(ja.model, 3e-4, 8, 0.5)
    opt = tx.init(params)
    tstep = t_pw._make_step(ta.model, 3e-4, 8, 0.5)
    dj = [jnp.asarray(a) for a in (mel, ids, n_text, tgt.astype(np.uint8))]
    dt = [torch.from_numpy(a) for a in (mel, ids, n_text, tgt.astype(np.uint8))]
    # the first step's gradient direction
    idx = np.array([0, 1], np.int32)

    def loss_fn(p):
        logits, cross = ja.model.apply(p, dj[0][idx], dj[1][idx][:, :-1], True)
        return _jax_whisper_loss(logits, cross, dj[1][idx], dj[2][idx], dj[3][idx].astype(jnp.float32), 0.5)[0]

    jg = convert.whisper_params_from_jax(_np_tree(jax.jit(jax.grad(loss_fn))(params)))
    ta.model.zero_grad()
    logits, cross = ta.model(dt[0][idx], dt[1][idx][:, :-1], collect_cross=True)
    t_pw.whisper_loss(logits, cross, dt[1][idx], dt[2][idx], dt[3][idx].float(), 0.5)[0].backward()
    for k, p in ta.model.named_parameters():
        assert _cos(p.grad.numpy(), jg[k].numpy()) > 0.99, k
    ta.model.zero_grad()
    for i in range(4):
        idx = np.array([i % 3, (i + 1) % 3], np.int32)
        params, opt, jl, jce, jatt = jstep(params, opt, jnp.asarray(idx), *dj)
        tl, tce, tatt = tstep(torch.from_numpy(idx).long(), *dt)
        tol = 1e-3 if i == 0 else 5e-2
        assert float(tl) == pytest.approx(float(jl), rel=tol)
        assert float(tce) == pytest.approx(float(jce), rel=tol)
        assert float(tatt) == pytest.approx(float(jatt), rel=tol)


# -- the per-project recipe end to end ----------------------------------------


def test_train_ctc_aligner_end_to_end(tmp_path):
    for i in range(3):
        j_wavio.write_wav(tmp_path / f"u{i}.wav", _tone_word_audio([300.0, 1200.0]), SR)
        (tmp_path / f"u{i}.txt").write_text("aa bb")
    al, losses = train_ctc_aligner(tmp_path, tmp_path / "w.npz", epochs=20, lr=3e-3, dim=48, layers=1, device="cpu")
    assert losses[-1] < losses[0]
    assert np.load(tmp_path / "w.npz")["params/Conv_0/kernel"].dtype == np.float32
    al2 = TCTC(dim=48, layers=1, weights_path=tmp_path / "w.npz", device="cpu")
    tg = al2.align(TAudio(_tone_word_audio([300.0, 1200.0]), SR), "aa bb")
    assert [iv.mark for iv in tg.tiers[0] if iv.mark.strip()] == ["aa", "bb"]
    # the JAX package loads the port's checkpoint and aligns the same way
    jal = JCTC(dim=48, layers=1, weights_path=tmp_path / "w.npz")
    jtg = jal.align(j_wavio.Audio(_tone_word_audio([300.0, 1200.0]), SR), "aa bb")
    assert [iv.mark for iv in jtg.tiers[0] if iv.mark.strip()] == ["aa", "bb"]


# -- checkpoints across the packages -------------------------------------------


def test_ctc_checkpoints_cross_both_ways(tmp_path):
    mel = np.random.default_rng(4).standard_normal((60, 80)).astype(np.float32)
    ta = TCTC(dim=48, layers=1, device="cpu")
    ta.init_params(7)
    t_ca.save_params(ta.params, tmp_path / "port.npz")
    ja = JCTC(dim=48, layers=1, weights_path=tmp_path / "port.npz")
    with torch.no_grad():
        got = ta.model(torch.from_numpy(mel)).numpy()
    assert np.abs(np.asarray(ja.model.apply(ja.params, jnp.asarray(mel))) - got).max() <= 0.05
    jb = JCTC(dim=48, layers=1)
    jb.init_params(jax.random.PRNGKey(3))
    j_save_params(jb.params, tmp_path / "jax.npz")
    tb = TCTC(dim=48, layers=1, weights_path=tmp_path / "jax.npz", device="cpu")
    with torch.no_grad():
        got = tb.model(torch.from_numpy(mel)).numpy()
    assert np.abs(np.asarray(jb.model.apply(jb.params, jnp.asarray(mel))) - got).max() <= 0.05
    assert sorted(np.load(tmp_path / "port.npz").files) == sorted(np.load(tmp_path / "jax.npz").files)


def test_whisper_checkpoints_cross_both_ways(tmp_path, whisper_pair, whisper_batches):
    _, (mel, ids, _, _) = whisper_batches
    cfg = TWC.test(vocab_size=1864)
    ta = TW(cfg, tokenizer=t_tok(), device="cpu")
    ta.init_params(11)
    ta.save_pretrained(tmp_path / "port")
    ja = JW.from_pretrained(tmp_path / "port")
    with torch.no_grad():
        got = ta.model(torch.from_numpy(mel[:1]), torch.from_numpy(ids[:1, :-1]))[0].numpy()
    want = np.asarray(ja.model.apply(ja.params, jnp.asarray(mel[:1]), jnp.asarray(ids[:1, :-1]))[0])
    assert np.abs(want - got).max() <= 0.05
    assert ja.tokenizer.encode("le chat") == ta.tokenizer.encode("le chat")
    jb, _ = whisper_pair
    jb = JW(JWC.test(vocab_size=1864), tokenizer=j_tok())
    jb.params = jb.model.init(jax.random.PRNGKey(5), jnp.asarray(mel[:1]), jnp.asarray(ids[:1, :-1]))
    jb.save_pretrained(tmp_path / "jax")
    tb = TW.from_pretrained(tmp_path / "jax", device="cpu")
    with torch.no_grad():
        got = tb.model(torch.from_numpy(mel[:1]), torch.from_numpy(ids[:1, :-1]))[0].numpy()
    want = np.asarray(jb.model.apply(jb.params, jnp.asarray(mel[:1]), jnp.asarray(ids[:1, :-1]))[0])
    assert np.abs(want - got).max() <= 0.05
    for name in ("config.json", "tokenizer.bpe.json"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
