"""The port's Whisper aligner against the JAX package's, on the CPU.

At ``WhisperConfig.test()`` widths with flax-initialised weights converted
(``convert.whisper_params_from_jax``), the same mel into both: the encoder
output and the decoder logits agree within 0.05 (|.| of order 1 to 5): the
two round to bfloat16 at the same points, but their float32 LayerNorm and
softmax sums add in other orders, and a last-bit difference there can round
a bfloat16 value the other way. The greedy tokens (free and
lexicon-constrained) are held equal, and the DTW spans on the same
attention rows. With the packaged checkpoint: ``transcribe`` equal, the
lexicon-constrained spans pass on four held-out clips with equal tokens and
every span within one encoder frame (measured on eight: 18 of 2,032 span
ends one frame apart, where the two packages' attention rows differ in
their last bits), ``align_batch`` with equal words and
boundaries within one encoder frame (20 ms), the window and VAD plans equal,
and the copied host modules (tokenizer, lexicon trie, synthesizer) equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosody_control_french_tts_tpu.align import lexicon_decode as jlex
from prosody_control_french_tts_tpu.align import synth_speech as jsynth
from prosody_control_french_tts_tpu.align import whisper_jax as jw
from prosody_control_french_tts_tpu.align.pretrain_whisper import PACKAGED_DIR as J_DIR
from prosody_control_french_tts_tpu.models import bpe_tokenizer as jbpe
from prosody_control_french_tts_tpu.utils.wavio import Audio as JAudio
from prosody_control_french_tts_tpu_torch import convert
from prosody_control_french_tts_tpu_torch.align import lexicon_decode as tlex
from prosody_control_french_tts_tpu_torch.align import synth_speech as tsynth
from prosody_control_french_tts_tpu_torch.align import whisper as tw
from prosody_control_french_tts_tpu_torch.align.pretrain_whisper import PACKAGED_DIR as T_DIR
from prosody_control_french_tts_tpu_torch.models import bpe_tokenizer as tbpe
from prosody_control_french_tts_tpu_torch.utils.wavio import Audio as TAudio

TOL_MODEL = 0.05
SOT, EOT = 257, 256
FRAME_DT = 0.02


@pytest.fixture(scope="module")
def small_models():
    """WhisperConfig.test() (vocab 260: the byte axis, eot and sot) with
    flax-initialised weights in both packages."""
    jcfg = jw.WhisperConfig.test(vocab_size=260)
    jmodel = jw.WhisperModel(jcfg)
    mel = np.random.default_rng(0).standard_normal((3, 300, 80)).astype(np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(mel[:1]), jnp.zeros((1, 4), jnp.int32))
    tree = jax.tree.map(np.asarray, params)
    tmodel = tw.WhisperModel(tw.WhisperConfig.test(vocab_size=260))
    tmodel.load_state_dict(convert.whisper_params_from_jax(tree))
    return jmodel, params, tmodel.eval(), mel


def test_encoder_and_decoder_match_flax(small_models):
    jmodel, params, tmodel, mel = small_models
    toks = np.random.default_rng(1).integers(0, 260, (3, 12)).astype(np.int32)
    jlogits, jcross = jax.jit(lambda p, m, t: jmodel.apply(p, m, t, True))(params, jnp.asarray(mel), jnp.asarray(toks))
    jenc = jax.jit(lambda p, m: jmodel.apply(p, m, method=jw.WhisperModel.encode))(params, jnp.asarray(mel))
    with torch.no_grad():
        tenc = tmodel.encode(torch.from_numpy(mel))
        tlogits, tcross = tmodel(torch.from_numpy(mel), torch.from_numpy(toks), True)
    assert np.abs(tenc.numpy() - np.asarray(jenc)).max() <= TOL_MODEL
    assert np.abs(tlogits.numpy() - np.asarray(jlogits)).max() <= TOL_MODEL
    assert np.abs(tcross[0].numpy() - np.asarray(jcross[0])).max() <= 1e-2


def test_kv_cache_refuses_overflow():
    cache = tw.KVCache(1, 4, 2, 8, torch.bfloat16, "cpu")
    cache.write(3, torch.zeros(1, 1, 2, 8), torch.zeros(1, 1, 2, 8))
    with pytest.raises(ValueError, match="overflow"):
        cache.write(4, torch.zeros(1, 1, 2, 8), torch.zeros(1, 1, 2, 8))


@pytest.mark.parametrize("lexicon", [False, True])
def test_greedy_tokens_equal(small_models, lexicon):
    """Random weights rarely emit eot, so rows run to max_new; the third
    row is batch padding (inactive) and stays eot."""
    jmodel, params, tmodel, mel = small_models
    max_new = 12
    active = np.array([True, True, False])
    trie = jlex.default_trie() if lexicon else None
    jfn = jw.make_greedy_fn(jmodel, max_new, trie=trie)
    jt, jatt = jfn(params, jnp.asarray(mel), SOT, EOT, jnp.asarray(active))
    tfn = tw.make_greedy_fn(tmodel, max_new, trie=tlex.default_trie() if lexicon else None)
    tt, tatt = tfn(torch.from_numpy(mel), SOT, EOT, torch.from_numpy(active))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert (tt.numpy()[2, 1:] == EOT).all()
    assert np.abs(tatt.numpy() - np.asarray(jatt)).max() <= 1e-2


def test_greedy_spans_equal(small_models):
    """Tokens and counts equal, and the port's DP on the JAX package's
    attention rows gives its spans bit for bit. (The port's own rows differ
    from JAX's in the last bits, and at the raw flax initialisation every
    token attends almost uniformly, each of 150 frames near 1/150: the DP's
    choices then hinge on those bits, so the spans from each package's own
    rows are compared on the packaged checkpoint, below.)"""
    jmodel, params, tmodel, mel = small_models
    max_new = 10
    active = np.array([True, True, False])
    fr = np.array([150, 97, 1], np.int32)
    jfn = jw.make_greedy_spans_fn(jmodel, max_new)
    jt, jn, jspans = jfn(params, jnp.asarray(mel), SOT, EOT, jnp.asarray(fr), jnp.asarray(active))
    tt, tn, _ = tw.make_greedy_spans_fn(tmodel, max_new)(torch.from_numpy(mel), SOT, EOT, torch.from_numpy(fr),
                                                          torch.from_numpy(active))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _, jatt = jw.make_greedy_fn(jmodel, max_new)(params, jnp.asarray(mel), SOT, EOT, jnp.asarray(active))
    dp = tw._attention_spans_device(torch.from_numpy(np.asarray(jatt)), torch.from_numpy(np.asarray(jn)).long(),
                                    torch.from_numpy(fr).long(), max_new)
    np.testing.assert_array_equal(dp.numpy(), np.asarray(jspans))


@pytest.fixture(scope="module")
def packaged():
    return jw.WhisperAligner(), tw.WhisperAligner(device="cpu")


def test_packaged_transcribe_equal(packaged):
    ja, ta = packaged
    a, _ = jsynth.synth_sentence("la musique commence demain matin", seed=444_000)
    got = ta.transcribe(TAudio(a, 16000))
    assert got == ja.transcribe(JAudio(a, 16000))
    assert got.strip() == "la musique commence demain matin"


def test_packaged_greedy_spans_within_a_frame(packaged):
    ja, ta = packaged
    sents = jsynth.sample_sentences(4, seed=555_000)
    audios = [jsynth.synth_sentence(s, seed=555_000 + i)[0] for i, s in enumerate(sents)]
    mel = np.asarray(ja._mel_batch(np.stack([ja._audio_window(JAudio(a, 16000)) for a in audios])))
    fr = np.array([int(np.ceil(len(a) / 16000 / FRAME_DT)) for a in audios], np.int32)
    active = np.ones(4, bool)
    jt, jn, jspans = jw.make_greedy_spans_fn(ja.model, 127, trie=jlex.default_trie())(
        ja.params, jnp.asarray(mel), SOT, EOT, jnp.asarray(fr), jnp.asarray(active))
    tt, tn, tspans = tw.make_greedy_spans_fn(ta.model, 127, trie=tlex.default_trie())(
        torch.from_numpy(mel), SOT, EOT, torch.from_numpy(fr), torch.from_numpy(active))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert np.abs(tspans.numpy() - np.asarray(jspans)).max() <= 1.0


def _words(tg):
    return [(iv.min_time, iv.max_time, iv.mark) for iv in tg.tiers[0] if iv.mark.strip()]


@pytest.mark.parametrize("forced", [False, True])
def test_align_batch_matches_jax(packaged, forced):
    ja, ta = packaged
    sents = jsynth.sample_sentences(3, seed=321_000)
    audios = [jsynth.synth_sentence(s, seed=321_000 + i)[0] for i, s in enumerate(sents)]
    trs = sents if forced else None
    want = ja.align_batch([JAudio(a, 16000) for a in audios], trs)
    got = ta.align_batch([TAudio(a, 16000) for a in audios], trs)
    for w, g in zip(want, got):
        w, g = _words(w), _words(g)
        assert [m for *_, m in g] == [m for *_, m in w]
        for (a0, a1, _), (b0, b1, _) in zip(w, g):
            assert abs(a0 - b0) <= FRAME_DT + 1e-6 and abs(a1 - b1) <= FRAME_DT + 1e-6, (w, g)


def test_window_and_vad_plans_equal(packaged):
    """A clip longer than the 10.24 s window: the VAD regions, their word
    budgets and the window chunks are planned alike."""
    ja, ta = packaged
    sents = jsynth.sample_sentences(4, seed=12_000, min_words=7, max_words=9)
    parts = []
    for i, s in enumerate(sents):
        parts += [jsynth.synth_sentence(s, seed=12_000 + i)[0], np.zeros(8000, np.float32)]
    x = np.concatenate(parts)
    assert x.shape[0] / 16000 > 10.24
    text = " ".join(sents)
    assert tw.vad_speech_regions(TAudio(x, 16000), device="cpu") == jw.vad_speech_regions(JAudio(x, 16000))
    for tr in (None, text):
        jr, jjobs = ja._plan_jobs(JAudio(x, 16000), tr)
        tr_, tjobs = ta._plan_jobs(TAudio(x, 16000), tr)
        assert tr_ == jr
        assert [(j["t0"], j["transcript"], j["audio"].samples.shape) for j in tjobs] == \
               [(j["t0"], j["transcript"], j["audio"].samples.shape) for j in jjobs]
    jchunks = ja._window_chunks(JAudio(x, 16000), text, 0.0)
    tchunks = ta._window_chunks(TAudio(x, 16000), text, 0.0)
    assert len(tchunks) == 2
    assert [(j["t0"], j["transcript"], j["audio"].samples.shape) for j in tchunks] == \
           [(j["t0"], j["transcript"], j["audio"].samples.shape) for j in jchunks]


def test_host_side_equal():
    """The host side: DTW timestamps from an attention matrix (one and a
    batch), word grouping, the audio gates, the disfluency marks, and the
    placeholder TextGrid of a silent clip."""
    rng = np.random.default_rng(4)
    ws = [rng.uniform(0, 1, (n, f)).astype(np.float32) ** 4 for n, f in ((5, 40), (13, 300), (1, 7))]
    np.testing.assert_array_equal(tw.spans_from_attention(ws[1], device="cpu"), jw.spans_from_attention(ws[1]))
    for got, want in zip(tw.spans_from_attention_batch(ws, device="cpu"), jw.spans_from_attention_batch(ws)):
        np.testing.assert_array_equal(got, want)
    pieces, spans = [" bon", "jour", " le", " monde"], np.array([[0.0, 0.1], [0.1, 0.3], [0.3, 0.4], [0.5, 0.9]])
    assert [vars(w) for w in tw.group_word_times(pieces, spans)] == [vars(w) for w in jw.group_word_times(pieces, spans)]
    for x in (np.zeros(16000), np.ones(16000) * 1e-4, 0.3 * np.sin(np.arange(16000) / 5.0), np.zeros(0)):
        assert tw.check_audio_content(x) == jw.check_audio_content(x)
    words = [tw.AlignedWord(0.1, 0.4, "a"), tw.AlignedWord(1.0, 1.3, "b"), tw.AlignedWord(1.35, 2.0, "c")]
    jwords = [jw.AlignedWord(w.start, w.end, w.word) for w in words]
    regions = [(0.0, 2.1)]
    assert [vars(w) for w in tw.mark_disfluencies(words, regions)] == [vars(w) for w in jw.mark_disfluencies(jwords, regions)]
    silent = tw.WhisperAligner(tw.WhisperConfig.test(), device="cpu").align(TAudio(np.zeros(16000, np.float32), 16000))
    assert [iv.mark for iv in silent.tiers[0] if iv.mark.strip()] == [tw.EMPTY_TEXT]


def test_copied_host_modules_equal():
    jt, tt = jbpe.load_whisper_tokenizer(J_DIR), tbpe.load_whisper_tokenizer(T_DIR)
    text = "l'histoire de la musique française"
    assert tt.encode(text) == jt.encode(text)
    assert tt.pieces_with_boundaries(tt.encode(text)[1:-1]) == jt.pieces_with_boundaries(jt.encode(text)[1:-1])
    jtrie, ttrie = jlex.default_trie(), tlex.default_trie()
    np.testing.assert_array_equal(ttrie.trans, jtrie.trans)
    np.testing.assert_array_equal(ttrie.can_end, jtrie.can_end)
    np.testing.assert_array_equal(ttrie.end_bonus, jtrie.end_bonus)
    assert tsynth.FR_CHARS == jsynth.FR_CHARS
    assert tsynth.sample_sentences(5, seed=3) == jsynth.sample_sentences(5, seed=3)
    ja, jg = jsynth.synth_sentence("bonjour le monde", seed=9)
    ta, tg = tsynth.synth_sentence("bonjour le monde", seed=9)
    np.testing.assert_array_equal(ta, ja)
    assert tg == jg
    for name in ("config.json", "tokenizer.bpe.json", "weights.npz"):
        assert (T_DIR / name).read_bytes() == (J_DIR / name).read_bytes()
