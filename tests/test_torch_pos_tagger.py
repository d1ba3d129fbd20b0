"""The PyTorch port's contextual POS tagger (``models/pos_data.py``,
``models/pos_tagger.py``, ``convert.pos_tagger_params_*``) against the JAX
package's, on the CPU, and ``pos_backend: contextual`` through the eight
steps of both pipelines.

Tolerances, and what was measured with them:
- the silver treebank, tokenisation, trigram hashes and featuriser arrays:
  equal;
- ``PosTagger`` logits on the packaged weights against the eager flax
  ``apply`` (op by op, as ``jax.disable_jit`` runs it): 1e-4 (1.3e-5
  measured over 200 held-out sentences, padded positions included); against
  the jitted flax forward the same 1e-4 (8.4e-6 measured; the two flax
  forwards differ from each other by 4.8e-6). Tags are held equal wherever
  the flax top-2 margin is at least 1e-3, and the tokens under that margin
  are counted (none of 992 on these sentences);
- one training step from the converted flax initialisation on the same
  batch: the loss within 1e-5 (7e-7 measured), the gradients within 1e-6
  (1.3e-7 measured), and every updated leaf within 1e-5 of optax's AdamW
  step wherever its gradient is at least 1e-6; below that, Adam's first
  step lr · g / (|g| + 1e-8) follows the rounding of g (the key biases'
  gradients are 0 in exact arithmetic), and those leaves are held within
  the step's bound lr;
- checkpoints written by either package load in the other with equal
  logits (1e-4; the leaves are float16 on disk);
- the pipeline: every artifact byte-equal to the JAX pipeline's, on a voice
  whose words make the contextual and lexicon backends decide differently.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from prosody_control_french_tts_tpu.core.config import PipelineConfig as JConfig
from prosody_control_french_tts_tpu.core.pipeline import AudioPipeline as JPipeline
from prosody_control_french_tts_tpu.models import pos_data as jdata
from prosody_control_french_tts_tpu.models import pos_tagger as jpos
from prosody_control_french_tts_tpu.ssml import syntagme as jsyn
from prosody_control_french_tts_tpu.tts.fake import FakeBackend as JFake
from prosody_control_french_tts_tpu.utils import wavio as jwav
from prosody_control_french_tts_tpu.utils.textgridio import word_tier_with_silences, write_textgrid
from prosody_control_french_tts_tpu_torch import convert
from prosody_control_french_tts_tpu_torch.core.config import PipelineConfig as TConfig
from prosody_control_french_tts_tpu_torch.core.pipeline import AudioPipeline as TPipeline
from prosody_control_french_tts_tpu_torch.models import pos_data as tdata
from prosody_control_french_tts_tpu_torch.models import pos_tagger as tpos
from prosody_control_french_tts_tpu_torch.ssml import syntagme as tsyn
from prosody_control_french_tts_tpu_torch.tts.fake import FakeBackend as TFake
from prosody_control_french_tts_tpu_torch.utils import fr_pos

LOGIT_TOL = 1e-4
MARGIN = 1e-3
STEP_TOL = 1e-5



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these ops are small, and with the suite's
    parallel workers a thread pool in each only contends for the cores
    (held-out tagging took 278 s that way, 1 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def packaged():
    """(JAX params, JAX featurizer, cfg, JAX tagger, port tagger)."""
    params, feat, cfg = jpos.load_tagger()
    return params, feat, cfg, jpos.ContextualTagger(params, feat, cfg), tpos.ContextualTagger(device="cpu")


@pytest.fixture(scope="module")
def held_out():
    return tdata.generate_treebank(800, seed=99, holdout_fillers=True)


@pytest.fixture(scope="module")
def flax_forward(packaged):
    """The packaged tagger's jitted flax forward, shared so that the file's
    batches of the first 200 held-out sentences compile it once."""
    _, feat, cfg, _, _ = packaged
    return jax.jit(jpos.PosTagger(cfg, vocab_size=len(feat.vocab)).apply)


# -- host side -------------------------------------------------------------------


@pytest.mark.parametrize("n,seed,holdout", [(300, 0, False), (300, 99, True), (50, 7, True)])
def test_treebank_equal(n, seed, holdout):
    got = tdata.generate_treebank(n, seed=seed, holdout_fillers=holdout)
    want = jdata.generate_treebank(n, seed=seed, holdout_fillers=holdout)
    assert [(s.words, s.tags) for s in got] == [(s.words, s.tags) for s in want]
    assert tdata.TAGS == jdata.TAGS and tdata.FORBIDDEN_TAGS == jdata.FORBIDDEN_TAGS


TEXTS = ["c'est l'or qu'il voulait", "Jusqu'à demain, lorsqu’il viendra", "il a mangé le gâteau",
         "le son , de la voix", "quoiqu'elle dise, puisqu'il pleut", "L'Été est là ! n'est-ce pas ?"]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_and_featurizer_equal(packaged, text):
    _, jfeat, cfg, _, tagger = packaged
    toks = tpos.tokenize_with_elisions(text)
    assert toks == jpos.tokenize_with_elisions(text)
    for t in toks:
        assert tpos._char_ngrams(t) == jpos._char_ngrams(t)
    for a, b in zip(tagger.feat.encode_tokens(toks), jfeat.encode_tokens(toks)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_featurizer_build_equal():
    sents = tdata.generate_treebank(400, seed=3)
    got = tpos.Featurizer.build(sents, tpos.PosTaggerConfig())
    want = jpos.Featurizer.build(sents, jpos.PosTaggerConfig())
    assert got.vocab == want.vocab
    toks = [list(s.words) for s in sents[:50]]
    for a, b in zip(got.encode_batch(toks), want.encode_batch(toks)):
        assert np.array_equal(a, b)


# -- the model -------------------------------------------------------------------


def test_logits_match_flax_and_tags_where_the_margin_allows(packaged, held_out, flax_forward):
    params, feat, cfg, _, tagger = packaged
    w, c, m = feat.encode_batch([list(s.words) for s in held_out[:200]])
    model = jpos.PosTagger(cfg, vocab_size=len(feat.vocab))
    with jax.disable_jit():
        eager = np.asarray(model.apply({"params": params}, w, c, m))
    jitted = np.asarray(flax_forward({"params": params}, w, c, m))
    got = tagger.logits(w, c, m).numpy()
    live = m > 0
    err, err_jit = np.abs(got - eager).max(), np.abs(got - jitted).max()
    print(f"pos tagger logits: eager flax {err:.3e}, jitted flax {err_jit:.3e}, eager vs jitted "
          f"{np.abs(eager - jitted).max():.3e}")
    assert err <= LOGIT_TOL and err_jit <= LOGIT_TOL
    top2 = np.sort(eager, -1)[..., -2:]
    sure = live & (top2[..., 1] - top2[..., 0] >= MARGIN)
    assert (got.argmax(-1) == eager.argmax(-1))[sure].all()
    print(f"tokens under the {MARGIN} margin: {int((live & ~sure).sum())} of {int(live.sum())}")


def test_windowed_path_gives_equal_tags(packaged, held_out):
    """Inputs of 40-90 tokens go through overlapping 32-token windows (stride
    16): the tags and the window plan's choice are the JAX tagger's."""
    _, _, _, jtag, tagger = packaged
    rng = np.random.default_rng(5)
    for _ in range(6):
        toks: list[str] = []
        target = int(rng.integers(40, 91))
        while len(toks) < target:
            toks.extend(held_out[int(rng.integers(len(held_out)))].words)
        toks = toks[:target]
        assert tagger.tag_tokens(toks) == jtag.tag_tokens(toks)


def test_held_out_gates(packaged, held_out):
    """The JAX suite's gates (tests/test_pos_tagger.py) on the port: token
    accuracy > 0.88, ambiguous forms > 0.95, the forbidden bit > 0.98 and
    above the lexicon's."""
    tagger = packaged[4]
    amb = {"a", "son", "or", "car", "personne", "tout", "toute", "tous", "si", "soit", "avant", "apres", "après",
           "pendant", "devant", "vers", "entre", "bien", "ete", "été", "pas", "leur", "en", "le", "la", "les", "que",
           "comme", "est"}
    tot = ok = amb_tot = amb_ok = fb_ok = lex_fb_ok = 0
    for s in held_out:
        for w, gold, p in zip(s.words, s.tags, tagger.tag_tokens(list(s.words))):
            tot += 1
            ok += p == gold
            amb_tot += w.lower() in amb
            amb_ok += w.lower() in amb and p == gold
            fb_ok += (p in tdata.FORBIDDEN_TAGS) == (gold in tdata.FORBIDDEN_TAGS)
            lex_fb_ok += fr_pos.is_function_word(w) == (gold in tdata.FORBIDDEN_TAGS)
    assert ok / tot > 0.88 and amb_ok / amb_tot > 0.95
    assert fb_ok / tot > 0.98 and fb_ok > lex_fb_ok


MINIMAL_PAIRS = [  # (sentence, token index after the elision split, expected tag): JAX tests/test_pos_tagger.py
    ("il a mangé le gâteau", 1, "AUX"), ("le train arrive a paris", 3, "ADP"),
    ("son violon sonne doucement", 0, "DET"), ("le son de la cloche est clair", 1, "NOUN"),
    ("or , il pleut", 0, "CCONJ"), ("l' or brille vraiment", 1, "NOUN"), ("il reste car il pleut", 2, "CCONJ"),
    ("le car est parti", 1, "NOUN"), ("personne ne répond", 0, "PRON"), ("cette personne est calme", 1, "NOUN"),
    ("tout le monde chante", 0, "DET"), ("il marche tout doucement", 2, "ADV"),
    ("si tu viens , je chante", 0, "SCONJ"), ("le chemin est si long", 3, "ADV"),
    ("il faut qu' il soit là", 4, "AUX"), ("soit le piano soit le violon", 0, "CCONJ"),
    ("elle fait un pas vers la porte", 3, "NOUN"), ("il ne dort pas", 3, "ADV"),
    ("leur maison est grande", 0, "DET"), ("il leur parle souvent", 1, "PRON"),
]


@pytest.mark.parametrize("sentence,idx,want", MINIMAL_PAIRS)
def test_minimal_pair(packaged, sentence, idx, want):
    _, _, _, jtag, tagger = packaged
    toks = tpos.tokenize_with_elisions(sentence)
    tags = tagger.tag_tokens(toks)
    assert tags[idx] == want and tags == jtag.tag_tokens(toks)


@pytest.mark.parametrize("text,want,lexicon_changes", [
    ("le son , clair et net , résonne", "le son , clair et net , résonne", True),
    ("le car , un vieux car bleu , arrive", "le car , un vieux car bleu , arrive", True),
    ("il pense que , demain viendra", "il pense que demain viendra", False),
])
def test_comma_filter(packaged, text, want, lexicon_changes):
    _, _, _, jtag, tagger = packaged
    assert tagger.remove_spurious_commas(text) == want == jtag.remove_spurious_commas(text)
    assert (fr_pos.remove_spurious_commas(text) != text) == (text != want or lexicon_changes)


PAUSE_CASES = {  # (words and pauses, whether the pause at 400 ms survives the contextual filter)
    "noun_son": ([("word", "le", 200), ("word", "son", 300), ("pause", None, 400), ("word", "résonne", 500)], True),
    "det_son": ([("word", "son", 300), ("pause", None, 400), ("word", "violon", 500), ("word", "sonne", 500)], False),
    "unqueried_car": ([("word", "car", 200), ("word", "il", 150), ("word", "pleut", 250), ("word", "le", 150),
                       ("word", "car", 300), ("pause", None, 400), ("word", "arrive", 500)], True),
}


@pytest.mark.parametrize("case", sorted(PAUSE_CASES))
def test_pause_filter_hook(packaged, case):
    """The sentence-aware ``pos_of`` in the syntagme pause filter: after NOUN
    "son" the pause stays, after DET "son" it goes (the lexicon drops both);
    an earlier unqueried "car" must not take the query meant for the second."""
    _, _, _, jtag, tagger = packaged
    seq, kept = PAUSE_CASES[case]
    words = [t for k, t, _ in seq if k == "word"]
    got = tsyn.filter_function_word_pauses(seq, tagger.make_pos_of(words))
    assert got == jsyn.filter_function_word_pauses(seq, jtag.make_pos_of(words))
    assert (("pause", None, 400) in got) == kept
    if case != "unqueried_car":
        assert ("pause", None, 400) not in tsyn.filter_function_word_pauses(seq)


def test_pos_of_closure_keeps_its_own_pointer(packaged):
    """Index-less queries scan forward from a pointer each closure keeps: the
    same queries give the JAX closure's answers in order, and a second
    closure over the same words starts again from the beginning."""
    _, _, _, jtag, tagger = packaged
    words = ["car", "il", "pleut", "le", "car", "a", "son", "or", "le", "son", "tout", "car"]
    queries = [("car", None), ("son", None), ("car", 4), ("son", None), ("or", None), ("car", None),
               ("car", None), ("tout", 10), ("son", 2), ("le", None), ("si", None)]
    for _ in range(2):
        got_fn, want_fn = tagger.make_pos_of(words), jtag.make_pos_of(words)
        assert [got_fn(q, i) for q, i in queries] == [want_fn(q, i) for q, i in queries]


def test_real_sentence_golden(packaged):
    """tests/goldens/fr_pos_sentences.json: the hybrid backend's forbidden
    bit equals the JAX package's at every graded token and beats the
    lexicon's, at least 0.92."""
    _, _, _, jtag, tagger = packaged
    g = json.loads((Path(__file__).parent / "goldens" / "fr_pos_sentences.json").read_text(encoding="utf-8"))
    ok_l = ok_h = n = 0
    for e in g["sentences"]:
        toks = e["tokens"]
        ctags = tagger.tag_tokens(toks)
        jtags = jtag.tag_tokens(toks)
        for idx, gold in e["gold"].items():
            i = int(idx)
            n += 1
            lb = fr_pos.pos_tag(toks[i]) in fr_pos.FORBIDDEN
            hb = ctags[i] in tdata.FORBIDDEN_TAGS if tpos._norm(toks[i]) in tpos.AMBIGUOUS_FORMS else lb
            assert hb == (jtags[i] in tdata.FORBIDDEN_TAGS if tpos._norm(toks[i]) in tpos.AMBIGUOUS_FORMS else lb)
            ok_l += lb == gold["forbidden"]
            ok_h += hb == gold["forbidden"]
    assert n >= 45 and ok_h >= ok_l and ok_h / n >= 0.92


@pytest.mark.parametrize("name", ["lexicon", "contextual", "spacy"])
def test_get_pos_backend(name):
    if name == "spacy":
        with pytest.raises(ValueError, match="unknown pos backend"):
            tpos.get_pos_backend(name, device="cpu")
        return
    b = tpos.get_pos_backend(name, device="cpu")
    jb = jpos.get_pos_backend(name)
    if name == "lexicon":
        assert b.first_token_pos is fr_pos.first_token_pos and b.pos_of_factory is None
        return
    for text in ("son violon", "le son", "a paris", "car il pleut", "maison", ""):
        assert b.first_token_pos(text) == jb.first_token_pos(text)
    assert b.remove_spurious_commas("le son , clair") == jb.remove_spurious_commas("le son , clair")
    assert b.pos_of_factory(["le", "son"])("son", 1) == jb.pos_of_factory(["le", "son"])("son", 1)


# -- conversion, checkpoints, training -------------------------------------------------


def test_conversion_round_trip(packaged):
    params, _, cfg, _, tagger = packaged
    flat = {k: np.asarray(v) for k, v in convert._flatten(params).items()}
    back = convert.pos_tagger_params_to_jax(convert.pos_tagger_params_from_jax(params), cfg)
    assert back.keys() == flat.keys()
    for k in flat:
        assert back[k].shape == flat[k].shape and np.array_equal(back[k], flat[k]), k
    assert convert.pos_tagger_params_from_jax({"params": params}).keys() == tagger.model.state_dict().keys()
    with pytest.raises(ValueError, match="unknown leaf"):
        convert.pos_tagger_params_from_jax({**flat, "block0/Dense_9/kernel": flat["out/kernel"]})


def test_checkpoints_load_across_packages(packaged, held_out, flax_forward, tmp_path):
    """``save_tagger`` of the port → JAX ``load_tagger``, and the reverse:
    equal vocabularies, configs and logits (the JAX side's jitted forward)."""
    params, feat, cfg, _, tagger = packaged
    w, c, m = feat.encode_batch([list(s.words) for s in held_out[:200]])
    state = {k: v + 1e-3 * torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
             for k, v in tagger.model.state_dict().items()}
    tpos.save_tagger(state, tagger.feat, tagger.cfg, tmp_path / "port.npz")
    jp, jf, jc = jpos.load_tagger(tmp_path / "port.npz")
    assert jf.vocab == feat.vocab and dataclasses.asdict(jc) == dataclasses.asdict(cfg)
    want = np.asarray(flax_forward({"params": jp}, w, c, m))
    got = tpos.ContextualTagger(*tpos.load_tagger(tmp_path / "port.npz"), device="cpu").logits(w, c, m).numpy()
    assert np.abs(got - want).max() <= LOGIT_TOL
    jpos.save_tagger(params, feat, cfg, tmp_path / "jax.npz")
    got = tpos.ContextualTagger(*tpos.load_tagger(tmp_path / "jax.npz"), device="cpu").logits(w, c, m).numpy()
    assert np.abs(got - np.asarray(flax_forward({"params": params}, w, c, m))).max() <= LOGIT_TOL


@pytest.fixture()
def flax_init(monkeypatch):
    """The port's trainer starting from the JAX trainer's own initialisation
    (``model.init(PRNGKey(seed), wid[:2], cid[:2], mask[:2])``), converted.
    Both trainers run that ``init`` through one ``jax.jit`` (within 3e-8 of
    its eager form, and one compile of ~3 s where the eager primitives take
    ~8 s)."""
    made = {}
    jitted = jax.jit(jpos.PosTagger.init, static_argnums=0)
    monkeypatch.setattr(jpos.PosTagger, "init", lambda self, *a: jitted(self, *a))

    def init(cfg, vocab_size, seed, device):
        sents = made["sentences"]
        feat = jpos.Featurizer.build(sents, jpos.PosTaggerConfig(**dataclasses.asdict(cfg)))
        wid, cid, mask = feat.encode_batch([list(s.words) for s in sents[:2]])
        jparams = jpos.PosTagger(feat.cfg, vocab_size=vocab_size).init(jax.random.PRNGKey(seed), wid, cid, mask)
        made["params"] = jparams["params"]
        model = tpos.PosTagger(cfg, vocab_size=vocab_size, seed=None, device=device)
        model.load_state_dict(convert.pos_tagger_params_from_jax(jparams))
        return model

    monkeypatch.setattr(tpos, "init_pos_tagger", init)
    return made


def test_one_training_step_matches_optax(flax_init):
    """One step of both trainers from the same initialisation on the same
    batch (the JAX trainer's first draws from ``default_rng(seed)``): the
    loss within 1e-5, and every leaf within 1e-5 wherever the gradient is at
    least 1e-6. Adam's first step moves a leaf by lr · g / (|g| + 1e-8), so
    where |g| is near 1e-8 (the key biases' gradients are 0 in exact
    arithmetic: a softmax ignores them; both sides give ~1e-9 of rounding)
    the step's sign and size follow the rounding; there the leaves are held
    within the step's bound, lr, and the gradients within 1e-6."""
    sents = tdata.generate_treebank(96, seed=0)
    flax_init["sentences"] = sents
    losses = []
    lr = 3e-3
    state, feat, cfg = tpos.train_pos_tagger(sents, steps=1, batch_size=32, lr=lr, seed=4, log_every=0,
                                             device="cpu", losses=losses)
    jparams, jfeat, _ = jpos.train_pos_tagger(sents, steps=1, batch_size=32, lr=lr, seed=4, log_every=0)
    assert feat.vocab == jfeat.vocab
    wid, cid, mask = jfeat.encode_batch([list(s.words) for s in sents])
    tags = np.zeros((len(sents), cfg.max_len), np.int32)
    for i, s in enumerate(sents):
        tags[i, : len(s.tags)] = [tdata.TAG_TO_ID[t] for t in s.tags[: cfg.max_len]]
    open_ids = [tdata.TAG_TO_ID[t] for t in ("NOUN", "VERB", "ADJ", "ADV", "PROPN", "NUM")]
    rng = np.random.default_rng(4)
    idx = rng.integers(0, len(sents), 32)
    bw = wid[idx].copy()
    bw[np.isin(tags, open_ids)[idx] & (mask[idx] > 0) & (rng.random(bw.shape) < 0.35)] = 1
    batch = (bw, cid[idx], mask[idx], tags[idx])
    jmodel = jpos.PosTagger(jfeat.cfg, vocab_size=len(jfeat.vocab))
    jloss, jgrad = jax.jit(jax.value_and_grad(jpos._loss_fn), static_argnums=1)(flax_init["params"], jmodel, batch)
    assert abs(losses[0] - float(jloss)) <= STEP_TOL
    tmodel = tpos.PosTagger(cfg, vocab_size=len(feat.vocab), seed=None)
    init = convert.pos_tagger_params_from_jax(jax.tree.map(np.asarray, flax_init["params"]))
    tmodel.load_state_dict(init)
    tpos._loss_fn(tmodel(*(torch.as_tensor(a) for a in batch[:3])), torch.as_tensor(batch[3]),
                  torch.as_tensor(batch[2])).backward()
    grads = dict(tmodel.named_parameters())
    jgrad = convert.pos_tagger_params_from_jax(jax.tree.map(np.asarray, jgrad))
    want = convert.pos_tagger_params_from_jax(jax.tree.map(np.asarray, jparams))
    tiny = 0
    for k, v in want.items():
        g = jgrad[k]
        assert float((grads[k].grad - g).abs().max()) <= 1e-6, k
        sure = g.abs() >= 1e-6
        tiny += int((~sure).sum())
        d = (state[k] - v).abs()
        assert float(torch.where(sure, d, 0.0).max()) <= STEP_TOL, k
        assert float(d.max()) <= lr * (1 + 1e-3), k
        assert not sure.any() or float(torch.where(sure, (v - init[k]).abs(), 0.0).max()) > 0  # the step moved them
    print(f"leaves with |g| < 1e-6 (held within lr): {tiny}")


def test_training_reduces_the_loss():
    losses = []
    tpos.train_pos_tagger(tdata.generate_treebank(256, seed=1), steps=30, batch_size=32, seed=2, log_every=0,
                          device="cpu", losses=losses)
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.6 * np.mean(losses[:5])


# -- pos_backend: contextual through the eight steps ------------------------------------------

SR = 44100
NAME = "ctxvoice"
SEGMENTS = {  # words that the two backends read differently, with a pause after some of them
    "segment_ph1": [("bonjour", 0), ("le", 0), ("son,", 350), ("de", 0), ("la", 0), ("voix", 0),
                    ("change.", 400), ("il", 0), ("a", 300), ("mangé", 0), ("le", 0), ("gâteau.", 0)],
    "segment_ph2": [("le", 0), ("car,", 300), ("un", 0), ("vieux", 0), ("car", 0), ("bleu,", 250),
                    ("arrive.", 400), ("cette", 0), ("personne", 300), ("parle", 0), ("bien.", 0)],
}
STEPS = ["Align+Transcribe", "Raw Synthesis", "Measure & Build SSML", "Synthesize+Merge", "Export JSON",
         "Final Transcribe", "Compare Breaks"]


def _config(pos_backend: str) -> dict:
    return {"data_dir": "Data/voice", "out_dir": "Out", "voice_names": [NAME], "tts_backend": "fake",
            "aligner": "precomputed", "steps_to_run": STEPS, "pos_backend": pos_backend,
            "silence": {"min_silence_len": 1000, "silence_thresh": -50, "keep_silence": 300}}


def _build_voice(base: Path) -> None:
    vdir = base / "Data" / "voice" / NAME
    (vdir / "audio").mkdir(parents=True)
    (vdir / "transcription_raw").mkdir(parents=True)
    tg_dir = vdir / "WhisperTS_textgrid_files"
    tg_dir.mkdir(parents=True)
    gen = JFake(seed=7)
    for seg, wp in SEGMENTS.items():
        chunks, times, cursor = [], [], 0.0
        for word, pause_ms in wp:
            a = gen._voice(word, pitch_pct=5.0, rate_pct=0.0, volume_pct=0.0)
            times.append((cursor, cursor + len(a) / SR, word))
            cursor += len(a) / SR
            chunks.append(a)
            if pause_ms:
                chunks.append(np.zeros(int(pause_ms * SR / 1000)))
                cursor += pause_ms / 1000.0
        x = np.concatenate(chunks)
        jwav.write_wav(vdir / "audio" / f"{seg}.wav", x, SR)
        write_textgrid(word_tier_with_silences(times, total_duration=len(x) / SR), tg_dir / f"{seg}.TextGrid")
        (vdir / "transcription_raw" / f"{seg}.txt").write_text(" ".join(w for w, _ in wp), encoding="utf-8")


def _artifacts(base: Path) -> dict:
    return {str(p.relative_to(base)): p.read_bytes() for p in sorted(base.rglob("*"))
            if p.is_file() and p.name != "step_timings.jsonl" and "logs" not in p.parts}


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    out = {}
    for side, backend in (("jax", "contextual"), ("jax", "lexicon"), ("torch", "contextual"), ("torch", "lexicon")):
        base = tmp_path_factory.mktemp(f"{side}_{backend}")
        _build_voice(base)
        if side == "jax":
            JPipeline(NAME, JConfig.from_dict(_config(backend), base), tts=JFake(seed=1)).run()
        else:
            TPipeline(NAME, TConfig.from_dict(_config(backend), base), tts=TFake(seed=1), device="cpu").run()
        out[side, backend] = _artifacts(base)
    return out


def test_contextual_pipeline_is_byte_equal_to_jax(pipeline_runs):
    got, want = pipeline_runs["torch", "contextual"], pipeline_runs["jax", "contextual"]
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name


def test_contextual_pipeline_differs_from_lexicon_where_jax_does(pipeline_runs):
    """The voice's words must make the backends disagree (otherwise the
    byte equality above would hold with a tagger that never runs), and the
    port's two runs differ in the same artifacts as the JAX package's."""
    j_ctx, j_lex = pipeline_runs["jax", "contextual"], pipeline_runs["jax", "lexicon"]
    t_ctx, t_lex = pipeline_runs["torch", "contextual"], pipeline_runs["torch", "lexicon"]
    differ = {k for k in j_ctx.keys() | j_lex.keys() if j_ctx.get(k) != j_lex.get(k)}
    assert {k for k in t_ctx.keys() | t_lex.keys() if t_ctx.get(k) != t_lex.get(k)} == differ
    assert {f"Out/results/{NAME}/pause_comparison_full.csv", f"Out/results/{NAME}/BDD_syntagme_ssml.csv"} <= differ
