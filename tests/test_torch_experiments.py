"""The PyTorch port's data plumbing and experiment drivers against the JAX
package's, on the CPU, on ``tests/test_harnesses.py:make_bdd`` data:
``models/datasets.py``, ``models/fewshot.py``, ``models/report_html.py``
and ``models/experiment.py``.

What is held equal: every dataset function, the prompts, the JSON repair,
the SSML builder, the scores, the ``StubLLM`` experiment (its result JSON
and its HTML report, byte for byte) and the report HTML.
(``LocalLLMClient`` is held to the JAX package's in ``tests/test_torch_serving.py``.)

The break and BiLSTM drivers train; they are compared from the same
(converted) flax initialisations, with dropout off on both sides (the two
frameworks cannot draw the same dropout masks). Their reports must have the
same keys and counts; the bootstrap's metrics and the BiLSTM's errors agree
within the stated tolerances (the bfloat16 forward differs by a few 1e-2 in
the logits, ``tests/test_torch_bert.py``). The cascade driver's report has
the JAX report's structure (its models train from each framework's own
initialisation). ``break_tagger.npz`` written by the port loads through the
JAX package's ``load_params`` into its ``BreakTagger`` and gives the port's
logits.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prosody_control_french_tts_tpu.align.ctc_aligner import load_params as jload_params
from prosody_control_french_tts_tpu.models import bert as jbert
from prosody_control_french_tts_tpu.models import bilstm as jbilstm
from prosody_control_french_tts_tpu.models import datasets as jdata
from prosody_control_french_tts_tpu.models import experiment as jexp
from prosody_control_french_tts_tpu.models import fewshot as jfew
from prosody_control_french_tts_tpu.models import report_html as jreport
from prosody_control_french_tts_tpu.models.tokenizer import WordPieceTokenizer as JTokenizer
from prosody_control_french_tts_tpu_torch import convert
from prosody_control_french_tts_tpu_torch.models import bert as tbert
from prosody_control_french_tts_tpu_torch.models import bilstm as tbilstm
from prosody_control_french_tts_tpu_torch.models import bilstm_runner as trunner
from prosody_control_french_tts_tpu_torch.models import break_trainer as ttrainer
from prosody_control_french_tts_tpu_torch.models import datasets as tdata
from prosody_control_french_tts_tpu_torch.models import experiment as texp
from prosody_control_french_tts_tpu_torch.models import fewshot as tfew
from prosody_control_french_tts_tpu_torch.models import report_html as treport
from prosody_control_french_tts_tpu_torch.models.tokenizer import WordPieceTokenizer as TTokenizer
from tests.test_harnesses import make_bdd

TOL_LOGITS = 6e-2  # the shipped tagger against the jitted flax forward (tests/test_torch_bert.py)


@pytest.fixture(scope="module")
def bdd_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("bdd") / "bdd.json"
    p.write_text(json.dumps(make_bdd(n_segments=4, words_per=6)), encoding="utf-8")
    return p


# -- datasets ----------------------------------------------------------------------

BDDS = {"default": dict(), "dense": dict(n_segments=3, words_per=9, break_every=2, seed=1),
        "long": dict(n_segments=2, words_per=40, break_every=5, seed=2)}


@pytest.mark.parametrize("kind", list(BDDS))
def test_datasets_equal(kind):
    bdd = make_bdd(**BDDS[kind])
    assert list(tdata.iter_voice_entries(bdd)) == list(jdata.iter_voice_entries(bdd))
    for _, seq in jdata.iter_voice_entries(bdd):
        assert tdata.sequence_to_break_words(seq) == jdata.sequence_to_break_words(seq)
        assert tdata.sequence_to_prosody_rows(seq) == jdata.sequence_to_prosody_rows(seq)
        text = jdata.text_with_breaks(seq)
        assert tdata.text_with_breaks(seq) == text
        for max_words in (5, 17, 100):
            assert tdata.chunk_at_sentences(text, max_words) == jdata.chunk_at_sentences(text, max_words)
    for max_words in (10, 100):
        assert tdata.qwen_a_pairs(bdd, max_words) == jdata.qwen_a_pairs(bdd, max_words)
        assert tdata.qwen_b_triples(bdd, max_words) == jdata.qwen_b_triples(bdd, max_words)
    items = list(range(37))
    for seed in (0, 42):
        assert tdata.split_80_10_10(items, seed) == jdata.split_80_10_10(items, seed)
    texts = [r["text"] for _, s in jdata.iter_voice_entries(bdd) for r in jdata.sequence_to_prosody_rows(s)]
    jtok = JTokenizer.train(texts, vocab_size=300, min_freq=1)
    ttok = TTokenizer(vocab=dict(jtok.vocab))
    for max_len, per in ((32, 1), (16, 1), (64, 2)):
        want = jdata.build_break_dataset(bdd, jtok, max_len=max_len, sentences_per_example=per)
        got = tdata.build_break_dataset(bdd, ttok, max_len=max_len, sentences_per_example=per)
        for field in ("ids", "mask", "labels"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_load_bdd_equal(bdd_file):
    assert tdata.load_bdd(bdd_file) == jdata.load_bdd(bdd_file)


# -- fewshot -------------------------------------------------------------------------

RESPONSES = [
    '[{"text": "a", "pitch": "+1.00%"}]',
    'noise before [{"a": 1}] and after',
    '```json\n[{"a": 1}]\n```',
    "<think>hmm [x]</think>[{\"b\": 2}]",
    'x {"a":1} y {"b":2} z {broken',
    "nothing parseable",
    "",
    '{"single": "object"}',
]


@pytest.mark.parametrize("i", range(len(RESPONSES)))
def test_parse_json_response_equal(i):
    assert tfew.parse_json_response(RESPONSES[i]) == jfew.parse_json_response(RESPONSES[i])


def test_prompts_ssml_and_scores_equal():
    bdd = make_bdd()
    samples = jfew.samples_from_bdd(bdd)
    assert tfew.samples_from_bdd(bdd) == samples
    assert tfew.samples_from_bdd(bdd, max_segments=3) == jfew.samples_from_bdd(bdd, max_segments=3)
    ex = [(s["segments"], s["segments"]) for s in samples[:2]]
    for examples in (None, ex):
        assert tfew.build_prompt(samples[3]["segments"], examples) == jfew.build_prompt(samples[3]["segments"], examples)
    preds = [s["segments"] for s in samples[:3]] + [None, [], [{"text": "x", "pitch": "+2%", "break_after_ms": 250}]]
    for p in preds[:3] + preds[5:]:
        assert tfew.predictions_to_ssml(p) == jfew.predictions_to_ssml(p)
    assert tfew.predictions_to_ssml(preds[5], voice="v") == jfew.predictions_to_ssml(preds[5], voice="v")
    got = tfew.evaluate_predictions(samples[:6], preds)
    want = jfew.evaluate_predictions(samples[:6], preds)
    assert got.as_dict() == want.as_dict()


@pytest.mark.parametrize("noise", [0.0, 0.7])
def test_stub_experiment_equal(noise):
    samples = jfew.samples_from_bdd(make_bdd(seed=3))
    few = [(s["segments"], s["segments"]) for s in samples[:2]]
    got, gp = tfew.run_experiment(tfew.StubLLM(noise=noise, seed=1), samples[2:], few, parallel_requests=1)
    want, wp = jfew.run_experiment(jfew.StubLLM(noise=noise, seed=1), samples[2:], few, parallel_requests=1)
    assert gp == wp and got.as_dict() == want.as_dict()


def test_experiment_config_from_yaml_equal(tmp_path):
    p = tmp_path / "config.yaml"
    p.write_text("models: [stub, local]\nnum_samples: 7\nmode: zeroshot\nparallel_requests: 3\n", encoding="utf-8")
    assert dataclasses.asdict(tfew.ExperimentConfig.from_yaml(str(p))) == dataclasses.asdict(jfew.ExperimentConfig.from_yaml(str(p)))
    assert dataclasses.asdict(tfew.ExperimentConfig()) == dataclasses.asdict(jfew.ExperimentConfig())


# -- report_html ---------------------------------------------------------------------


def test_report_html_equal(tmp_path):
    results = {"stub": jfew.evaluate_predictions(jfew.samples_from_bdd(make_bdd())[:3], [None] * 3).as_dict(),
               "m&<x>": {"break_f1": 0.5, "n": 3, "mae": {"pitch": 1.0}, "r2": {}}}
    samples = {"stub": [{"id": "s1", "gold": "<speak>a</speak>", "pred": "<speak>b & c</speak>"}, {"gold": "g"}]}
    a = treport.write_comparison_html(results, tmp_path / "t" / "c.html", samples, title="T <1>")
    b = jreport.write_comparison_html(results, tmp_path / "j" / "c.html", samples, title="T <1>")
    assert a.read_bytes() == b.read_bytes()


# -- the experiment drivers ----------------------------------------------------------


def test_fewshot_experiment_files_equal(bdd_file, tmp_path):
    for mode in ("fewshot", "zeroshot"):
        kw = dict(models=["stub", "other"], num_samples=12, num_few_shot_examples=2, mode=mode, parallel_requests=1)
        got = texp.run_fewshot_experiment(bdd_file, tmp_path / f"t{mode}", config=tfew.ExperimentConfig(**kw),
                                          clients={"stub": tfew.StubLLM(noise=0.5), "other": tfew.StubLLM(noise=2.0, seed=4)})
        want = jexp.run_fewshot_experiment(bdd_file, tmp_path / f"j{mode}", config=jfew.ExperimentConfig(**kw),
                                           clients={"stub": jfew.StubLLM(noise=0.5), "other": jfew.StubLLM(noise=2.0, seed=4)})
        assert got == want
        for name in ("result_stub.json", "result_other.json", "comparison.html"):
            assert (tmp_path / f"t{mode}" / name).read_bytes() == (tmp_path / f"j{mode}" / name).read_bytes(), name


def _tiny_without_dropout(module, monkeypatch):
    monkeypatch.setattr(module.BertConfig, "tiny", classmethod(
        lambda cls, vocab_size=8000: cls(vocab_size=vocab_size, hidden=128, layers=2, heads=4, ffn=512, dropout=0.0)))


def test_break_experiment_matches_jax(bdd_file, tmp_path, monkeypatch):
    """Two bootstrap runs of two epochs, tiny tagger, dropout off on both
    sides, the port started from the flax initialisation of each run's seed.
    Measured: every run's F1, precision, recall and accuracy equal, the
    perplexities within 5.5e-4 relative (held within 1e-2)."""
    _tiny_without_dropout(jbert, monkeypatch)
    _tiny_without_dropout(tbert, monkeypatch)

    def flax_init(cfg, seed, device):
        jc = jbert.BertConfig(**dataclasses.asdict(cfg))
        z = jnp.zeros((1, cfg.max_len), jnp.int32)
        params = jax.jit(jbert.BreakTagger(jc).init)(jax.random.PRNGKey(seed), z, z != 0)
        m = tbert.BreakTagger(cfg, seed=None, device=device)
        m.load_state_dict(convert.bert_params_from_jax(jax.tree.map(np.asarray, params)))
        return m

    monkeypatch.setattr(ttrainer, "init_tagger", flax_init)
    got = texp.run_break_experiment(bdd_file, tmp_path / "t", runs=2, epochs=2, tiny=True, device="cpu")
    want = jexp.run_break_experiment(bdd_file, tmp_path / "j", runs=2, epochs=2, tiny=True)
    assert got.keys() == want.keys()
    assert got["sentences_per_second"] > 0
    for g, w in zip(got["runs"], want["runs"]):
        for k in ("f1", "precision", "recall", "accuracy"):
            assert g[k] == pytest.approx(w[k], abs=1e-9), k
        assert g["perplexity"] == pytest.approx(w["perplexity"], rel=1e-2)
    on_disk = json.loads((tmp_path / "t" / "break_report.json").read_text(encoding="utf-8"))
    assert on_disk == json.loads(json.dumps(got))
    assert (tmp_path / "t" / "tokenizer.json").read_bytes() == (tmp_path / "j" / "tokenizer.json").read_bytes()

    # the port's checkpoint, read by the JAX package, gives the port's logits
    saved_t, saved_j = np.load(tmp_path / "t" / "break_tagger.npz"), np.load(tmp_path / "j" / "break_tagger.npz")
    assert sorted(saved_t.files) == sorted(saved_j.files)
    assert all(saved_t[k].shape == saved_j[k].shape and saved_t[k].dtype == saved_j[k].dtype for k in saved_j.files)
    tok = TTokenizer.load(tmp_path / "t" / "tokenizer.json")
    cfg = tbert.BertConfig.tiny(vocab_size=len(tok))
    ds = tdata.build_break_dataset(tdata.load_bdd(bdd_file), tok, max_len=cfg.max_len)
    params = jload_params(tmp_path / "t" / "break_tagger.npz")
    want_logits = np.asarray(jax.jit(jbert.BreakTagger(jbert.BertConfig(**dataclasses.asdict(cfg))).apply)(
        params, jnp.asarray(ds.ids), jnp.asarray(ds.mask)))
    model = tbert.BreakTagger(cfg, seed=None, device="cpu").eval()
    model.load_state_dict(convert.bert_params_from_jax(jax.tree.map(np.asarray, params)))  # exact round trip
    with torch.no_grad():
        got_logits = model(torch.as_tensor(ds.ids), torch.as_tensor(ds.mask)).numpy()
    assert np.abs(got_logits - want_logits)[ds.mask].max() <= TOL_LOGITS


def test_bilstm_experiment_matches_jax(bdd_file, tmp_path, monkeypatch):
    """One seq_len, three epochs; the port's sentence encoder and regressor
    start from the flax initialisations the JAX runner draws (encoder seed 0,
    regressor seed 42). The port's bfloat16 sentence embeddings differ from
    flax's (cosine ≥ 0.9999, ``tests/test_torch_bilstm.py``), and three
    epochs of training carry that into the errors: held within 1e-2 relative
    (measured at most 2.8e-3 over seq_len 1 to 3); n_train / n_test equal."""

    def flax_encoder(cfg, seed, device):
        jc = jbert.BertConfig(**dataclasses.asdict(cfg))
        z = jnp.zeros((1, cfg.max_len), jnp.int32)
        params = jax.jit(jbert.SentenceEncoder(jc).init)(jax.random.PRNGKey(seed), z, z != 0)
        m = tbert.SentenceEncoder(cfg, seed=None, device=device)
        m.load_state_dict(convert.bert_params_from_jax(jax.tree.map(np.asarray, params)))
        return m

    def flax_regressor(cfg, seed, device):
        model = jbilstm.BiLSTMProsody(jbilstm.BiLSTMConfig(embed_dim=cfg.embed_dim))
        params = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 1, cfg.embed_dim)))
        m = tbilstm.BiLSTMProsody(cfg, seed=None, device=device)
        m.load_state_dict(convert.bilstm_params_from_jax(jax.tree.map(np.asarray, params)))
        return m

    monkeypatch.setattr(trunner, "init_encoder", flax_encoder)
    monkeypatch.setattr(tbilstm, "init_bilstm", flax_regressor)
    got = texp.run_bilstm_experiment(bdd_file, tmp_path / "t", seq_lens=(2,), epochs=3, device="cpu")
    want = jexp.run_bilstm_experiment(bdd_file, tmp_path / "j", seq_lens=(2,), epochs=3)
    assert json.loads((tmp_path / "t" / "bilstm_report.json").read_text(encoding="utf-8")) == got
    assert len(got) == len(want) == 1
    g, w = got[0], want[0]
    assert g.keys() == w.keys()
    assert (g["seq_len"], g["n_train"], g["n_test"]) == (w["seq_len"], w["n_train"], w["n_test"])
    for k in ("z_mse", "z_mae"):
        assert g[k] == pytest.approx(w[k], rel=1e-2), k
    for k in ("raw_mse", "raw_mae"):
        assert g[k].keys() == w[k].keys()
        for name in w[k]:
            assert g[k][name] == pytest.approx(w[k][name], rel=1e-2), (k, name)


def _structure(x):
    if isinstance(x, dict):
        return {k: _structure(v) for k, v in x.items()}
    return type(x).__name__ if not isinstance(x, (int, float)) or isinstance(x, bool) else "number"


def test_cascade_experiment_has_the_jax_report(bdd_file, tmp_path):
    got = texp.run_cascade_experiment(bdd_file, tmp_path / "t", epochs=1, tiny=True, device="cpu")
    want = jexp.run_cascade_experiment(bdd_file, tmp_path / "j", epochs=1, tiny=True)
    assert _structure(got) == _structure(want)
    assert got["stage_a"]["n"] == want["stage_a"]["n"] and got["stage_b"]["total"] == want["stage_b"]["total"]
    assert 0.0 <= got["stage_a"]["break_f1"] <= 1.0 and np.isfinite(got["stage_a"]["final_train_loss"])
    assert json.loads((tmp_path / "t" / "cascade_report.json").read_text(encoding="utf-8")) == got
