"""The PyTorch port's serving layer (``serving/batcher.py``,
``serving/predictor.py``) on the CPU: the micro-batcher's semantics, with
the three faults of the JAX package's batcher that the port does not copy,
and the SSML predictor against the JAX package's on the same texts and the
same (converted) weights, with and without the prosody head, plus its HTTP
routes; and the few-shot harness's ``LocalLLMClient`` (the in-framework
decoder served greedily) against the JAX package's.

The predictors are compared twice. Given the same model outputs (the port's
modules replaced by the flax ones, jitted), words, breaks, prosody strings
and SSML are equal. Run end to end, the port's own forward differs from the
jitted flax forward by a few 1e-2 in the logits (``tests/test_torch_bert.py``),
so the breaks are held equal wherever the flax margin |l1 − l0| of a word's
first token exceeds 0.05, and a text's SSML wherever all its words do; the
prosody head's percentages (from bfloat16 embeddings) within 0.02 points.
Measured on the texts below: every break equal (11 of 11 texts, the
smallest margin 0.04), the SSML of all 11 equal without the head, the
percentages within 0.01 with it.
"""

import dataclasses
import http.client
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prosody_control_french_tts_tpu.models import bert as jbert
from prosody_control_french_tts_tpu.models import bilstm as jbilstm
from prosody_control_french_tts_tpu.models import fewshot as jfew
from prosody_control_french_tts_tpu.models import llm as jllm
from prosody_control_french_tts_tpu.models.tokenizer import WordPieceTokenizer as JTokenizer
from prosody_control_french_tts_tpu.serving.predictor import SSMLPredictor as JPredictor
from prosody_control_french_tts_tpu_torch import convert
from prosody_control_french_tts_tpu_torch.models import bert as tbert
from prosody_control_french_tts_tpu_torch.models import fewshot as tfew
from prosody_control_french_tts_tpu_torch.models import llm as tllm
from prosody_control_french_tts_tpu_torch.models.tokenizer import WordPieceTokenizer as TTokenizer
from prosody_control_french_tts_tpu_torch.serving import batcher as tbatcher
from prosody_control_french_tts_tpu_torch.serving.batcher import MicroBatcher
from prosody_control_french_tts_tpu_torch.serving.predictor import SSMLPredictor

MARGIN = 0.05

# -- the micro-batcher --------------------------------------------------------


def test_batches_concurrent_requests():
    sizes = []

    def fn(items):
        sizes.append(len(items))
        return [i * 2 for i in items]

    b = MicroBatcher(fn, max_batch=16, max_wait_ms=30)
    try:
        with ThreadPoolExecutor(max_workers=8) as ex:
            results = list(ex.map(b.submit, range(8)))
        assert results == [i * 2 for i in range(8)]
        assert max(sizes) > 1 and sum(sizes) == 8
        assert b.stats.summary()["flushes"] == len(sizes)
    finally:
        assert b.close(timeout_s=2.0)


def test_error_reaches_every_request_of_the_flush():
    def fn(items):
        raise RuntimeError(f"kaboom {len(items)}")

    b = MicroBatcher(fn, max_batch=8, max_wait_ms=30)
    errors = []

    def call(i):
        try:
            b.submit(i)
        except RuntimeError as e:
            errors.append(str(e))

    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert len(errors) == 5 and all(e.startswith("kaboom") for e in errors)
    finally:
        b.close(timeout_s=2.0)


def test_a_wrong_number_of_results_is_an_error():
    b = MicroBatcher(lambda items: [], max_batch=4, max_wait_ms=1)
    try:
        with pytest.raises(RuntimeError, match="returned 0 results for 1 items"):
            b.submit(1)
    finally:
        b.close(timeout_s=2.0)


def test_close_returns_within_its_bound_when_batch_fn_never_returns():
    """The JAX package's ``close()`` waits for every permit with no timeout
    (its ``batcher.py:137``); the port's wait ends at its bound."""
    release = threading.Event()
    b = MicroBatcher(lambda items: (release.wait(), items)[1], max_batch=4, max_wait_ms=1, pipeline_depth=1)
    try:
        with pytest.raises(TimeoutError):
            b.submit(1, timeout_s=0.2)
        t0 = time.monotonic()
        assert b.close(timeout_s=0.5) is False  # the flush in flight never finished
        assert time.monotonic() - t0 < 2.0
        with pytest.raises(RuntimeError, match="closed"):
            b.submit(2)
    finally:
        release.set()


def test_close_fails_what_is_still_queued():
    release = threading.Event()
    b = MicroBatcher(lambda items: (release.wait(), items)[1], max_batch=1, max_wait_ms=1, pipeline_depth=1)
    errors = []

    def call(i):
        try:
            b.submit(i, timeout_s=10)
        except RuntimeError as e:
            errors.append(str(e))
        except TimeoutError:
            errors.append("timeout")

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)  # one flush holds the only permit, the others wait
        b.close(timeout_s=0.3)
    finally:
        release.set()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert sorted(errors) == sorted(["the batcher was closed before the batch ran"] * 2)


class _Spy(threading.Semaphore):
    """A permit that records, when it is given back, what the flush had
    done by then."""

    def __init__(self, value, batcher):
        super().__init__(value)
        self.batcher = batcher
        self.seen = []

    def release(self, n=1):
        flushed = self.batcher.flushed[-1] if self.batcher.flushed else []
        self.seen.append((len(self.batcher.stats.batch_sizes), all(p.event.is_set() for p in flushed), len(flushed)))
        super().release(n)


class _Recording(MicroBatcher):
    def _finish(self, batch, t_flush):
        self.flushed.append(batch)
        super()._finish(batch, t_flush)


def test_permit_is_released_after_stats_and_wakeup():
    """The JAX package releases the permit before the stats are recorded and
    the requests woken (its ``batcher.py:123``); the port releases it last."""
    b = _Recording.__new__(_Recording)
    b.flushed = []
    MicroBatcher.__init__(b, lambda items: items, max_batch=4, max_wait_ms=1, pipeline_depth=1)
    b._inflight = _Spy(1, b)
    try:
        for i in range(3):
            assert b.submit(i) == i
        deadline = time.monotonic() + 5
        while len(b._inflight.seen) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert b._inflight.seen == [(1, True, 1), (2, True, 1), (3, True, 1)]
    finally:
        b.close(timeout_s=2.0)


def test_docstring_says_batch_fn_runs_concurrently():
    doc = MicroBatcher.__doc__
    assert "pipeline_depth" in doc and "concurrently" in doc


def test_stress_no_request_or_stat_is_lost():
    """More client threads than cores, a short switch interval, several
    flushes in flight: every request gets its own answer, and the stats count
    every request once."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    b = MicroBatcher(lambda items: [(i, i * i) for i in items], max_batch=8, max_wait_ms=0.5, pipeline_depth=3)
    try:
        with ThreadPoolExecutor(max_workers=32) as ex:
            out = list(ex.map(lambda i: b.submit(i, timeout_s=30), range(400)))
        assert out == [(i, i * i) for i in range(400)]
        assert sum(b.stats.batch_sizes) == 400 and len(b.stats.queue_s) == 400
    finally:
        sys.setswitchinterval(old)
        assert b.close(timeout_s=5.0)


def test_stats_summary_and_clear():
    s = tbatcher.BatcherStats()
    assert s.summary() == {}
    s.record(4, 0.002, [0.001] * 4)
    s.record(2, 0.004, [0.003] * 2)
    got = s.summary()
    assert got["flushes"] == 2 and got["batch_fill_max"] == 4 and got["batch_fill_mean"] == 3.0
    s.clear()
    assert s.summary() == {}


# -- the SSML predictor ---------------------------------------------------------

TEXTS = [
    "bonjour le monde",
    "la voix parle bien fort.",
    "un deux trois quatre cinq six sept huit neuf dix onze douze treize quatorze",
    "chat & chien <rouge> vert",
    "merci",
    "le grand chien parle doucement à la maison bleue, puis le petit chat dort.",
] + [f"un deux trois {i} maison" for i in range(5)]
TRAIN = ["bonjour le monde merci", "la voix parle bien fort", "un deux trois quatre cinq six sept huit neuf dix",
         "le grand chien parle doucement à la maison bleue puis le petit chat dort rouge vert"]


@pytest.fixture(scope="module")
def models():
    jtok = JTokenizer.train(TRAIN, vocab_size=200, min_freq=1)
    kw = dict(vocab_size=len(jtok), hidden=32, layers=1, heads=2, ffn=64, max_len=16)
    jc, tc = jbert.BertConfig(**kw), tbert.BertConfig(**kw)
    z = jnp.zeros((1, jc.max_len), jnp.int32)
    one = jnp.ones((1, jc.max_len), bool)
    tagger = jax.jit(jbert.BreakTagger(jc).init)(jax.random.PRNGKey(0), z, one)
    enc = jax.jit(jbert.SentenceEncoder(jc).init)(jax.random.PRNGKey(1), z, one)
    reg = jax.jit(jbilstm.BiLSTMProsody(jbilstm.BiLSTMConfig(embed_dim=jc.hidden)).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 1, jc.hidden)))
    mu, sd = np.array([0.5, -1.0, 2.0]), np.array([2.0, 3.0, 0.5])
    return dict(jtok=jtok, ttok=TTokenizer(vocab=dict(jtok.vocab)), jc=jc, tc=tc, tagger=tagger, enc=enc, reg=reg,
                mu=mu, sd=sd)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def predictors(m, prosody: bool, max_batch=4):
    jpros = tpros = None
    if prosody:
        jpros = {"bilstm_params": m["reg"], "encoder_params": m["enc"], "mu": m["mu"], "sd": m["sd"]}
        tpros = {"bilstm_state": convert.bilstm_params_from_jax(_np(m["reg"])),
                 "encoder_state": convert.bert_params_from_jax(_np(m["enc"])), "mu": m["mu"], "sd": m["sd"]}
    jp = JPredictor(m["jtok"], m["jc"], m["tagger"], max_batch=max_batch, max_wait_ms=1, prosody=jpros)
    tp = SSMLPredictor(m["ttok"], m["tc"], convert.bert_params_from_jax(_np(m["tagger"])), device="cpu",
                       max_batch=max_batch, max_wait_ms=1, prosody=tpros)
    return jp, tp


def close(*preds):
    for p in preds:
        if isinstance(p, SSMLPredictor):
            assert p.close()
        else:
            p.batcher.close()


class _FlaxOutputs(torch.nn.Module):
    """Stands in for a port module: the jitted flax forward on the same ids."""

    def __init__(self, module, params):
        super().__init__()
        self.fn = jax.jit(module.apply)
        self.params = params

    def forward(self, *args):
        return torch.from_numpy(np.array(self.fn(self.params, *(jnp.asarray(a.numpy()) for a in args))))


@pytest.mark.parametrize("prosody", [False, True], ids=["breaks", "prosody"])
def test_predictor_equals_jax_given_the_same_model_outputs(models, prosody):
    jp, tp = predictors(models, prosody)
    try:
        tp.model = _FlaxOutputs(jbert.BreakTagger(models["jc"]), models["tagger"])
        if prosody:
            tp._enc = _FlaxOutputs(jbert.SentenceEncoder(models["jc"]), models["enc"])
        for chunk in (TEXTS[:1], TEXTS[:3], TEXTS[:4], TEXTS[4:8], TEXTS[8:]):
            got, want = tp._predict_batch(chunk), jp._predict_batch(chunk)
            assert got == want
        assert any(any(o["breaks"]) for o in tp._predict_batch(TEXTS[:4]))
        if prosody:
            assert all("<prosody pitch=" in o["ssml"] for o in got)
    finally:
        close(jp, tp)


def word_margins(models, text):
    """The flax margin |l1 − l0| at each word's first token, as the predictor
    pads the text (one row)."""
    tok, jc = models["jtok"], models["jc"]
    ids = np.full((1, jc.max_len), tok.pad_id, np.int32)
    tok_ids, widx = tok.encode_words(text.split())
    ids[0, : min(len(tok_ids), jc.max_len)] = tok_ids[: jc.max_len]
    mask = ids != tok.pad_id
    mask[:, 0] = True
    logits = np.asarray(jax.jit(jbert.BreakTagger(jc).apply)(models["tagger"], jnp.asarray(ids), jnp.asarray(mask)))[0]
    margin = np.full(len(text.split()), np.inf)
    for t, w in enumerate(widx[: jc.max_len]):
        if w >= 0:
            margin[w] = abs(logits[t, 1] - logits[t, 0])
    return margin


@pytest.mark.parametrize("prosody", [False, True], ids=["breaks", "prosody"])
def test_predictor_end_to_end_agrees_with_jax(models, prosody):
    jp, tp = predictors(models, prosody)
    try:
        got = [tp.predict(t) for t in TEXTS]
        want = [jp.predict(t) for t in TEXTS]
    finally:
        close(jp, tp)
    whole = 0
    for text, g, w in zip(TEXTS, got, want):
        assert g["words"] == w["words"] == text.split()
        sure = word_margins(models, text) > MARGIN
        assert (np.asarray(g["breaks"]) == np.asarray(w["breaks"]))[sure].all(), text
        if sure.all() and not prosody:
            assert g["ssml"] == w["ssml"]
            whole += 1
        if prosody:  # the encoder's bfloat16 embeddings differ slightly: within 0.02 points
            for k in ("pitch", "volume", "rate"):
                assert abs(float(g["prosody"][k][:-1]) - float(w["prosody"][k][:-1])) <= 0.02 + 1e-9
    if not prosody:
        assert whole >= len(TEXTS) // 2


def test_buckets_are_powers_of_two_clamped_at_max_batch(models):
    _, tp = predictors(models, False, max_batch=24)
    try:
        assert tp.bucket_sizes() == [1, 2, 4, 8, 16, 24]
        assert [tp._bucket(n) for n in (1, 2, 3, 5, 9, 17, 24)] == [1, 2, 4, 8, 16, 24, 24]
        assert len(tp._predict_batch(TEXTS[:3])) == 3  # padded to 4 rows, 3 returned
    finally:
        close(tp)


def test_http_routes(models):
    _, tp = predictors(models, False, max_batch=8)
    httpd = tp.serve(port=0)
    port = httpd.server_address[1]
    base = f"http://127.0.0.1:{port}"
    try:
        assert type(httpd).request_queue_size == 128
        handler = tp.make_handler()
        assert handler.protocol_version == "HTTP/1.1" and handler.disable_nagle_algorithm
        assert json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=10).read()) == {"status": "ok"}

        def post(path, body):
            req = urllib.request.Request(f"{base}{path}", data=body, headers={"Content-Type": "application/json"})
            return json.loads(urllib.request.urlopen(req, timeout=10).read())

        one = post("/ssml", json.dumps({"text": "bonjour le monde"}).encode())
        assert one["words"] == ["bonjour", "le", "monde"] and one["ssml"].startswith("<speak")
        many = post("/ssml", json.dumps({"texts": TEXTS[:3]}).encode())
        assert [o["words"] for o in many] == [t.split() for t in TEXTS[:3]]
        for path, body, code in (("/ssml", b"{not json", 400), ("/ssml", b'{"nothing": 1}', 400), ("/other", b"{}", 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                post(path, body)
            assert e.value.code == code
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nowhere", timeout=10)
        assert e.value.code == 404

        def client(i):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)  # one kept-alive connection
            outs = []
            for j in range(4):
                conn.request("POST", "/ssml", json.dumps({"text": f"un deux trois {i} {j}"}),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                assert resp.status == 200
                outs.append(json.loads(resp.read()))
            conn.close()
            return outs

        with ThreadPoolExecutor(max_workers=6) as ex:
            outs = [o for chunk in ex.map(client, range(6)) for o in chunk]
        assert len(outs) == 24 and all(o["ssml"].startswith("<speak") for o in outs)
        assert max(tp.batcher.stats.batch_sizes) > 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        close(tp)


# -- the few-shot harness's LLM client -------------------------------------------


def test_local_llm_client_equal():
    """Greedy completions of the same float32 weights, through the port's
    ``greedy_generate`` and the JAX package's."""
    texts = ["le chat dort sur la maison", "bonjour le monde merci", "la voix parle bien fort"]
    jtok = JTokenizer.train(texts, vocab_size=120, min_freq=1)
    ttok = TTokenizer(vocab=dict(jtok.vocab))
    jcfg = dataclasses.replace(jllm.LLMConfig.tiny(len(jtok)), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllm.LLMConfig.tiny(len(jtok)), dtype=torch.float32)
    jmodel = jllm.DecoderLM(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 4), jnp.int32))
    tmodel = tllm.DecoderLM(tcfg, device="cpu")
    tmodel.load_state_dict(convert.llm_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
    want = jfew.LocalLLMClient(jmodel, jparams, jtok, max_new=10).complete("le chat dort")
    got = tfew.LocalLLMClient(tmodel, ttok, max_new=10, device="cpu").complete("le chat dort")
    assert isinstance(got, str) and got == want
