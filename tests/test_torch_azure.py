"""The port's Azure TTS backend (``tts/azure.py``, the SSML helpers of
``tts/base.py``, the Azure keys of ``core/config.py``) against the JAX
package's, with no network: the REST protocol is served from a loopback
``ThreadingHTTPServer`` or the transport is stubbed.

- The cases of the JAX suite's ``tests/test_tts_azure.py``, each held to the
  JAX function on the same input: the RIFF decode, the SSML helpers, the
  400 fallback to the simplified document, retries with back-off (with
  ``time.sleep`` recorded, not slept) and their exhaustion.
- The default ``PipelineConfig`` builds a pipeline (the JAX package's does
  not: its key lookup reads ``base_dir`` as a file); the key file and the
  ``AZURE_API_KEY`` fallback.
- One run of each package's pipeline with ``tts_backend: azure`` against
  the same loopback server, which answers each POST with the RIFF of the
  fake TTS for the posted SSML: the same requests, and every artifact
  byte-equal.
"""

import struct
import threading
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

from prosody_control_french_tts_tpu.core.config import PipelineConfig as JConfig
from prosody_control_french_tts_tpu.core.pipeline import AudioPipeline as JPipeline
from prosody_control_french_tts_tpu.tts import azure as jaz, base as jbase
from prosody_control_french_tts_tpu_torch.core.config import PipelineConfig as TConfig
from prosody_control_french_tts_tpu_torch.core.pipeline import AudioPipeline as TPipeline
from prosody_control_french_tts_tpu_torch.tts import azure as taz, base as tbase
from prosody_control_french_tts_tpu_torch.tts.fake import FakeBackend
from prosody_control_french_tts_tpu_torch.utils.synth import lay_out_voice, synth_voice
from prosody_control_french_tts_tpu_torch.utils.textgridio import read_textgrid


def riff_bytes(samples: np.ndarray, rate: int = 44100) -> bytes:
    pcm = np.clip(np.round(samples * 32768), -32768, 32767).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(pcm))
    return hdr + pcm


SSML = (
    '<speak xmlns="http://www.w3.org/2001/10/synthesis" version="1.0" xml:lang="fr-FR">'
    '<voice name="v"><prosody pitch="+1.50%" rate="-2.00%" volume="+0.25%">bonjour le monde'
    '<break time="300ms"/></prosody></voice></speak>'
)
DOCUMENTS = [
    SSML,
    "<speak/>",
    "plain text, no tags",
    '<speak><voice name="x">a<break time="50ms"/>b <break time="1200ms" /> c</voice></speak>',
    '<speak><prosody pitch="-3%" rate="+10.5%" volume="-1%">  un   deux\n trois </prosody><break time="7ms"/></speak>',
    '<speak version=\'1.0\' xml:lang=\'fr-FR\'><voice name=\'fr-FR-HenriNeural\'>l\'été, déjà.</voice></speak>',
]


# --- the RIFF decode --------------------------------------------------------


@pytest.mark.parametrize("rate", [24000, 44100])
def test_riff_decode_matches_jax(rate):
    x = np.linspace(-0.5, 0.5, 1000)
    got, want = taz._decode_riff(riff_bytes(x, rate)), jaz._decode_riff(riff_bytes(x, rate))
    assert got.rate == want.rate == rate
    assert got.samples.dtype == want.samples.dtype == np.float32
    assert got.samples.tobytes() == want.samples.tobytes()
    assert np.abs(got.samples - x).max() < 1e-4


@pytest.mark.parametrize("payload,match", [
    (b"OggS" + b"\0" * 100, "non-RIFF"),
    (b"RIFF" + struct.pack("<I", 4) + b"WAVE", "data"),
])
def test_riff_decode_rejects_like_jax(payload, match):
    with pytest.raises(jbase.TTSError, match=match) as want:
        jaz._decode_riff(payload)
    with pytest.raises(tbase.TTSError, match=match) as got:
        taz._decode_riff(payload)
    assert str(got.value) == str(want.value)


# --- the SSML helpers -------------------------------------------------------


@pytest.mark.parametrize("doc", range(len(DOCUMENTS)))
def test_ssml_helpers_match_jax(doc):
    s = DOCUMENTS[doc]
    assert tbase.extract_text(s) == jbase.extract_text(s)
    assert tbase.extract_breaks_ms(s) == jbase.extract_breaks_ms(s)
    assert tbase.extract_prosody(s) == jbase.extract_prosody(s)
    assert tbase.simplify_ssml(s, "fr-FR-HenriNeural") == jbase.simplify_ssml(s, "fr-FR-HenriNeural")


def test_the_jax_suites_helper_cases():
    assert tbase.extract_text(SSML) == "bonjour le monde"
    assert tbase.extract_breaks_ms(SSML) == [300]
    assert tbase.extract_prosody(SSML) == (1.5, -2.0, 0.25)
    s = tbase.simplify_ssml(SSML, "fr-FR-HenriNeural")
    assert "<prosody" not in s and "bonjour le monde" in s and 'name="fr-FR-HenriNeural"' in s


# --- retries and the 400 fallback -------------------------------------------


def scripted(script, calls):
    """A ``_post`` that plays ``script``, its last step again once it runs
    out: an exception to raise, bytes or samples to answer with; the posted
    SSML is appended to ``calls``."""

    def post(ssml):
        calls.append(ssml)
        step = script[min(len(calls), len(script)) - 1]
        if isinstance(step, BaseException):
            raise step
        return step if isinstance(step, bytes) else riff_bytes(step)

    return post


def http_error(code: int):
    return urllib.error.HTTPError("http://127.0.0.1/", code, "status", {}, None)


SCRIPTS = {
    "400_then_simplified": ([http_error(400), np.zeros(100)], 1),
    "400_then_failure": ([http_error(400), http_error(500)], 3),
    "429_503_then_ok": ([http_error(429), http_error(503), np.full(50, 0.25)], 3),
    "500_exhausted": ([http_error(500)], 3),
    "401_at_once": ([http_error(401)], 3),
    "network_exhausted": ([ConnectionError("no network")], 2),
    "timeout_then_ok": ([TimeoutError("timed out"), np.full(20, -0.5)], 3),
    "malformed_then_ok": ([b"<html>busy</html>", np.full(20, 0.125)], 3),
}


@pytest.mark.parametrize("case", list(SCRIPTS))
def test_failure_handling_matches_jax(case, monkeypatch):
    """The same posts, back-off sleeps, result or error (message and code)
    as the JAX backend on the same scripted transport."""
    script, retries = SCRIPTS[case]
    outcomes = {}
    for name, mod, base in (("jax", jaz, jbase), ("torch", taz, tbase)):
        be = mod.AzureBackend("key", max_retries=retries)
        calls, sleeps = [], []
        monkeypatch.setattr(be, "_post", scripted(script, calls))
        monkeypatch.setattr("time.sleep", sleeps.append)
        try:
            a = be.synthesize(SSML)
            outcomes[name] = ("ok", a.rate, a.samples.tobytes(), calls, sleeps)
        except base.TTSError as e:
            outcomes[name] = ("error", str(e), e.code, calls, sleeps)
    assert outcomes["torch"] == outcomes["jax"]
    if case.startswith("400"):
        assert "<prosody" not in outcomes["torch"][3][1]


def test_the_jax_suites_retry_cases(monkeypatch):
    be = taz.AzureBackend("key", max_retries=1)
    calls = []
    monkeypatch.setattr(be, "_post", scripted([http_error(400), np.zeros(100)], calls))
    audio = be.synthesize(SSML)
    assert audio.rate == 44100 and len(calls) == 2 and "<prosody" not in calls[1]
    be = taz.AzureBackend("key", max_retries=2)
    monkeypatch.setattr(be, "_post", scripted([ConnectionError("no network")], []))
    monkeypatch.setattr("time.sleep", lambda s: None)
    with pytest.raises(tbase.TTSError, match="after retries"):
        be.synthesize("<speak/>")


# --- configuration ----------------------------------------------------------


def test_the_default_config_builds_a_pipeline(tmp_path, monkeypatch):
    """``tts_backend`` defaults to ``azure``: the port builds the Azure
    client with the default region and voice, and no key file. The JAX
    package's default does not build (its key lookup resolves the empty key
    file to ``base_dir`` and reads that directory)."""
    monkeypatch.delenv("AZURE_API_KEY", raising=False)
    cfg = TConfig.from_dict({}, tmp_path)
    assert cfg.tts_backend == "azure" and cfg.azure_key_file == "" and cfg.azure_region == "francecentral"
    pipe = TPipeline("v", cfg, device="cpu")
    assert isinstance(pipe.tts, taz.AzureBackend)
    assert (pipe.tts.api_key, pipe.tts.region, pipe.tts.voice) == ("", "francecentral", "fr-FR-HenriNeural")
    with pytest.raises(IsADirectoryError):
        JPipeline("v", JConfig.from_dict({}, tmp_path / "jax"))


@pytest.mark.parametrize("where", ["relative", "absolute", "env", "missing_file"])
def test_read_azure_key_matches_jax(tmp_path, monkeypatch, where):
    monkeypatch.setenv("AZURE_API_KEY", "from-env")
    (tmp_path / "keys").mkdir()
    (tmp_path / "keys" / "azure.txt").write_text("  secret-key\n", encoding="utf-8")
    key_file = {"relative": "keys/azure.txt", "absolute": str(tmp_path / "keys" / "azure.txt"),
                "env": "", "missing_file": "keys/none.txt"}[where]
    raw = {"azure_key_file": key_file, "azure_region": "westeurope"}
    t = TConfig.from_dict(raw, tmp_path)
    want = {"relative": "secret-key", "absolute": "secret-key", "env": "from-env", "missing_file": "from-env"}[where]
    assert t.read_azure_key() == want
    assert t.azure_region == "westeurope" and t.azure_key_file == key_file
    if key_file:  # the JAX lookup reads base_dir itself for an empty key file
        assert JConfig.from_dict(raw, tmp_path).read_azure_key() == want


# --- the pipeline against a loopback server --------------------------------


class Stub:
    """A loopback Azure endpoint: each POST is answered with the RIFF of the
    fake TTS for its SSML; the requests are recorded."""

    def __init__(self):
        fake = FakeBackend(seed=1)
        self.requests = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"])).decode("utf-8")
                stub.requests.append((self.path, self.headers["X-Microsoft-OutputFormat"],
                                      self.headers["Content-Type"], self.headers["Ocp-Apim-Subscription-Key"], body))
                payload = riff_bytes(np.asarray(fake.synthesize(body).samples, np.float64))
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/cognitiveservices/v1"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


STEPS = ["Align+Transcribe", "Raw Synthesis", "Measure & Build SSML", "Synthesize+Merge",
         "Export JSON", "Final Transcribe", "Compare Breaks"]


def azure_voice(base: Path) -> dict:
    """Two synthetic segments with their TextGrids and raw transcripts, and
    the key file (the JAX package's lookup needs one)."""
    (base / "azure_key.txt").write_text("loopback-key\n", encoding="utf-8")
    root = base / "synth"
    seg_files, tg_dir, _ = synth_voice(root, seed=4, n_segments=2, seconds=(1.5, 2.5))
    voice_dir, _ = lay_out_voice(root, base / "Data" / "voice", "az")
    (voice_dir / "transcription_raw").mkdir()
    for p in seg_files:
        words = " ".join(iv.mark.strip() for iv in read_textgrid(tg_dir / f"{p.stem}.TextGrid").tiers[0] if iv.mark.strip())
        (voice_dir / "transcription_raw" / f"{p.stem}.txt").write_text(words, encoding="utf-8")
    return {"data_dir": "Data/voice", "out_dir": "Out", "voice_names": ["az"], "azure_voice_name": "fr-FR-DeniseNeural",
            "tts_backend": "azure", "aligner": "precomputed", "azure_region": "westeurope",
            "azure_key_file": "azure_key.txt", "steps_to_run": STEPS}


@pytest.fixture(scope="module")
def azure_runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    jdir, tdir = tmp_path_factory.mktemp("azure_jax"), tmp_path_factory.mktemp("azure_torch")
    try:
        mp.delenv("AZURE_API_KEY", raising=False)
        with Stub() as stub:
            for mod in (jaz, taz):
                mp.setattr(mod.AzureBackend, "_url", property(lambda self: stub.url))
            cfg = azure_voice(jdir)
            azure_voice(tdir)
            jpipe = JPipeline("az", JConfig.from_dict(cfg, jdir))
            jpipe.run()
            jreq = list(stub.requests)
            stub.requests.clear()
            tpipe = TPipeline("az", TConfig.from_dict(cfg, tdir), device="cpu")
            tpipe.run()
            treq = list(stub.requests)
    finally:
        mp.undo()
    return jdir, tdir, jpipe, tpipe, jreq, treq


def test_both_pipelines_post_the_same_requests(azure_runs):
    _, _, jpipe, tpipe, jreq, treq = azure_runs
    assert isinstance(tpipe.tts, taz.AzureBackend) and isinstance(jpipe.tts, jaz.AzureBackend)
    assert len(treq) > 4 and treq == jreq
    for path, fmt, ctype, key, body in treq:
        assert path == "/cognitiveservices/v1" and fmt == "riff-44100hz-16bit-mono-pcm"
        assert ctype == "application/ssml+xml" and key == "loopback-key" and body.startswith("<speak")


def test_azure_pipeline_artifacts_byte_equal_to_jax(azure_runs):
    jdir, tdir, _, _, _, _ = azure_runs
    files = lambda d: {p.relative_to(d) for p in (d / "Data").rglob("*") if p.is_file()} | {  # noqa: E731
        p.relative_to(d) for p in (d / "Out").rglob("*") if p.is_file() and p.name != "step_timings.jsonl"}
    assert files(jdir) == files(tdir)
    assert any(p.suffix == ".wav" and "_ssml" in str(p) for p in files(tdir))
    differ = [str(p) for p in sorted(files(tdir)) if (tdir / p).read_bytes() != (jdir / p).read_bytes()]
    assert not differ, differ
