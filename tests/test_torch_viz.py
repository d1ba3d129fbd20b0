"""The port's plot-data viewer (``viz/``) against the JAX package's on the
CPU: the plot JSON of a synthetic voice (spectrogram dB within 0.1, F0
within 1 % where both sides call a frame voiced, the waveform and the word
intervals equal), the HTTP routes over a real socket, the preload pool,
and the comparison PNG where matplotlib is installed."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from prosody_control_french_tts_tpu.viz import plotdata as jplot
from prosody_control_french_tts_tpu_torch.viz import plotdata as tplot
from prosody_control_french_tts_tpu_torch.viz.server import VizService, serve
from prosody_control_french_tts_tpu_torch.utils.synth import lay_out_voice, synth_voice


@pytest.fixture(scope="module")
def voice(tmp_path_factory):
    base = tmp_path_factory.mktemp("viz")
    synth_voice(base / "synth", seed=5, n_segments=3, seconds=(1.5, 2.5))
    return lay_out_voice(base / "synth", base / "Data" / "voice", "v")


def _tg(d, seg):
    return d / "WhisperTS_textgrid_files" / f"{seg}.TextGrid"


@pytest.mark.parametrize("seg,side", [("segment_ph1", 0), ("segment_ph2", 1)])
def test_plot_data_matches_jax(voice, seg, side):
    d = voice[side]
    want = jplot.compute_plot_data(d / "audio" / f"{seg}.wav", _tg(d, seg))
    got = tplot.compute_plot_data(d / "audio" / f"{seg}.wav", _tg(d, seg), device="cpu")
    assert json.loads(json.dumps(got)) == got  # JSON-safe as it stands
    for key in ("sample_rate", "duration", "waveform", "intervals"):
        assert got[key] == want[key], key
    assert len(got["intervals"]) >= 3
    gs, ws = got["spectrogram"], want["spectrogram"]
    assert (gs["t_step"], gs["f_step"]) == (ws["t_step"], ws["f_step"])
    a, b = np.asarray(gs["db"]), np.asarray(ws["db"])
    assert a.shape == b.shape and np.abs(a - b).max() <= 0.1 + 1e-9
    assert got["f0"]["t"] == want["f0"]["t"]
    ft = np.array([np.nan if v is None else v for v in got["f0"]["hz"]])
    fj = np.array([np.nan if v is None else v for v in want["f0"]["hz"]])
    both = np.isfinite(ft) & np.isfinite(fj)
    assert both.sum() > 20 and (np.isfinite(ft) == np.isfinite(fj)).mean() >= 0.99
    assert np.abs(ft[both] / fj[both] - 1).max() <= 0.01


def test_downsample_equals_jax():
    x = np.arange(10_001, dtype=np.float32)
    for n in (4000, 20_000, 7):
        np.testing.assert_array_equal(tplot.downsample(x, n), jplot.downsample(x, n))


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(port, path, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_routes_over_a_socket(voice, tmp_path):
    nat, raw = voice
    log_path = tmp_path / "ab" / "responses.jsonl"
    svc = VizService({"natural": nat / "audio", "synthetic": raw / "audio"},
                     {"natural": nat / "WhisperTS_textgrid_files"}, ab_log_path=log_path, device="cpu")
    httpd = serve(svc, port=0, preload=False)
    port = httpd.server_address[1]
    try:
        assert json.loads(_get(port, "/segments")[2]) == ["segment_ph1", "segment_ph2", "segment_ph3"]
        assert json.loads(_get(port, "/kinds")[2]) == ["natural", "synthetic"]
        status, ctype, wav = _get(port, "/audio/synthetic/segment_ph2")
        assert status == 200 and ctype == "audio/wav" and wav == (raw / "audio" / "segment_ph2.wav").read_bytes()
        pd = json.loads(_get(port, "/plot_data/natural/segment_ph1")[2])
        assert pd == tplot.compute_plot_data(nat / "audio" / "segment_ph1.wav", _tg(nat, "segment_ph1"), device="cpu")
        assert pd["intervals"]
        assert json.loads(_get(port, "/plot_data/synthetic/segment_ph1")[2])["intervals"] == []
        for page, marker in (("/", b"<title>prosody viewer</title>"), ("/abtest", b"AB listening test")):
            status, ctype, body = _get(port, page)
            assert status == 200 and ctype.startswith("text/html") and marker in body
        for missing in ("/audio/natural/nothing", "/plot_data/other/segment_ph1", "/elsewhere"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(port, missing)
            assert e.value.code == 404
        rec = {"segment": "segment_ph1", "order": ["raw", "improved"], "choice": 1, "chosen_kind": "improved"}
        assert _post(port, "/ab_response", json.dumps(rec).encode()) == (200, {"status": "ok"})
        assert _post(port, "/ab_response", b"{not json") == (400, {"error": "invalid JSON"})
        assert _post(port, "/elsewhere", b"{}")[0] == 404
        lines = log_path.read_text(encoding="utf-8").splitlines()
        assert len(lines) == 1
        logged = json.loads(lines[0])
        assert {k: logged[k] for k in rec} == rec and isinstance(logged["t"], float)
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_preload_pool_fills_the_cache_once(voice, monkeypatch):
    """Four threads preload every (kind, segment): each plot once, equal to
    a lone call."""
    nat, raw = voice
    from prosody_control_french_tts_tpu_torch.viz import server

    calls = []
    lock = threading.Lock()
    real = server.compute_plot_data

    def counting(*args, **kwargs):
        with lock:
            calls.append(args[0].name)
        return real(*args, **kwargs)

    monkeypatch.setattr(server, "compute_plot_data", counting)
    svc = VizService({"natural": nat / "audio", "synthetic": raw / "audio"}, device="cpu")
    svc.preload_all(workers=4)
    assert len(svc.cache) == 6 and len(calls) == 6
    assert svc.plot_data("synthetic", "segment_ph3") == real(raw / "audio" / "segment_ph3.wav", None, device="cpu")
    assert len(calls) == 6  # answered from the cache


def test_comparison_png(voice, tmp_path):
    pytest.importorskip("matplotlib")
    from prosody_control_french_tts_tpu_torch.viz.acoustic import plot_comparison

    nat, raw = voice
    p = plot_comparison(nat / "audio" / "segment_ph1.wav", raw / "audio" / "segment_ph1.wav", tmp_path / "png" / "cmp.png",
                        natural_tg=_tg(nat, "segment_ph1"), synth_tg=_tg(raw, "segment_ph1"), device="cpu")
    assert p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and p.stat().st_size > 10_000
