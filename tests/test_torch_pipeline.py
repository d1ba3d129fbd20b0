"""The PyTorch port's eight-step voice pipeline against the JAX package's.

Both ``AudioPipeline``s run once per module on the voice of
``tests/test_pipeline_e2e.py`` (two segments voiced by the fake TTS with
seed 7, the pipeline's TTS the fake with seed 1, precomputed TextGrids),
steps Align+Transcribe through Compare Breaks, each in a directory of its
own; the port with ``device="cpu"``. Every artifact is held byte-equal, the
wavs sample for sample. A brute recording then goes through Preprocess and
the energy aligner on both sides: equal split ranges, segments and
TextGrids.
"""

import csv
import json
import logging
import shutil
from pathlib import Path

import numpy as np
import pytest
import yaml

import jax.numpy as jnp

from prosody_control_french_tts_tpu.core.config import PipelineConfig as JConfig
from prosody_control_french_tts_tpu.core.pipeline import AudioPipeline as JPipeline
from prosody_control_french_tts_tpu.ops import energy as jenergy
from prosody_control_french_tts_tpu.tts.fake import FakeBackend as JFake
from prosody_control_french_tts_tpu.utils import wavio as jwav
from prosody_control_french_tts_tpu.utils.textgridio import word_tier_with_silences, write_textgrid
from prosody_control_french_tts_tpu_torch.core import config as tconfig
from prosody_control_french_tts_tpu_torch.core import pipeline as tpipeline
from prosody_control_french_tts_tpu_torch.core.config import PipelineConfig as TConfig
from prosody_control_french_tts_tpu_torch.core.pipeline import AudioPipeline as TPipeline
from prosody_control_french_tts_tpu_torch.prosody.measure import segment_sort_key
from prosody_control_french_tts_tpu_torch.tts.fake import FakeBackend as TFake
from prosody_control_french_tts_tpu_torch.utils import wavio as twav

SR = 44100
NAME = "testvoice"
SEGMENTS = {
    "segment_ph1": [
        ("bonjour", 0), ("tout", 0), ("le", 0), ("monde.", 400),
        ("nous", 0), ("parlons", 0), ("ensemble", 250), ("aujourd'hui.", 0),
    ],
    "segment_ph2": [
        ("la", 0), ("voix", 0), ("naturelle", 300), ("change", 0),
        ("beaucoup.", 500), ("merci", 0), ("beaucoup.", 0),
    ],
}
STEPS = ["Align+Transcribe", "Raw Synthesis", "Measure & Build SSML", "Synthesize+Merge",
         "Export JSON", "Final Transcribe", "Compare Breaks"]
CONFIG = {
    "data_dir": "Data/voice",
    "out_dir": "Out",
    "voice_names": [NAME],
    "azure_voice_name": "fr-FR-HenriNeural",
    "silence": {"min_silence_len": 1000, "silence_thresh": -50, "keep_silence": 300},
    "prosody_settings": {
        "baseline_window": 10, "pitch_semitones": 1.3, "volume_pct": 10.0, "rate_percent": 10.0,
        "smoothing_alpha": 0.2, "max_jump_percent": 8, "end_punctuation_pause_ms": 500,
        "inter_syntagme_pause_factor": 1,
    },
    "tts_backend": "fake",
    "aligner": "precomputed",
    "steps_to_run": STEPS,
}
RESULTS = Path("Out") / "results" / NAME
TEXT_ARTIFACTS = [
    "BDD_ssml.csv", "BDD_syntagme_ssml.csv", "BDD_syntagme_for_synth.csv", f"training_data_{NAME}.json",
    "OUT.TextGrid", "transcription_final.txt", "pause_comparison_full.csv", "used_config.yaml",
]


def synth_segment(words_pauses, backend):
    """'Natural' audio word by word (tests/test_pipeline_e2e.py), with the
    exact word timings."""
    chunks, times = [], []
    cursor = 0.0
    for word, pause_ms in words_pauses:
        a = backend._voice(word, pitch_pct=5.0, rate_pct=0.0, volume_pct=0.0)
        t0 = cursor
        cursor += len(a) / SR
        times.append((t0, cursor, word))
        chunks.append(a)
        if pause_ms:
            chunks.append(np.zeros(int(pause_ms * SR / 1000)))
            cursor += pause_ms / 1000.0
    return np.concatenate(chunks), times


def build_voice(base: Path) -> None:
    vdir = base / "Data" / "voice" / NAME
    (vdir / "audio").mkdir(parents=True)
    (vdir / "transcription_raw").mkdir(parents=True)
    tg_dir = vdir / "WhisperTS_textgrid_files"
    tg_dir.mkdir(parents=True)
    gen = JFake(seed=7)
    for seg, wp in SEGMENTS.items():
        x, times = synth_segment(wp, gen)
        jwav.write_wav(vdir / "audio" / f"{seg}.wav", x, SR)
        write_textgrid(word_tier_with_silences(times, total_duration=len(x) / SR), tg_dir / f"{seg}.TextGrid")
        (vdir / "transcription_raw" / f"{seg}.txt").write_text(" ".join(w for w, _ in wp), encoding="utf-8")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX base, port base, port pipeline, port step timer)."""
    jbase, tbase = tmp_path_factory.mktemp("jax_voice"), tmp_path_factory.mktemp("torch_voice")
    build_voice(jbase)
    build_voice(tbase)
    JPipeline(NAME, JConfig.from_dict(CONFIG, jbase), tts=JFake(seed=1)).run()
    pipe = TPipeline(NAME, TConfig.from_dict(CONFIG, tbase), tts=TFake(seed=1), device="cpu")
    timer = pipe.run()
    return jbase, tbase, pipe, timer


def _files(base: Path) -> set:
    return {p.relative_to(base) for p in base.rglob("*") if p.is_file()}


def test_same_artifacts(runs):
    jbase, tbase, _, _ = runs
    assert _files(jbase) == _files(tbase)


@pytest.mark.parametrize("name", TEXT_ARTIFACTS)
def test_artifact_byte_equal(runs, name):
    jbase, tbase, _, _ = runs
    assert (tbase / RESULTS / name).read_bytes() == (jbase / RESULTS / name).read_bytes()


@pytest.mark.parametrize("where", [
    "Data/voice/testvoice_ssml/xml_files", "Data/voice/testvoice/transcription",
    "Data/voice/testvoice/transcription_raw", "Data/voice/testvoice_raw/transcription", "Out/results",
])
def test_directory_byte_equal(runs, where):
    """Every xml file, transcript and bdd.json, byte for byte."""
    jbase, tbase, _, _ = runs
    files = sorted(p for p in (jbase / where).iterdir() if p.is_file())
    assert files
    for p in files:
        assert (tbase / where / p.name).read_bytes() == p.read_bytes(), p.name


@pytest.mark.parametrize("where", [
    "Out/results/testvoice", "Out/results/testvoice/segmented_audio",
    "Data/voice/testvoice_raw/audio", "Data/voice/testvoice_ssml/audio",
])
def test_wav_samples_equal(runs, where):
    """OUT.wav, the per-segment stitched wavs, the raw and SSML syntheses:
    equal samples at equal rates."""
    jbase, tbase, _, _ = runs
    wavs = sorted((jbase / where).glob("*.wav"))
    assert wavs
    for p in wavs:
        a, b = jwav.read_wav(p), twav.read_wav(tbase / where / p.name)
        assert a.rate == b.rate
        assert np.array_equal(a.samples, b.samples), p.name


def test_measure_rows_and_breaks(runs):
    _, tbase, pipe, _ = runs
    rows = pipe.last_measure.rows
    assert len(rows) >= 6 and all(np.isfinite([r.pitch_smooth, r.rate_smooth, r.raw_volume]).all() for r in rows)
    assert pipe.last_breaks.total >= 1
    with open(tbase / RESULTS / "pause_comparison_full.csv", newline="", encoding="utf-8") as f:
        assert len(list(csv.DictReader(f))) == pipe.last_breaks.total


def test_step_timings(runs):
    _, tbase, _, timer = runs
    recs = [json.loads(line) for line in (tbase / RESULTS / "step_timings.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == STEPS
    assert all(r["error"] is None and r["seconds"] >= 0 and r["voice"] == NAME for r in recs)
    assert timer.total_seconds() == pytest.approx(sum(r["seconds"] for r in recs))


def test_used_config_is_yaml_dump(runs):
    _, tbase, pipe, _ = runs
    text = (tbase / RESULTS / "used_config.yaml").read_text(encoding="utf-8")
    assert text == yaml.dump(pipe.cfg.raw, default_flow_style=False, allow_unicode=True)
    assert yaml.safe_load(text) == CONFIG


# ---------------------------------------------------------------------------
# a brute recording through Preprocess and the energy aligner
# ---------------------------------------------------------------------------

BRUTE_WORDS = [[("salut", 0), ("les", 0), ("amis.", 0)], [("quelle", 0), ("belle", 0), ("journée.", 0)]]
BRUTE_TEXTS = ["salut les amis.", "quelle belle journée."]


def _brute(base: Path, name: str) -> None:
    vdir = base / "Data" / "voice" / name
    (vdir / "brute").mkdir(parents=True)
    gen = JFake(seed=3)
    seg1, _ = synth_segment(BRUTE_WORDS[0], gen)
    seg2, _ = synth_segment(BRUTE_WORDS[1], gen)
    brute = np.concatenate([seg1, np.zeros(int(1.5 * SR)), seg2])
    jwav.write_wav(vdir / "brute" / "segment.wav", brute, SR)


@pytest.fixture(scope="module")
def brute_runs(tmp_path_factory):
    name = "v2"
    cfg = {
        "data_dir": "Data/voice", "out_dir": "Out", "voice_names": [name], "tts_backend": "fake",
        "aligner": "energy", "silence": {"min_silence_len": 1000, "silence_thresh": -50, "keep_silence": 300},
    }
    out = []
    for kind in ("jax", "torch"):
        base = tmp_path_factory.mktemp(f"brute_{kind}")
        _brute(base, name)
        if kind == "jax":
            pipe = JPipeline(name, JConfig.from_dict(cfg, base), tts=JFake(seed=1))
        else:
            pipe = TPipeline(name, TConfig.from_dict(cfg, base), tts=TFake(seed=1), device="cpu")
        pipe.preprocess()
        vdir = base / "Data" / "voice" / name
        (vdir / "transcription_raw").mkdir(exist_ok=True)
        for seg, txt in zip(sorted((vdir / "audio").glob("*.wav")), BRUTE_TEXTS):
            (vdir / "transcription_raw" / f"{seg.stem}.txt").write_text(txt, encoding="utf-8")
        pipe.align_and_transcribe()
        out.append((base, vdir, pipe))
    return out


def test_brute_split_equals_both_jax_paths(brute_runs):
    (jbase, jvdir, _), (_, _, tpipe) = brute_runs
    a = jwav.read_wav(jvdir / "brute" / "segment.wav").to_mono()
    x = np.asarray(a.samples, np.float32)
    native = jenergy.split_on_silence_ranges(x, a.rate, 1000, -50, 300)
    device = jenergy.split_on_silence_ranges(jnp.asarray(x), a.rate, 1000, -50, 300)
    assert native == device
    assert tpipe.last_split == native
    assert len(native) == 2


@pytest.mark.parametrize("sub,pattern", [("audio", "*.wav"), ("WhisperTS_textgrid_files", "*.TextGrid"),
                                         ("transcription", "*.txt")])
def test_brute_segments_and_textgrids_equal(brute_runs, sub, pattern):
    (_, jvdir, _), (_, tvdir, _) = brute_runs
    files = sorted((jvdir / sub).glob(pattern))
    assert len(files) == 2
    assert sorted(p.name for p in (tvdir / sub).glob(pattern)) == [p.name for p in files]
    for p in files:
        assert (tvdir / sub / p.name).read_bytes() == p.read_bytes(), p.name


def test_brute_textgrid_words(brute_runs):
    from prosody_control_french_tts_tpu_torch.utils.textgridio import read_textgrid

    (_, _, _), (_, tvdir, _) = brute_runs
    for tg in sorted((tvdir / "WhisperTS_textgrid_files").glob("*.TextGrid")):
        assert sum(1 for iv in read_textgrid(tg).tiers[0] if iv.mark.strip()) == 3


# ---------------------------------------------------------------------------
# configuration, command line, the denoisers, what the port refuses
# ---------------------------------------------------------------------------


def test_segment_sort_key_is_numeric():
    names = [Path(f"segment_ph{i}.wav") for i in (10, 2, 1, 11)] + [Path("other.wav")]
    assert [p.stem for p in sorted(names, key=segment_sort_key)] == [
        "segment_ph1", "segment_ph2", "segment_ph10", "segment_ph11", "other"]


def test_config_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PCFT_TEST_VOICE", "envvoice")
    raw = dict(CONFIG, voice_names="${PCFT_TEST_VOICE}", multiprocessing=1, ab_test=None)
    j, t = JConfig.from_dict(raw, tmp_path), TConfig.from_dict(raw, tmp_path)
    for f in ("data_dir", "out_dir", "voice_names", "azure_voice_name", "steps_to_run",
              "tts_backend", "aligner", "pos_backend", "raw", "data_path", "out_path",
              "azure_key_file", "azure_region"):
        assert getattr(t, f) == getattr(j, f), f
    # keys of unported parts live only in raw, as the reference reads them
    assert t.raw["multiprocessing"] == j.multiprocessing and t.raw["ab_test"] is None
    assert t.multiprocessing is j.multiprocessing is True
    assert vars(t.silence) == vars(j.silence)
    assert vars(t.prosody) == vars(j.prosody)
    assert t.voice_names == ["envvoice"]


def test_load_config_and_main(tmp_path):
    """``main(--config)`` on the brute voice, every step, on the CPU."""
    name = "cli"
    _brute(tmp_path, name)
    cfg = {"voice_names": [name], "tts_backend": "fake", "aligner": "energy",
           "steps_to_run": ["Preprocess"]}
    (tmp_path / "config.yaml").write_text(yaml.dump(cfg), encoding="utf-8")
    loaded = tconfig.load_config(tmp_path / "config.yaml")
    assert loaded.base_dir == tmp_path and loaded.voice_names == [name]
    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    try:
        tpipeline.main(["--config", str(tmp_path / "config.yaml"), "--device", "cpu"])
    finally:
        for h in root.handlers:
            h.close()
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])
    assert len(list((tmp_path / "Data" / "voice" / name / "audio").glob("*.wav"))) == 2
    assert (tmp_path / "Out" / "logs" / "pipeline_debug.log").exists()
    with pytest.raises(FileNotFoundError):
        tconfig.load_config(tmp_path / "missing.yaml")


@pytest.mark.parametrize("raw,region,key", [
    pytest.param({"tts_backend": "azure", "azure_region": "westeurope"}, "westeurope", "k-env",
                 id="raw2-NotImplementedError-network"),
])
def test_pipeline_refuses_what_is_not_ported(tmp_path, monkeypatch, raw, region, key):
    """The port's pipeline refuses nothing the JAX one builds. The case kept
    its id from when ``tts_backend: azure`` raised NotImplementedError (the
    Azure client needs the network): it now builds the Azure REST client
    with the config's region and voice and the key from ``AZURE_API_KEY``,
    and makes no network call while doing so."""
    from prosody_control_french_tts_tpu_torch.tts.azure import AzureBackend

    def no_network(*args, **kwargs):
        raise AssertionError("the pipeline's construction reached the network")

    monkeypatch.setattr("urllib.request.urlopen", no_network)
    monkeypatch.setenv("AZURE_API_KEY", key)
    cfg = TConfig.from_dict(dict({"tts_backend": "fake"}, **raw), tmp_path)
    pipe = TPipeline("v", cfg, device="cpu")
    assert isinstance(pipe.tts, AzureBackend)
    assert (pipe.tts.region, pipe.tts.voice, pipe.tts.api_key) == (region, cfg.azure_voice_name, key)


DENOISE_CFG = {"data_dir": "Data/voice", "out_dir": "Out", "voice_names": ["dn"], "tts_backend": "fake",
               "aligner": "energy", "silence": {"min_silence_len": 1000, "silence_thresh": -50, "keep_silence": 300}}


@pytest.mark.parametrize("denoise", ["spectral", "mask"])
def test_preprocess_denoiser_matches_jax(tmp_path, denoise):
    """Preprocess with ``denoise: spectral`` or ``mask`` on the CPU: the
    same split ranges as the JAX pipeline's, and a denoised recording
    within the denoisers' own bounds of the JAX one (spectral: 1e-5 of the
    peak before the 16-bit write, so within 2 LSB after it; mask: SI-SNR
    of 30 dB, tests/test_torch_separate.py)."""
    from prosody_control_french_tts_tpu.audio.separate import si_snr_db

    cfg = dict(DENOISE_CFG, denoise=denoise)
    pipes = []
    for kind in ("jax", "torch"):
        base = tmp_path / kind
        _brute(base, "dn")
        if kind == "jax":
            pipe = JPipeline("dn", JConfig.from_dict(cfg, base), tts=JFake(seed=1))
        else:
            pipe = TPipeline("dn", TConfig.from_dict(cfg, base), tts=TFake(seed=1), device="cpu")
        pipe.preprocess()
        pipes.append(pipe)
    jp, tp = pipes
    a = jwav.read_wav(jp.voice_dir / "brute" / "segment_denoised.wav").to_mono()
    b = twav.read_wav(tp.voice_dir / "brute" / "segment_denoised.wav")
    # the JAX pipeline keeps no ranges: its split of its own denoised file
    assert tp.last_split == jenergy.split_on_silence_ranges(np.asarray(a.samples, np.float32), a.rate, 1000, -50, 300)
    assert len(tp.last_split) == 2
    for seg in ("segment_ph1.wav", "segment_ph2.wav"):
        assert jwav.read_wav(jp.voice_dir / "audio" / seg).samples.shape == twav.read_wav(tp.voice_dir / "audio" / seg).samples.shape
    assert a.rate == b.rate and a.samples.shape == b.samples.shape
    x, y = np.asarray(a.samples, np.float32), np.asarray(b.samples, np.float32)
    assert not np.array_equal(y, np.asarray(twav.read_wav(tp.voice_dir / "brute" / "segment.wav").samples, np.float32))
    if denoise == "spectral":
        assert np.max(np.abs(x - y)) <= 2.0 / 32768
    else:
        assert si_snr_db(y, x) >= 30.0
    assert sorted(p.name for p in (tp.voice_dir / "audio").glob("*.wav")) == ["segment_ph1.wav", "segment_ph2.wav"]


@pytest.mark.parametrize("denoise", ["spectral", "mask"])
def test_failing_denoiser_raises(tmp_path, monkeypatch, denoise):
    """A denoiser that fails fails the step: the original is not copied in
    its place (the JAX package copies it)."""
    _brute(tmp_path, "dn")
    cfg = dict(DENOISE_CFG, denoise=denoise)
    if denoise == "mask":
        cfg["denoise_options"] = {"weights_path": str(tmp_path / "missing.npz")}
    else:
        def broken(*a, **k):
            raise RuntimeError("denoiser broke")

        monkeypatch.setattr(tpipeline, "spectral_denoise", broken)
    pipe = TPipeline("dn", TConfig.from_dict(cfg, tmp_path), tts=TFake(seed=1), device="cpu")
    with pytest.raises((RuntimeError, FileNotFoundError)):
        pipe.preprocess()
    assert not (pipe.voice_dir / "brute" / "segment_denoised.wav").exists()


@pytest.mark.parametrize("value", [
    "python denoise.py --input {input} --output {output} --model htdemucs_ft --shifts 4",
    "first line\nsecond line",
])
def test_unwritable_config_refused_before_any_step(tmp_path, value):
    """A config that used_config.yaml cannot be written from is refused when
    the pipeline is built, not after the steps have run."""
    cfg = TConfig.from_dict({"tts_backend": "fake", "denoise_note": value}, tmp_path)
    with pytest.raises(ValueError, match="yaml_emit"):
        TPipeline("v", cfg, device="cpu")
    assert not (tmp_path / "Out").exists()


@pytest.mark.parametrize("aligner", ["ctc", "whisper", "whisper_jax"])
def test_acoustic_aligners_refused(tmp_path, aligner):
    """The acoustic aligners are ported: without a card they are refused
    unless the CPU is asked for, and the pipeline hands them its device, so
    a CPU pipeline aligns every segment with them."""
    import torch

    from prosody_control_french_tts_tpu_torch.align.base import get_aligner
    from prosody_control_french_tts_tpu_torch.utils.textgridio import read_textgrid as tread_textgrid

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            get_aligner(aligner)
    base = tmp_path / aligner
    shutil.rmtree(base, ignore_errors=True)
    build_voice(base)
    pipe = TPipeline(NAME, TConfig.from_dict(dict(CONFIG, aligner=aligner), base), device="cpu")
    pipe.align_and_transcribe()
    for seg, words in SEGMENTS.items():
        tg = tread_textgrid(pipe.textgrid_dir / f"{seg}.TextGrid")
        marks = [iv.mark for iv in tg.tiers[0] if iv.mark.strip()]
        assert marks
        if aligner == "ctc":  # forced with the raw transcript: its words
            assert marks == [w for w, _ in words]
