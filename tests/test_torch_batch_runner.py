"""The PyTorch port's multi-voice path (``prosody/measure.py:
measure_voices_batched``, ``core/batch_runner.py``, ``main()`` with
``multiprocessing: true``) against the JAX package's, on the CPU.

Tolerances: the batched pass against the JAX package's batched pass at the
measure slice's bounds (tests/test_torch_measure.py: raw_rate 1e-5, the
other percentages 0.05 points, segment F0 medians 1e-3 relative, LUFS 0.01
dB); the batched pass against the port's own per-voice pass within 1e-3 on
raw_pitch, raw_volume, raw_rate and pitch_smooth with equal syntagmes (the
JAX package's tests/test_batch_runner.py bound); ``run_all_voices`` over
brute recordings (identity denoise, energy aligner, fake TTS) byte-equal to
the JAX package's, every file, the wavs sample for sample.
"""

import logging
from pathlib import Path

import numpy as np
import pytest
import yaml

from prosody_control_french_tts_tpu.core.batch_runner import run_all_voices as j_run_all_voices
from prosody_control_french_tts_tpu.core.config import PipelineConfig as JConfig
from prosody_control_french_tts_tpu.prosody import adjust as ja, measure as jm
from prosody_control_french_tts_tpu.tts.fake import FakeBackend as JFake
from prosody_control_french_tts_tpu.utils import wavio as jwav
from prosody_control_french_tts_tpu_torch.core import batch_runner as tbr
from prosody_control_french_tts_tpu_torch.core import pipeline as tpipeline
from prosody_control_french_tts_tpu_torch.core.config import PipelineConfig as TConfig
from prosody_control_french_tts_tpu_torch.ops import candidates, viterbi
from prosody_control_french_tts_tpu_torch.prosody import adjust as ta, measure as tm
from prosody_control_french_tts_tpu_torch.tts.fake import FakeBackend as TFake
from prosody_control_french_tts_tpu_torch.utils import wavio as twav
from prosody_control_french_tts_tpu_torch.utils.synth import synth_voice

# name -> (seed, segments, seconds, rate): "a" and "a2" share a length
# bucket (and differ in syntagme count), "b" lies in a longer bucket, "c" at
# another rate: three groups
VOICES = {"a": (0, 2, (1.0, 2.0), 44100), "a2": (5, 3, (1.0, 2.0), 44100), "b": (2, 2, (3.0, 4.0), 44100),
          "c": (3, 2, (1.0, 2.0), 22050)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    out = {}
    for name, (seed, n, seconds, rate) in VOICES.items():
        seg_files, tg_dir, raw_dir = synth_voice(root / name, seed=seed, n_segments=n, seconds=seconds, rate=rate)
        out[name] = (seg_files, tg_dir, raw_dir)
    return out


@pytest.fixture(scope="module")
def batched(corpus):
    """(port batched, JAX batched, port preps) — the port's kernel counts
    of the batched pass as well."""
    ts, js = ta.ProsodySettings(), ja.ProsodySettings()
    preps = {n: tm.prepare_voice(*args, ts) for n, args in corpus.items()}
    assert len({(p.nat.shape[1], p.rate) for p in preps.values()}) == 3
    candidates.launches = viterbi.launches = 0
    calls = tm.run_measure_device_calls
    got = tm.measure_voices_batched(preps, ts, device="cpu")
    assert tm.run_measure_device_calls == calls  # the per-voice pass never ran
    want = jm.measure_voices_batched({n: jm.prepare_voice(*args, js) for n, args in corpus.items()}, js)
    return got, want, preps


@pytest.mark.parametrize("name", list(VOICES))
def test_batched_matches_jax_batched(batched, name):
    got, want, _ = batched
    g, w = got[name], want[name]
    assert len(g.rows) == len(w.rows) > 0
    for rt, rj in zip(g.rows, w.rows):
        assert (rt.segment, rt.syntagme, rt.pause) == (rj.segment, rj.syntagme, rj.pause)
        assert abs(rt.raw_rate - rj.raw_rate) <= 1e-5
        for f in ("raw_pitch", "raw_volume", "pitch_smooth", "rate_smooth"):
            assert abs(getattr(rt, f) - getattr(rj, f)) <= 0.05, f
    for st, sj in zip(g.seg_stats, w.seg_stats):
        assert abs(st.p_nat - sj.p_nat) <= 1e-3 * sj.p_nat
        assert abs(st.l_nat - sj.l_nat) <= 0.01 and abs(st.l_syn - sj.l_syn) <= 0.01


@pytest.mark.parametrize("name", list(VOICES))
def test_batched_matches_per_voice(batched, corpus, name):
    got, _, _ = batched
    single = tm.measure_voice(*corpus[name], ta.ProsodySettings(), device="cpu")
    assert len(got[name].rows) == len(single.rows)
    for rb, rs in zip(got[name].rows, single.rows):
        assert rb.syntagme == rs.syntagme
        for f in ("raw_pitch", "raw_volume", "raw_rate", "pitch_smooth"):
            assert abs(getattr(rb, f) - getattr(rs, f)) < 1e-3, f


def test_batched_groups_and_packing(batched):
    """One group per (padded T, rate); a group's windows pad to its largest
    syntagme count and slice back per voice."""
    _, _, preps = batched
    groups = {}
    for n, p in preps.items():
        groups.setdefault((p.nat.shape[1], p.rate), []).append(n)
    assert sorted(map(sorted, groups.values())) == [["a", "a2"], ["b"], ["c"]]
    g = tm._pack_group([(n, preps[n]) for n in ("a", "a2")], tm.resolve_device("cpu"))
    S = sum(preps[n].nat.shape[0] for n in ("a", "a2"))
    N = max(preps[n].win_nat.shape[1] for n in ("a", "a2"))
    assert tuple(g["nat"].shape) == (S, g["T"]) and tuple(g["win_nat"].shape) == (S, N, 2)
    assert tuple(g["mask"].shape) == (S, N) and int(g["mask"].sum()) == sum(int(preps[n].mask.sum()) for n in ("a", "a2"))
    packed = np.arange(2 * (3 * 4 + 3), dtype=np.float32).reshape(2, 15)
    parts = tm._unpack6(packed)
    assert [p.shape for p in parts] == [(2, 4), (2,), (2, 4), (2,), (2, 4), (2,)]
    import torch

    back = tm._pack6(tuple(torch.from_numpy(np.ascontiguousarray(p)) for p in parts)).numpy()
    assert np.array_equal(back, packed)


# ---------------------------------------------------------------------------
# run_all_voices over brute recordings, against the JAX package's
# ---------------------------------------------------------------------------

SR = 44100
BRUTE = {"va": [["salut", "les", "amis."], ["quelle", "belle", "journée."]],
         "vb": [["la", "voix", "change", "beaucoup", "ce", "matin."], ["merci", "à", "tous."]]}
REST = ["Align+Transcribe", "Raw Synthesis", "Measure & Build SSML", "Synthesize+Merge", "Export JSON",
        "Final Transcribe", "Compare Breaks"]


def _write_brute(base: Path, name: str, groups, seed: int) -> None:
    gen = JFake(seed=seed)
    parts = []
    for words in groups:
        for w in words:
            parts.append(gen._voice(w, pitch_pct=5.0, rate_pct=0.0, volume_pct=0.0))
            parts.append(np.zeros(int(0.12 * SR)))
        parts.append(np.zeros(int(1.4 * SR)))
    brute = base / "Data" / "voice" / name / "brute"
    brute.mkdir(parents=True)
    jwav.write_wav(brute / "segment.wav", np.concatenate(parts[:-1]), SR)


def _config(voices, **extra):
    return dict({"data_dir": "Data/voice", "out_dir": "Out", "voice_names": list(voices), "tts_backend": "fake",
                 "aligner": "energy", "multiprocessing": True,
                 "silence": {"min_silence_len": 1000, "silence_thresh": -50, "keep_silence": 300}}, **extra)


def _transcripts(base: Path):
    for name, groups in BRUTE.items():
        vdir = base / "Data" / "voice" / name
        segs = sorted((vdir / "audio").glob("*.wav"), key=tm.segment_sort_key)
        assert len(segs) == len(groups), (name, segs)
        (vdir / "transcription_raw").mkdir(exist_ok=True)
        for seg, words in zip(segs, groups):
            (vdir / "transcription_raw" / f"{seg.stem}.txt").write_text(" ".join(words), encoding="utf-8")


@pytest.fixture(scope="module")
def all_voice_runs(tmp_path_factory):
    jbase, tbase = tmp_path_factory.mktemp("mv_jax"), tmp_path_factory.mktemp("mv_torch")
    for base in (jbase, tbase):
        for i, (name, groups) in enumerate(BRUTE.items()):
            _write_brute(base, name, groups, seed=20 + i)
    for base, make, tts in ((jbase, JConfig, JFake(seed=2)), (tbase, TConfig, TFake(seed=2))):
        for steps in (["Preprocess"], REST):
            cfg = make.from_dict(_config(BRUTE, steps_to_run=steps), base)
            if make is JConfig:
                res = j_run_all_voices(cfg, tts=tts)
            else:
                res = tbr.run_all_voices(cfg, tts=tts, device="cpu")
            assert sorted(res) == [(True, n) for n in sorted(BRUTE)]
            if steps == ["Preprocess"]:
                _transcripts(base)
    return jbase, tbase


def test_run_all_voices_same_files(all_voice_runs):
    jbase, tbase = all_voice_runs
    files = {p.relative_to(jbase) for p in jbase.rglob("*") if p.is_file()}
    assert files == {p.relative_to(tbase) for p in tbase.rglob("*") if p.is_file()}
    for name in BRUTE:
        assert Path("Out/results", name, "BDD_syntagme_ssml.csv") in files
        assert Path("Out/results", name, "OUT.wav") in files


def test_run_all_voices_byte_equal(all_voice_runs):
    jbase, tbase = all_voice_runs
    n_wavs = 0
    for p in sorted(jbase.rglob("*")):
        if not p.is_file():
            continue
        q = tbase / p.relative_to(jbase)
        if p.suffix == ".wav":
            a, b = jwav.read_wav(p), twav.read_wav(q)
            assert a.rate == b.rate and np.array_equal(a.samples, b.samples), p.relative_to(jbase)
            n_wavs += 1
        else:
            assert q.read_bytes() == p.read_bytes(), p.relative_to(jbase)
    assert n_wavs >= 10


def test_run_all_voices_timer_and_no_per_voice_pass(tmp_path):
    """The step timer gets each voice's steps and one batched measure
    record; the per-voice device pass never runs."""
    for i, (name, groups) in enumerate(BRUTE.items()):
        _write_brute(tmp_path, name, groups, seed=20 + i)
    timer = tbr.StepTimer()
    cfg = TConfig.from_dict(_config(BRUTE, steps_to_run=["Preprocess"]), tmp_path)
    assert tbr.run_all_voices(cfg, tts=TFake(seed=2), device="cpu", timer=timer) == [(True, "va"), (True, "vb")]
    _transcripts(tmp_path)
    calls = tm.run_measure_device_calls
    cfg = TConfig.from_dict(_config(BRUTE, steps_to_run=REST), tmp_path)
    assert tbr.run_all_voices(cfg, tts=TFake(seed=2), device="cpu", timer=timer) == [(True, "va"), (True, "vb")]
    assert tm.run_measure_device_calls == calls
    steps = [(r["step"], r["voice"]) for r in timer.records]
    assert steps.count(("Measure & Build SSML", "*")) == 1
    assert ("Preprocess", "va") in steps and ("Compare Breaks", "vb") in steps
    assert all(r["error"] is None for r in timer.records)


def test_batched_failure_propagates(tmp_path, monkeypatch):
    """A failure of the batched pass raises out of run_all_voices: no voice
    is measured one by one instead."""
    for i, (name, groups) in enumerate(BRUTE.items()):
        _write_brute(tmp_path, name, groups, seed=20 + i)
    tbr.run_all_voices(TConfig.from_dict(_config(BRUTE, steps_to_run=["Preprocess"]), tmp_path), tts=TFake(seed=2),
                       device="cpu")
    _transcripts(tmp_path)

    def broken(*a, **k):
        raise RuntimeError("batched pass broke")

    monkeypatch.setattr(tm, "measure_nat", broken)
    calls = tm.run_measure_device_calls
    cfg = TConfig.from_dict(_config(BRUTE, steps_to_run=REST), tmp_path)
    with pytest.raises(RuntimeError, match="batched pass broke"):
        tbr.run_all_voices(cfg, tts=TFake(seed=2), device="cpu")
    assert tm.run_measure_device_calls == calls
    assert not (tmp_path / "Out" / "results" / "va" / "BDD_syntagme_ssml.csv").exists()


def test_host_step_failure_stays_with_its_voice(tmp_path):
    """A voice whose host steps fail is reported; the others run on."""
    _write_brute(tmp_path, "va", BRUTE["va"], seed=20)
    (tmp_path / "Data" / "voice" / "vb").mkdir(parents=True)  # no brute recording
    cfg = TConfig.from_dict(_config(BRUTE, steps_to_run=["Preprocess"]), tmp_path)
    res = tbr.run_all_voices(cfg, tts=TFake(seed=2), device="cpu")
    assert sorted(res) == [(False, "vb"), (True, "va")]


def test_main_with_multiprocessing(tmp_path, monkeypatch):
    """``main(--config)`` with multiprocessing: true and two voices goes
    through run_all_voices (one batched measure pass), on the CPU."""
    for i, (name, groups) in enumerate(BRUTE.items()):
        _write_brute(tmp_path, name, groups, seed=20 + i)
    seen = []
    real = tbr.run_all_voices

    def spy(cfg, **k):
        seen.append((list(cfg.voice_names), k.get("device")))
        return real(cfg, **k)

    monkeypatch.setattr(tbr, "run_all_voices", spy)
    (tmp_path / "config.yaml").write_text(yaml.dump(_config(BRUTE, steps_to_run=["Preprocess"])), encoding="utf-8")
    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    try:
        tpipeline.main(["--config", str(tmp_path / "config.yaml"), "--device", "cpu"])
    finally:
        for h in root.handlers:
            h.close()
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])
    assert seen == [(["va", "vb"], "cpu")]
    for name in BRUTE:
        assert len(list((tmp_path / "Data" / "voice" / name / "audio").glob("*.wav"))) == 2
