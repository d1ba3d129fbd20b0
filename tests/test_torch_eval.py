"""The PyTorch port's evaluation layer (``eval/*``) and the two alignment
host helpers (``align/needleman_wunsch.py``, ``align/levenshtein_merge.py``)
against the JAX package's on the same inputs, on the CPU.

Tolerances, and what was measured with them:
- host code copied from the JAX package (YIN, the agreement statistics,
  WER, break F1, the A/B pairs, the aligner harness, the dataset
  statistics, Needleman-Wunsch, the TextGrid merge): equal, the A/B wavs
  byte for byte;
- ``f0_rmse_dtw`` (YIN contours on the host, the DTW on the port's device
  code): 1e-5 (equal measured);
- ``f0_contour(method="boersma")`` and ``extract_features`` (kernels A and B
  on a card, their plain versions here): median F0 and mean pitch within
  1 %, the corpus golden's limit, loudness within 0.01 dB;
- ``evaluate_voice`` / ``evaluate_all`` on a JAX pipeline's output
  directory: equal reports, f0_rmse within 1e-5;
- ``segment_agreement`` on one 2.7 s clip: the words of every aligner
  equal, each boundary within 20 ms (a frame of the aligners, as the
  aligner tests hold them), and the agreement row's statistics within 40 ms
  and 0.05 (equal measured).
"""

import json

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the conftest keeps JAX on the CPU)

from prosody_control_french_tts_tpu.align.levenshtein_merge import merge_textgrids as jmerge_textgrids
from prosody_control_french_tts_tpu.align.needleman_wunsch import needleman_wunsch as jneedleman_wunsch
from prosody_control_french_tts_tpu.align import synth_speech as jsynth
from prosody_control_french_tts_tpu.align.base import get_aligner as jget_aligner
from prosody_control_french_tts_tpu.core.config import PipelineConfig as JConfig
from prosody_control_french_tts_tpu.core.pipeline import AudioPipeline as JPipeline
from prosody_control_french_tts_tpu.eval import abtest as jab
from prosody_control_french_tts_tpu.eval import aligner_harness as jharn
from prosody_control_french_tts_tpu.eval import corpus_compare as jcc
from prosody_control_french_tts_tpu.eval import dataset_stats as jds
from prosody_control_french_tts_tpu.eval import evaluate_voice as jev
from prosody_control_french_tts_tpu.eval import metrics as jmet
from prosody_control_french_tts_tpu.eval import real_audio_agreement as jraa
from prosody_control_french_tts_tpu.eval import yin as jyin
from prosody_control_french_tts_tpu.models.tokenizer import WordPieceTokenizer as JTokenizer
from prosody_control_french_tts_tpu.tts.fake import FakeBackend as JFake
from prosody_control_french_tts_tpu.utils import textgridio as jtg
from prosody_control_french_tts_tpu.utils import wavio as jwav
from prosody_control_french_tts_tpu_torch import align as talign
from prosody_control_french_tts_tpu_torch import eval as teval
from prosody_control_french_tts_tpu_torch.align.base import get_aligner as tget_aligner
from prosody_control_french_tts_tpu_torch.eval import abtest as tab
from prosody_control_french_tts_tpu_torch.eval import aligner_harness as tharn
from prosody_control_french_tts_tpu_torch.eval import corpus_compare as tcc
from prosody_control_french_tts_tpu_torch.eval import dataset_stats as tds
from prosody_control_french_tts_tpu_torch.eval import evaluate_voice as tev
from prosody_control_french_tts_tpu_torch.eval import metrics as tmet
from prosody_control_french_tts_tpu_torch.eval import real_audio_agreement as traa
from prosody_control_french_tts_tpu_torch.eval import yin as tyin
from prosody_control_french_tts_tpu_torch.models.tokenizer import WordPieceTokenizer as TTokenizer
from prosody_control_french_tts_tpu_torch.ops.pitch import PitchParams, praat_pitch
from prosody_control_french_tts_tpu_torch.utils import textgridio as ttg
from prosody_control_french_tts_tpu_torch.utils.wavio import Audio as TAudio

SR = 44100



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these ops are small, and with the suite's
    parallel workers a thread pool in each only contends for the cores
    (held-out tagging took 278 s that way, 1 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tone(f0: float, dur: float = 1.0, sr: int = SR, harmonics: int = 4) -> np.ndarray:
    t = np.arange(int(dur * sr)) / sr
    x = np.zeros_like(t, dtype=np.float32)
    for h in range(1, harmonics + 1):
        x += (0.5 / h) * np.sin(2 * np.pi * f0 * h * t).astype(np.float32)
    return x


def test_exports():
    assert talign.needleman_wunsch is not None and talign.merge_textgrids is not None
    assert {"compare_breaks", "BreakReport", "wer", "f0_rmse_dtw", "break_f1"} <= set(dir(teval))


# -- YIN: tests/test_yin.py's analytic cases on the port, equal to the JAX package ---------------


def _vibrato():
    t = np.arange(int(1.5 * SR)) / SR
    inst = 150.0 * (1 + 0.05 * np.sin(2 * np.pi * 5.0 * t))
    phase = 2 * np.pi * np.cumsum(inst, dtype=np.float64) / SR
    return np.sin(phase).astype(np.float32) + 0.3 * np.sin(2 * phase).astype(np.float32)


YIN_SIGNALS = {
    "tone80": lambda: _tone(80.0), "tone120": lambda: _tone(120.0), "tone220": lambda: _tone(220.0),
    "tone440": lambda: _tone(440.0), "vibrato": _vibrato,
    "noise": lambda: np.random.default_rng(0).standard_normal(SR).astype(np.float32),
    "silence": lambda: np.zeros(SR, np.float32),
    "missing_fundamental": lambda: sum((0.4 / h) * np.sin(2 * np.pi * 110.0 * h * np.arange(SR) / SR)
                                       for h in range(2, 6)).astype(np.float32),
}


@pytest.mark.parametrize("name", sorted(YIN_SIGNALS))
def test_yin_equal_and_analytic(name):
    x = YIN_SIGNALS[name]()
    f, times = tyin.yin_f0(x, SR)
    jf, jt = jyin.yin_f0(x, SR)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(times, jt)
    v = f > 0
    if name.startswith("tone"):
        assert v.mean() > 0.9 and np.median(1200 * np.abs(np.log2(f[v] / float(name[4:])))) < 10
    elif name == "vibrato":
        truth = 150.0 * (1 + 0.05 * np.sin(2 * np.pi * 5.0 * times[v]))
        assert v.mean() > 0.9 and np.median(1200 * np.abs(np.log2(f[v] / truth))) < 25
    elif name == "noise":
        assert v.mean() < 0.3
    elif name == "silence":
        assert v.mean() < 0.1
    else:
        assert v.mean() > 0.8 and 1200 * abs(np.log2(np.median(f[v]) / 110.0)) < 30
    assert np.array_equal(tyin.yin_track(x, SR), f)


@pytest.fixture(scope="module")
def speech():
    """A synthetic French sentence at 16 kHz and its gold word spans."""
    return jsynth.synth_sentence("la musique commence demain matin", seed=444_000)


def test_boersma_contour_and_cross_method_agreement(speech):
    """``f0_contour(method="boersma")`` (kernels A and B on a card) within the
    corpus golden's 1 % median F0 of the JAX package's, and the YIN/Boersma
    agreement statistics of both packages equal on their own tracks."""
    x, _ = speech
    got = tmet.f0_contour(x, 16000, method="boersma", device="cpu")
    want = jmet.f0_contour(x, 16000, method="boersma")
    assert got.shape == want.shape
    assert abs(np.median(got[got > 0]) / np.median(want[want > 0]) - 1) <= 0.01
    assert ((got > 0) == (want > 0)).mean() >= 0.98
    yf, yt = tyin.yin_f0(x, 16000)
    assert np.array_equal(tmet.f0_contour(x, 16000), yf)
    bt = praat_pitch(x, 16000, PitchParams(floor=60.0, ceiling=600.0), device="cpu").times
    s_got = tyin.cross_method_agreement(yf, yt, got, bt)
    assert s_got == jyin.cross_method_agreement(yf, yt, got, bt)
    assert s_got["frames"] > 0 and "median_abs_cents" in s_got


# -- WER, break F1, F0 RMSE -------------------------------------------------------------------


@pytest.mark.parametrize("ref,hyp", [
    ("le chat dort sur la maison", "le chat dort dans la maison"), ("", ""), ("", "un mot"),
    ("un deux trois", ""), ("a b c d e f", "f e d c b a"), ("L'Été, déjà !", "l ete deja"),
])
def test_wer_equal(ref, hyp):
    assert tmet.wer(ref, hyp) == jmet.wer(ref, hyp)
    assert tmet.normalize_asr_text(ref) == jmet.normalize_asr_text(ref)
    assert tmet.wer(tmet.normalize_asr_text(ref), tmet.normalize_asr_text(hyp)) == jmet.wer(
        jmet.normalize_asr_text(ref), jmet.normalize_asr_text(hyp))


def test_break_f1_equal():
    rng = np.random.default_rng(3)
    for _ in range(20):
        e = sorted(rng.integers(0, 5000, int(rng.integers(0, 12))).tolist())
        m = sorted(rng.integers(0, 5000, int(rng.integers(0, 12))).tolist())
        tol = int(rng.choice([50, 100, 250]))
        assert tmet.break_f1(e, m, tol) == jmet.break_f1(e, m, tol)


def test_f0_rmse_dtw(speech):
    x, _ = speech
    y = np.concatenate([np.zeros(800, np.float32), x[: -800] * 0.7])
    got = tmet.f0_rmse_dtw(x, y, 16000, device="cpu")
    want = jmet.f0_rmse_dtw(x, y, 16000)
    assert abs(got - want) <= 1e-5 and got > 0


# -- the per-voice driver on a JAX pipeline's output -------------------------------------------------

VOICE = {
    "segment_ph1": [("bonjour", 0), ("le", 0), ("monde.", 400), ("nous", 0), ("parlons", 250), ("ensemble.", 0)],
    "segment_ph2": [("la", 0), ("voix", 300), ("change", 0), ("beaucoup.", 500), ("merci.", 0)],
}


@pytest.fixture(scope="module")
def pipeline_out(tmp_path_factory):
    """A JAX pipeline's Out/ and Data/voice/ for one voice (precomputed
    TextGrids, the fake TTS), as evaluate_voice reads them."""
    base = tmp_path_factory.mktemp("eval_voice")
    vdir = base / "Data" / "voice" / "ev"
    for d in ("audio", "transcription_raw", "WhisperTS_textgrid_files"):
        (vdir / d).mkdir(parents=True)
    gen = JFake(seed=7)
    for seg, wp in VOICE.items():
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
        jtg.write_textgrid(jtg.word_tier_with_silences(times, total_duration=len(x) / SR),
                           vdir / "WhisperTS_textgrid_files" / f"{seg}.TextGrid")
        (vdir / "transcription_raw" / f"{seg}.txt").write_text(" ".join(w for w, _ in wp), encoding="utf-8")
    cfg = {"data_dir": "Data/voice", "out_dir": "Out", "voice_names": ["ev"], "tts_backend": "fake",
           "aligner": "precomputed", "silence": {"min_silence_len": 1000, "silence_thresh": -50, "keep_silence": 300},
           "steps_to_run": ["Align+Transcribe", "Raw Synthesis", "Measure & Build SSML", "Synthesize+Merge",
                            "Export JSON", "Final Transcribe", "Compare Breaks"]}
    JPipeline("ev", JConfig.from_dict(cfg, base), tts=JFake(seed=1)).run()
    return base


def test_evaluate_voice_equal(pipeline_out):
    base = pipeline_out
    got = tev.evaluate_voice(base / "Out" / "results" / "ev", base / "Data" / "voice" / "ev", device="cpu")
    want = jev.evaluate_voice(base / "Out" / "results" / "ev", base / "Data" / "voice" / "ev")
    assert set(got) == set(want) >= {"f0_rmse_log2", "break", "break_avg_abs_diff_ms", "wer"}
    assert abs(got.pop("f0_rmse_log2") - want.pop("f0_rmse_log2")) <= 1e-5
    assert got == want


def test_evaluate_all_records_a_failing_voice(pipeline_out, tmp_path):
    """As the JAX driver: a voice whose evaluation raises is recorded with
    "error" and the others are reported; the summary is written."""
    base = pipeline_out
    bad = base / "Out" / "results" / "zz_broken"
    bad.mkdir(exist_ok=True)
    (bad / "pause_comparison_full.csv").write_text("segment,nat_voice_ms\nx,not-a-number\n", encoding="utf-8")
    try:
        got = tev.evaluate_all(base / "Out", base / "Data" / "voice", tmp_path / "r.json", device="cpu")
        want = jev.evaluate_all(base / "Out", base / "Data" / "voice")
    finally:
        for p in bad.iterdir():
            p.unlink()
        bad.rmdir()
    assert "error" in got["voices"]["zz_broken"] and "error" not in got["voices"]["ev"]
    assert set(got["voices"]) == set(want["voices"])
    assert abs(got["mean_f0_rmse_log2"] - want["mean_f0_rmse_log2"]) <= 1e-5
    assert json.loads((tmp_path / "r.json").read_text())["voices"]["ev"]["wer"] == want["voices"]["ev"]["wer"]


# -- corpus features, dataset statistics, A/B pairs, the aligner harness --------------------------------


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Two corpora of three 1 s wavs each: harmonic tones at 200 / 240 Hz
    and their 1.5x ratios, at three levels."""
    base = tmp_path_factory.mktemp("corpora")
    for d, f in (("na", 200.0), ("sy", 240.0)):
        (base / d).mkdir()
        for i, (mul, amp) in enumerate(((1.0, 0.4), (1.5, 0.2), (0.8, 0.1))):
            jwav.write_wav(base / d / f"s{i}.wav", amp * _tone(f * mul, 1.0, 22050) / 1.04, 22050)
    return base


def test_extract_features_match_jax(corpora, tmp_path):
    got = tcc.extract_features(corpora / "na", cache=tmp_path / "c.npz", device="cpu")
    want = jcc.extract_features(corpora / "na")
    assert list(got["names"]) == list(want["names"]) and got["names"].size == 3
    np.testing.assert_allclose(got["pitch_mean"], want["pitch_mean"], rtol=0.01)
    np.testing.assert_allclose(got["loudness_dbfs"], want["loudness_dbfs"], atol=0.01)
    np.testing.assert_array_equal(got["duration_s"], want["duration_s"])
    np.testing.assert_allclose(got["pitch_mean"], [200.0, 300.0, 160.0], rtol=0.02)
    again = tcc.extract_features(corpora / "na", cache=tmp_path / "c.npz", device="cpu")  # the cache
    np.testing.assert_array_equal(again["pitch_mean"], got["pitch_mean"])


def test_compare_corpora_writes_its_plots(corpora, tmp_path):
    pytest.importorskip("matplotlib")
    fa = tcc.extract_features(corpora / "na", device="cpu")
    fb = tcc.extract_features(corpora / "sy", device="cpu")
    pngs = tcc.compare_corpora(fa, fb, tmp_path / "plots")
    assert [p.name for p in pngs] == ["compare_pitch_mean.png", "compare_loudness_dbfs.png",
                                      "compare_duration_s.png", "zscores_pitch.png"]
    assert all(p.stat().st_size > 1000 for p in pngs)


def test_analyze_dataset_equal(tmp_path):
    for v in ("a", "b"):
        for i in (1, 2):
            jwav.write_wav(tmp_path / f"{v}__segment_ph{i}.wav", np.zeros(22050 * i), 22050)
            (tmp_path / f"{v}__segment_ph{i}.txt").write_text(f"bonjour, le monde {v}. oui ! « {i} »",
                                                              encoding="utf-8")
    got, want = tds.analyze_dataset(tmp_path), jds.analyze_dataset(tmp_path)
    assert got == want and got["files"] == 4 and got["tokens"] > 0
    texts = ["bonjour le monde", "le chat dort"]
    assert tds.analyze_dataset(tmp_path, TTokenizer.train(texts, vocab_size=60, min_freq=1)) == \
        jds.analyze_dataset(tmp_path, JTokenizer.train(texts, vocab_size=60, min_freq=1))


@pytest.mark.parametrize("durs", [[60.0, 20, 20, 20, 20, 20, 20], [30.0, 80.0], [10.0, 12, 70, 5, 44, 50, 9, 61]])
def test_build_chunks_equal(durs):
    segs = [f"segment_ph{i}" for i in range(1, len(durs) + 1)]
    dur_map = dict(zip(segs, map(float, durs)))
    got = tab.build_chunks(segs, dur_map, target=60, margin=15)
    want = jab.build_chunks(segs, dur_map, target=60, margin=15)
    assert [vars(c) for c in got] == [vars(c) for c in want] and got


def test_prepare_ab_test_byte_equal(tmp_path):
    res = tmp_path / "results" / "v1" / "segmented_audio"
    raw = tmp_path / "data" / "v1_raw" / "audio"
    res.mkdir(parents=True)
    raw.mkdir(parents=True)
    for i, dur in enumerate((25, 22, 31, 18), 1):
        x = np.random.default_rng(i).normal(size=8000 * dur) * 0.1
        jwav.write_wav(res / f"segment_ph{i}.wav", x, 8000)
        jwav.write_wav(raw / f"segment_ph{i}.wav", x * 0.5, 8000)
    got = tab.prepare_ab_test(tmp_path / "results", tmp_path / "data", tmp_path / "ab_t", num_pairs=5)
    want = jab.prepare_ab_test(tmp_path / "results", tmp_path / "data", tmp_path / "ab_j", num_pairs=5)
    assert [vars(c) for c in got] == [vars(c) for c in want] and got
    files = sorted(p.relative_to(tmp_path / "ab_j") for p in (tmp_path / "ab_j").rglob("*.wav"))
    assert files == sorted(p.relative_to(tmp_path / "ab_t") for p in (tmp_path / "ab_t").rglob("*.wav"))
    for f in files:
        assert (tmp_path / "ab_t" / f).read_bytes() == (tmp_path / "ab_j" / f).read_bytes()


def test_aligner_harness_equal(tmp_path):
    gold = [(0.0, 0.5, "bonjour"), (0.6, 1.0, "monde."), (1.2, 1.5, "salut"), (1.6, 2.0, "amis.")]
    pred = [(0.02, 0.52, "bonjour"), (0.63, 1.05, "monde"), (1.18, 1.52, "salu"), (1.58, 2.02, "amis."),
            (2.1, 2.3, "encore")]
    got = tharn.evaluate_alignment([tharn.WordInterval(*w) for w in pred], [tharn.WordInterval(*w) for w in gold],
                                   window_s=1.0)
    want = jharn.evaluate_alignment([jharn.WordInterval(*w) for w in pred], [jharn.WordInterval(*w) for w in gold],
                                    window_s=1.0)
    assert vars(got["entire"]) == vars(want["entire"]) and got["entire"].n_matched == 4
    assert {k: vars(v) for k, v in got["windows"].items()} == {k: vars(v) for k, v in want["windows"].items()}
    assert [vars(s) for s in got["sentences"]] == [vars(s) for s in want["sentences"]]
    words = [tharn.WordInterval(*w) for w in pred]
    tharn.write_audacity_labels(words, tmp_path / "t.txt")
    jharn.write_audacity_labels([jharn.WordInterval(*w) for w in pred], tmp_path / "j.txt")
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert [vars(w) for w in tharn.read_audacity_labels(tmp_path / "t.txt")] == [
        vars(w) for w in jharn.read_audacity_labels(tmp_path / "t.txt")]
    tg = ttg.word_tier_with_silences(gold, 2.5)
    assert tharn.textgrid_to_transcript(tg) == jharn.textgrid_to_transcript(jtg.word_tier_with_silences(gold, 2.5))


# -- Needleman-Wunsch and the TextGrid merge ------------------------------------------------------------


@pytest.mark.parametrize("a,b", [
    ("le chat dort sur la maison".split(), "le chat dort dans la grande maison".split()),
    ([], ["un"]), (["a", "b", "c"], []), ("x y z x y".split(), "y x z y x".split()),
])
def test_needleman_wunsch_equal(a, b):
    assert talign.needleman_wunsch(a, b) == jneedleman_wunsch(a, b)


def test_merge_textgrids_equal():
    nat = [(0.0, 0.4, "bonjour"), (0.5, 0.9, "le"), (1.0, 1.5, "monde"), (1.6, 2.0, "entier."), (2.1, 2.4, "merci")]
    syn = [(0.0, 0.3, "Bonjour"), (0.4, 0.8, "monde"), (0.9, 1.4, "entiers."), (1.5, 1.7, "euh"), (1.8, 2.2, "merci")]
    got = talign.merge_textgrids(ttg.word_tier_with_silences(nat, 2.5), ttg.word_tier_with_silences(syn, 2.3))
    want = jmerge_textgrids(jtg.word_tier_with_silences(nat, 2.5), jtg.word_tier_with_silences(syn, 2.3))
    assert got[2] == want[2] and got[2]
    for g, w in zip(got[:2], want[:2]):
        assert [(iv.min_time, iv.max_time, iv.mark) for iv in g.tiers[0]] == [
            (iv.min_time, iv.max_time, iv.mark) for iv in w.tiers[0]]


# -- cross-aligner agreement -------------------------------------------------------------------------


def test_boundary_deltas_and_silence_consistency_equal():
    a = [(0.0, 0.5, "un"), (0.6, 1.0, "deux"), (1.3, 1.9, "trois")]
    b = [(0.1, 0.5, "un"), (0.6, 1.1, "deux"), (1.25, 1.8, "trois")]
    got = traa.boundary_deltas_ms(ttg.word_tier_with_silences(a, 2.0), ttg.word_tier_with_silences(b, 2.0))
    want = jraa.boundary_deltas_ms(jtg.word_tier_with_silences(a, 2.0), jtg.word_tier_with_silences(b, 2.0))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="word count mismatch"):
        traa.boundary_deltas_ms(ttg.word_tier_with_silences(a[:1], 2.0), ttg.word_tier_with_silences(b, 2.0))
    sr = 16000
    x = np.zeros(sr * 2, np.float32)
    x[sr // 2 : sr] = np.sin(np.linspace(0, 800 * np.pi, sr // 2)).astype(np.float32) * 0.5
    for words in ([(0.5, 1.0, "mot")], [(1.2, 1.9, "mot")], a):
        got = traa.silence_consistency(ttg.word_tier_with_silences(words, 2.0), x, sr, device="cpu")
        assert got == jraa.silence_consistency(jtg.word_tier_with_silences(words, 2.0), x, sr)


class _Recorder:
    """An aligner that keeps the TextGrids it returns."""

    def __init__(self, aligner):
        self.aligner, self.grids = aligner, []

    def align(self, audio, transcript):
        tg = self.aligner.align(audio, transcript)
        self.grids.append(tg)
        return tg


def _spans(tg):
    return [(iv.min_time, iv.max_time, iv.mark.strip()) for iv in tg.tiers[0] if iv.mark.strip()]


def test_segment_agreement_matches_jax(speech):
    x, _ = speech
    ref = "la musique commence demain matin"
    t_al = {n: _Recorder(tget_aligner(n, device="cpu")) for n in ("whisper", "ctc", "energy")}
    j_al = {n: _Recorder(jget_aligner(n)) for n in ("whisper", "ctc", "energy")}
    got = traa.segment_agreement(TAudio(x, 16000), "s", ref, device="cpu", **t_al).row()
    want = jraa.segment_agreement(jwav.Audio(x, 16000), "s", ref, **j_al).row()
    for n in t_al:
        for tg, jg in zip(t_al[n].grids, j_al[n].grids, strict=True):
            g, w = _spans(tg), _spans(jg)
            assert [m for *_, m in g] == [m for *_, m in w], n
            assert max(max(abs(a0 - b0), abs(a1 - b1)) for (a0, a1, _), (b0, b1, _) in zip(g, w)) <= 0.02 + 1e-6
    assert got.keys() == want.keys() and got["n_words"] == want["n_words"] == 5 and got["wer"] == want["wer"]
    for k, v in want.items():
        if k.endswith("_ms"):
            assert abs(got[k] - v) <= 40.0, k
        elif k not in ("segment", "n_words", "wer"):
            assert abs(got[k] - v) <= 0.05, k
