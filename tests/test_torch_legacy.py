"""The port's legacy BDD1→BDD5 chain (``legacy/``) against the JAX package's
on the CPU.

One synthetic voice from a numpy seed (``utils/synth.py``: three segments
and their raw renderings, with word TextGrids on both sides; the synthetic
side of segment 2 loses a word and segment 3 has a word changed, so that
Needleman-Wunsch makes gap rows) is laid out twice, and ``Voc`` runs on each
with the fake TTS at the same seed. The CSVs are held equal as strings
column by column, but the float columns of the pitch stage: the two pitch
trackers' FFTs round differently in the last bits, so the syntagmes'
geometric-mean pitches are held within 1e-3 relative and the pitch
adjustments within 1e-3 points (the JAX suite's parity bar). The
synthesized wavs and OUT.wav are sample-equal.
"""

import csv
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from prosody_control_french_tts_tpu.legacy import bdd as jbdd
from prosody_control_french_tts_tpu.legacy import needleman as jnw
from prosody_control_french_tts_tpu.legacy.voc import Voc as JVoc
from prosody_control_french_tts_tpu.tts.fake import FakeBackend as JFake
from prosody_control_french_tts_tpu.utils import wavio as jwav
from prosody_control_french_tts_tpu_torch.legacy import bdd as tbdd
from prosody_control_french_tts_tpu_torch.legacy import needleman as tnw
from prosody_control_french_tts_tpu_torch.legacy.voc import Voc as TVoc
from prosody_control_french_tts_tpu_torch.tts.fake import FakeBackend as TFake
from prosody_control_french_tts_tpu_torch.utils import wavio as twav
from prosody_control_french_tts_tpu_torch.utils.synth import lay_out_voice, synth_voice
from prosody_control_french_tts_tpu_torch.utils.textgridio import read_textgrid, word_tier_with_silences, write_textgrid

NAME = "legacy_voice"
PITCH_COLUMNS = ("natural_pitch", "synthesized_pitch")
ADJUSTMENT_COLUMNS = ("pitch_adjustment", "relative_pitch_pct")
CSVS = ("BDD2.csv", "BDD3.csv", "BDD4.csv")


def _edit_synthetic_words(raw_dir: Path) -> None:
    """Drop segment 2's second word and rename segment 3's first on the
    synthetic side."""
    for seg, edit in (("segment_ph2", "drop"), ("segment_ph3", "rename")):
        path = raw_dir / "WhisperTS_textgrid_files" / f"{seg}.TextGrid"
        tg = read_textgrid(path)
        words = [(iv.min_time, iv.max_time, iv.mark) for iv in tg.tiers[0] if iv.mark.strip()]
        if edit == "drop":
            words.pop(1)
        else:
            words[0] = (words[0][0], words[0][1], "autrement")
        write_textgrid(word_tier_with_silences(words, tg.max_time), path)


def build_legacy_voice(base: Path, seed: int = 3) -> tuple[Path, Path]:
    synth_voice(base / "synth", seed=seed, n_segments=3, seconds=(2.0, 3.0))
    voice_dir, raw_dir = lay_out_voice(base / "synth", base / "Data" / "voice", NAME)
    _edit_synthetic_words(raw_dir)
    return voice_dir, raw_dir


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    out = {}
    for kind in ("jax", "torch"):
        base = tmp_path_factory.mktemp(f"legacy_{kind}")
        voice_dir, raw_dir = build_legacy_voice(base)
        res = base / "Out" / "legacy"
        if kind == "jax":
            voc = JVoc(voice_dir, raw_dir, res, tts=JFake(seed=9))
        else:
            voc = TVoc(voice_dir, raw_dir, res, tts=TFake(seed=9), device="cpu")
        out[kind] = (voc.run_pipeline(), voc, res, base)
    return out


def _rows(path):
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


def test_inputs_exercise_gaps_and_pauses(chains):
    _, voc, _, _ = chains["torch"]
    assert len(voc.synts) >= 6 and any(s.is_pause for s in voc.synts)
    assert any(s.pause_natural == 0.01 or s.pause_synthesized == 0.01 for s in voc.synts if s.is_pause)


@pytest.mark.parametrize("name", CSVS)
def test_bdd_csvs_match_jax(chains, name):
    want = _rows(chains["jax"][2] / name)
    got = _rows(chains["torch"][2] / name)
    assert len(got) == len(want) > 0 and list(got[0]) == list(want[0])
    for g, w in zip(got, want):
        for col in w:
            if col.endswith("_file") and w[col]:  # the wav paths, each under its own base
                assert Path(g[col]).relative_to(chains["torch"][3]) == Path(w[col]).relative_to(chains["jax"][3])
            elif col in PITCH_COLUMNS:
                assert float(g[col]) == pytest.approx(float(w[col]), rel=1e-3, abs=0), col
            elif col in ADJUSTMENT_COLUMNS:
                assert abs(float(g[col]) - float(w[col])) <= 1e-3, col
            else:
                assert g[col] == w[col], col


def test_pitch_means_and_ssml(chains):
    """Where the pitch means agree to the printed digit, BDD_ssml.csv is the
    same string; else every fragment differs at most in its pitch tag."""
    jv, tv = chains["jax"][1], chains["torch"][1]
    same = all(a.natural_pitch == b.natural_pitch and a.synthesized_pitch == b.synthesized_pitch
               for a, b in zip(jv.synts, tv.synts))
    want = (chains["jax"][2] / "BDD_ssml.csv").read_text(encoding="utf-8")
    got = (chains["torch"][2] / "BDD_ssml.csv").read_text(encoding="utf-8")
    if same:
        assert got == want
    strip = lambda text: [line.split("pitch='")[0] for line in text.splitlines()]  # noqa: E731
    assert strip(got) == strip(want)
    for a, b in zip(jv.synts, tv.synts):
        assert abs(a.relative_pitch_pct - b.relative_pitch_pct) <= 1e-3


@pytest.mark.parametrize("where", ["OUT.wav", "segments"])
def test_synthesis_and_merge_sample_equal(chains, where):
    jres, tres = chains["jax"][2], chains["torch"][2]
    wavs = [jres / "OUT.wav"] if where == "OUT.wav" else sorted((jres / "segments").glob("*.wav"))
    assert wavs
    for p in wavs:
        a, b = jwav.read_wav(p), twav.read_wav(tres / p.relative_to(jres))
        assert a.rate == b.rate and np.array_equal(a.samples, b.samples), p.name


def test_resume_from_the_checkpoint_marker(chains):
    _, voc, res, _ = chains["torch"]
    assert (res / "checkpoint_tts_merge_done.txt").exists() and (res / "checkpoint_align_done.txt").exists()
    tts = TFake(seed=9)
    again = TVoc(voc.voice_dir, voc.synth_dir, res, tts=tts, device="cpu")
    assert again.run_pipeline() == res / "OUT.wav"
    assert tts.calls == 0 and again.synts == []
    fresh = TVoc(voc.voice_dir, voc.synth_dir, res, tts=TFake(seed=9), check_checkfiles=False, device="cpu")
    fresh.run_pipeline()
    assert fresh.tts.calls > 0


def test_needleman_rows_equal_jax(chains):
    """``nw_align_rows`` on the voice's rows and on hand-made sequences with
    gaps on either side: the same rows."""
    voice_dir, raw_dir = chains["torch"][1].voice_dir, chains["torch"][1].synth_dir
    for seg in ("segment_ph1", "segment_ph2", "segment_ph3"):
        nat = tbdd.extract_segment_rows(voice_dir / "WhisperTS_textgrid_files" / f"{seg}.TextGrid", seg, "n.wav")
        syn = tbdd.extract_segment_rows(raw_dir / "WhisperTS_textgrid_files" / f"{seg}.TextGrid", seg, "s.wav")
        assert nat == jbdd.extract_segment_rows(str(voice_dir / "WhisperTS_textgrid_files" / f"{seg}.TextGrid"), seg, "n.wav")
        got = [dataclasses.asdict(r) for r in tnw.nw_align_rows(nat, syn)]
        assert got == [dataclasses.asdict(r) for r in jnw.nw_align_rows(nat, syn)]
    row = lambda w, t: {"PhraseID": "f", "Start": t, "End": t + 0.3, "Duration": 0.3, "Text": w, "File": "x"}  # noqa: E731
    for a, b in ((["un", "deux", "trois"], ["un", "trois"]), (["un"], ["zéro", "un", "deux"]), ([], ["seul"])):
        nat, syn = [row(w, i) for i, w in enumerate(a)], [row(w, i) for i, w in enumerate(b)]
        got = [dataclasses.asdict(r) for r in tnw.nw_align_rows(nat, syn)]
        assert got == [dataclasses.asdict(r) for r in jnw.nw_align_rows(nat, syn)]


def test_stage_math_equal_jax():
    """The pure stages on the same rows: breaks, syntagmes, rate and SSML
    fragments (including the breath hints and the pause clamps)."""
    row = lambda w, t, d: {"PhraseID": "f", "Start": t, "End": t + d, "Duration": d, "Text": w,  # noqa: E731
                           "File": "x/segment_ph4.wav"}
    nat = [row("bonjour", 0.0, 0.4), row("", 0.4, 0.3), row("cher", 0.7, 0.2), row("monde!", 0.9, 0.5)]
    syn = [row("bonjour", 0.0, 0.5), row("", 0.5, 0.2), row("monde!", 0.7, 0.6)]
    out = []
    for m in (jbdd, tbdd):
        synts = m.construct_syntagmes(m.add_breaks(m.align_rows(nat, syn)))
        m.compute_rate_adjustments(synts)
        out.append(([dataclasses.asdict(s) for s in synts], m.build_ssml_fragments(synts, "fr-FR-HenriNeural")))
    assert out[0] == out[1]
    for args in (("vraiment,", 16.0, 32.0, 5.0, 0.0), ("", 0, 0, 0, 6.0), ("", 0, 0, 0, 0.0015), ("a < b", -9.0, -3.0, 0, 0)):
        assert tbdd.ssml_fragment(*args) == jbdd.ssml_fragment(*args)


def test_pitch_cache_retries_lower_floors():
    """A 90 Hz voice is below the first floors' reach at 150/200 but found
    by the 75 Hz track; the cache tracks each (file, floor) once."""
    import tempfile

    sr = 44100
    t = np.arange(sr) / sr
    x = (0.5 * np.sin(2 * np.pi * 90 * t) + 0.2 * np.sin(2 * np.pi * 180 * t)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        wav = Path(d) / "segment_ph1.wav"
        twav.write_wav(wav, x, sr)
        cache = tbdd._PitchCache(device="cpu")
        got = cache.geometric_mean_pitch(str(wav), 0.1, 0.9)
        want = jbdd._PitchCache().geometric_mean_pitch(str(wav), 0.1, 0.9)
        cache.geometric_mean_pitch(str(wav), 0.2, 0.5)
    assert got == pytest.approx(want, rel=1e-3) and abs(got - 90) / 90 < 0.02
    assert list(cache.tracks) == [(str(wav), 75.0)]
