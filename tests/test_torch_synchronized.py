"""The PyTorch port's host-only pipeline family (``core/synchronized.py``,
``audio/merge.py``, ``tts/batch.py``) against the JAX package's copies,
with the fake TTS on both sides: every output file byte-equal."""

import numpy as np
import pytest

from prosody_control_french_tts_tpu.audio.merge import merge_wav_from_folder as j_merge_folder
from prosody_control_french_tts_tpu.audio.merge import merge_wavs as j_merge_wavs
from prosody_control_french_tts_tpu.core.synchronized import SynchronizedSSMLPipeline as JSync
from prosody_control_french_tts_tpu.tts.batch import clean_ssml_for_azure as j_clean
from prosody_control_french_tts_tpu.tts.batch import process_ssml_folder as j_process
from prosody_control_french_tts_tpu.tts.fake import FakeBackend as JFake
from prosody_control_french_tts_tpu.utils import wavio as jwav
from prosody_control_french_tts_tpu.utils.textgridio import word_tier_with_silences, write_textgrid
from prosody_control_french_tts_tpu_torch.audio.merge import merge_wav_from_folder as t_merge_folder
from prosody_control_french_tts_tpu_torch.audio.merge import merge_wavs as t_merge_wavs
from prosody_control_french_tts_tpu_torch.core.synchronized import SynchronizedSSMLPipeline as TSync
from prosody_control_french_tts_tpu_torch.tts.base import TTSError
from prosody_control_french_tts_tpu_torch.tts.batch import clean_ssml_for_azure as t_clean
from prosody_control_french_tts_tpu_torch.tts.batch import process_ssml_folder as t_process
from prosody_control_french_tts_tpu_torch.tts.fake import FakeBackend as TFake
from prosody_control_french_tts_tpu_torch.utils import wavio as twav

SR = 44100
SEGMENTS = {"segment_ph1": (["bonjour", "le", "monde."], "bonjour le monde."),
            "segment_ph2": (["la", "voix", "change", "beaucoup,", "merci."], "la voix change beaucoup, merci..."),
            "segment_ph10": (["quelle", "belle", "journée."], "quelle belle journée.")}


def _corpus(root):
    gen = JFake(seed=4)
    dirs = [root / d for d in ("audio", "tg", "txt")]
    for d in dirs:
        d.mkdir(parents=True)
    for stem, (words, text) in SEGMENTS.items():
        t, chunks, times = 0.0, [], []
        for i, w in enumerate(words):
            a = gen._voice(w, 0, 0, 0)
            times.append((t, t + len(a) / SR, w))
            t += len(a) / SR
            chunks.append(a)
            gap = 0.4 if i % 2 else 0.05
            chunks.append(np.zeros(int(gap * SR)))
            t += gap
        x = np.concatenate(chunks)
        jwav.write_wav(dirs[0] / f"{stem}.wav", x, SR)
        write_textgrid(word_tier_with_silences(times, len(x) / SR), dirs[1] / f"{stem}.TextGrid")
        (dirs[2] / f"{stem}.txt").write_text(text)
    return dirs


def _same_tree(a, b):
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for rel in files:
        assert (b / rel).read_bytes() == (a / rel).read_bytes(), rel
    return files


@pytest.fixture(scope="module")
def sync_runs(tmp_path_factory):
    out = []
    for make, fake in ((JSync, JFake), (TSync, TFake)):
        root = tmp_path_factory.mktemp("sync")
        audio, tg, txt = _corpus(root)
        pipe = make(audio_dir=audio, textgrid_dir=tg, transcription_dir=txt, work_dir=root / "work", tts=fake(seed=8))
        out.append((root, pipe, pipe.run_pipeline()))
    return out


def test_synchronized_outputs_byte_equal(sync_runs):
    (jroot, jpipe, jout), (troot, tpipe, tout) = sync_runs
    assert jout.name == tout.name == "OUT_synchronized.wav"
    files = _same_tree(jroot / "work", troot / "work")
    names = {p.name for p in files}
    for stem in SEGMENTS:
        assert {f"SSML_V1_{stem}.xml", f"SSML_V2_{stem}.xml"} <= names
        assert {f"TTS_V1_{stem}.wav", f"TTS_V2_{stem}.wav"} <= names
    assert tpipe.adjustments == jpipe.adjustments
    assert all(-50.0 <= v["rate_adjustment"] <= 100.0 for v in tpipe.adjustments.values())
    assert "<prosody rate=" in (troot / "work" / "ssml" / "SSML_V2_segment_ph1.xml").read_text()


def test_synchronized_steps_skip_missing_inputs(tmp_path):
    """A TextGrid without its transcript is skipped, as is a calibration
    wav without its natural segment, on both sides alike."""
    outs = []
    for make, fake, sub in ((JSync, JFake, "j"), (TSync, TFake, "t")):
        audio, tg, txt = _corpus(tmp_path / sub)
        (txt / "segment_ph2.txt").unlink()
        (audio / "segment_ph10.wav").unlink()
        pipe = make(audio_dir=audio, textgrid_dir=tg, transcription_dir=txt, work_dir=tmp_path / sub / "work",
                    tts=fake(seed=3))
        v1 = pipe.build_v1()
        outs.append(([p.name for p in v1], pipe.analyze_durations(pipe.synthesize_calibration(v1))))
    assert outs[0] == outs[1]
    assert outs[1][0] == ["SSML_V1_segment_ph1.xml", "SSML_V1_segment_ph10.xml"]
    assert list(outs[1][1]) == ["segment_ph1"]
    _same_tree(tmp_path / "j" / "work", tmp_path / "t" / "work")


def test_merge_wavs_and_folder(tmp_path):
    rng = np.random.default_rng(0)
    src = tmp_path / "src"
    src.mkdir()
    for i, rate in ((1, SR), (2, 22050), (10, SR), (3, SR)):
        jwav.write_wav(src / f"segment_ph{i}.wav", (0.1 * rng.normal(size=rate // 3)).astype(np.float32), rate)
    (src / "segment_ph4.wav").write_bytes(b"not a wav")
    paths = sorted(src.glob("*.wav"))
    a, b = j_merge_wavs(paths), t_merge_wavs(paths)
    assert a.rate == b.rate and np.array_equal(np.asarray(a.samples), np.asarray(b.samples))
    assert j_merge_folder(src, tmp_path / "j.wav", pattern="segment_ph*.wav")
    assert t_merge_folder(src, tmp_path / "t.wav", pattern="segment_ph*.wav")
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    assert twav.read_wav(tmp_path / "t.wav").rate == SR
    assert t_merge_wavs([]) is None and not t_merge_folder(tmp_path / "src_empty_none", tmp_path / "x.wav")


class _Failing:
    """The fake TTS, failing on one document (as a network backend may)."""

    def __init__(self, fake, bad):
        self.fake, self.bad, self.sample_rate = fake, bad, fake.sample_rate

    def synthesize(self, ssml):
        if self.bad in ssml:
            raise TTSError("refused", code=1007)
        return self.fake.synthesize(ssml)


def test_process_ssml_folder_byte_equal_with_resume(tmp_path):
    ssml_dir = tmp_path / "xml"
    ssml_dir.mkdir()
    for i in range(4):
        (ssml_dir / f"{i:04d}.xml").write_text(
            '<?xml version="1.0"?>\n<speak xmlns="http://www.w3.org/2001/10/synthesis" '
            'version="1.0" xml:lang="fr-FR">\n  <voice name="v">\n    '
            f'<prosody pitch="+1.00%" rate="+{i}.00%" volume="+0.00%">mot {i}</prosody>\n'
            "  </voice>\n</speak>"
        )
    counts = []
    for process, fake, sub in ((j_process, JFake, "j"), (t_process, TFake, "t")):
        tts = fake(seed=2)
        first = process(_Failing(tts, "mot 2"), ssml_dir, tmp_path / sub)
        calls = tts.calls
        again = process(tts, ssml_dir, tmp_path / sub)
        counts.append((first, again, calls, tts.calls))
    assert counts[0] == counts[1]
    assert counts[1][0] == (3, 1) and counts[1][1] == (4, 0)
    _same_tree(tmp_path / "j", tmp_path / "t")
    for doc in ('<?xml version="1.0"?>\n<speak>  <a> </a>  </speak>', "<!DOCTYPE x>\n <speak>\n</speak>\n"):
        assert t_clean(doc) == j_clean(doc)
