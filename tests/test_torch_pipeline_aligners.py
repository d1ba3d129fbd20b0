"""The port's eight-step pipeline with the acoustic aligners, against the
JAX package's, on the CPU.

A 2-segment voice of synthetic French speech (``align.synth_speech``, the
aligners' training distribution, resampled to 44.1 kHz so that the
aligners' own 44.1 → 16 kHz resampling runs) goes through both
``AudioPipeline``s, steps Align+Transcribe through Compare Breaks, once
with ``aligner: whisper`` (no transcripts: the aligner transcribes) and
once with ``aligner: ctc`` (raw transcripts given). Held: the segment
TextGrids and ``OUT.TextGrid`` (equal marks, boundaries within one encoder
frame, 20 ms), the transcripts, and the segment / syntagme / pause columns
of ``BDD_syntagme_ssml.csv``.

The TTS of both pipelines speaks with the same synthesizer
(``SynthSpeechTTS``), so that Final Transcribe aligns speech of the
aligners' own distribution. On the fake TTS's rendering, which neither
checkpoint was trained on, the Whisper aligner's cross-attention is spread
out, and its boundaries there move by 40 to 240 ms between the two
packages: the attention rows differ by a few per cent wherever one
bfloat16 score rounds the other way (measured with the same mel into both:
up to 0.02 of a 0.41 peak), and the DP's choices on flat attention follow
such differences.
"""

import csv
import re
from pathlib import Path

import numpy as np
import pytest

from prosody_control_french_tts_tpu.align.synth_speech import synth_sentence
from prosody_control_french_tts_tpu.core.config import PipelineConfig as JConfig
from prosody_control_french_tts_tpu.core.pipeline import AudioPipeline as JPipeline
from prosody_control_french_tts_tpu.utils import wavio as jwav
from prosody_control_french_tts_tpu.utils.textgridio import read_textgrid
from prosody_control_french_tts_tpu_torch.core.config import PipelineConfig as TConfig
from prosody_control_french_tts_tpu_torch.core.pipeline import AudioPipeline as TPipeline
from prosody_control_french_tts_tpu_torch.utils.wavio import Audio as TAudio

NAME = "alignvoice"
SENTENCES = ("la musique commence demain matin", "nous parlons de la voix naturelle")
STEPS = ["Align+Transcribe", "Raw Synthesis", "Measure & Build SSML", "Synthesize+Merge",
         "Export JSON", "Final Transcribe", "Compare Breaks"]
TOL_S = 0.02 + 1e-6
_TEXT = re.compile(r"<[^>]+>")


class SynthSpeechTTS:
    """A TTS backend speaking with ``align.synth_speech`` at 16 kHz (one
    sentence per SSML text, every word), returning ``audio_cls`` objects."""

    sample_rate = 16000

    def __init__(self, audio_cls, seed: int = 1):
        self.audio_cls, self.seed = audio_cls, seed

    def synthesize(self, ssml: str):
        text = " ".join(_TEXT.sub(" ", ssml).split())
        a, _ = synth_sentence(text, seed=self.seed + sum(map(ord, text)))
        return self.audio_cls(np.asarray(a, np.float32), self.sample_rate)


def build_voice(base: Path, transcripts: bool) -> None:
    vdir = base / "Data" / "voice" / NAME
    (vdir / "audio").mkdir(parents=True)
    (vdir / "transcription_raw").mkdir(parents=True)
    for i, sent in enumerate(SENTENCES):
        a, _ = synth_sentence(sent, seed=40_000 + i)
        x = np.concatenate([np.zeros(4000, np.float32), a, np.zeros(4000, np.float32)])
        a44 = jwav.resample(jwav.Audio(x, 16000), 44100)
        jwav.write_wav(vdir / "audio" / f"segment_ph{i + 1}.wav", np.asarray(a44.samples, np.float32), 44100)
        if transcripts:
            (vdir / "transcription_raw" / f"segment_ph{i + 1}.txt").write_text(sent, encoding="utf-8")


def config(aligner: str) -> dict:
    return {
        "data_dir": "Data/voice", "out_dir": "Out", "voice_names": [NAME], "azure_voice_name": "fr-FR-DeniseNeural",
        "tts_backend": "fake", "aligner": aligner, "steps_to_run": STEPS,
    }


@pytest.fixture(scope="module", params=["whisper", "ctc"])
def runs(request, tmp_path_factory):
    aligner = request.param
    jbase, tbase = tmp_path_factory.mktemp(f"jax_{aligner}"), tmp_path_factory.mktemp(f"torch_{aligner}")
    build_voice(jbase, transcripts=aligner == "ctc")
    build_voice(tbase, transcripts=aligner == "ctc")
    jpipe = JPipeline(NAME, JConfig.from_dict(config(aligner), jbase), tts=SynthSpeechTTS(jwav.Audio))
    jpipe.run()
    tpipe = TPipeline(NAME, TConfig.from_dict(config(aligner), tbase), tts=SynthSpeechTTS(TAudio), device="cpu")
    tpipe.run()
    return aligner, jpipe, tpipe


def _words(path: Path):
    return [(iv.min_time, iv.max_time, iv.mark) for iv in read_textgrid(path).tiers[0] if iv.mark.strip()]


def _same_words(want, got):
    assert [w for *_, w in got] == [w for *_, w in want]
    for (a0, a1, _), (b0, b1, _) in zip(want, got):
        assert abs(a0 - b0) <= TOL_S and abs(a1 - b1) <= TOL_S, (want, got)


def test_segment_textgrids_and_transcripts(runs):
    aligner, jpipe, tpipe = runs
    for i, sent in enumerate(SENTENCES):
        stem = f"segment_ph{i + 1}"
        want = _words(jpipe.textgrid_dir / f"{stem}.TextGrid")
        got = _words(tpipe.textgrid_dir / f"{stem}.TextGrid")
        _same_words(want, got)
        for d in ("transcription_raw", "transcription"):
            assert (tpipe.voice_dir / d / f"{stem}.txt").read_text(encoding="utf-8") == \
                   (jpipe.voice_dir / d / f"{stem}.txt").read_text(encoding="utf-8")


def test_syntagme_columns(runs):
    _, jpipe, tpipe = runs

    def cols(p):
        with open(p, newline="", encoding="utf-8") as f:
            return [(r["segment"], r["syntagme"], r["pause"]) for r in csv.DictReader(f)]

    assert cols(tpipe.bdd_syntagme_ssml_csv) == cols(jpipe.bdd_syntagme_ssml_csv)


def test_final_transcribe(runs):
    """Final Transcribe aligns the whole OUT.wav with the configured
    acoustic aligner on both sides."""
    _, jpipe, tpipe = runs
    _same_words(_words(jpipe.results_dir / "OUT.TextGrid"), _words(tpipe.results_dir / "OUT.TextGrid"))
    assert (tpipe.results_dir / "transcription_final.txt").read_text(encoding="utf-8") == \
           (jpipe.results_dir / "transcription_final.txt").read_text(encoding="utf-8")
