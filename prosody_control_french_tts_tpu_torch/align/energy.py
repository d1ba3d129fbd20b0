"""Energy-based word aligner (hermetic, no acoustic model).

Given a transcript, distributes its words over the detected speech runs of
the signal (``ops.energy.detect_nonsilent``, on the device), weighting by
approximate syllable counts: the pipeline's deterministic stand-in for ASR
alignment, and the final transcription step's aligner.
"""

from __future__ import annotations

import numpy as np

from ..ops.energy import detect_nonsilent
from ..utils.textgridio import TextGrid
from ..utils.wavio import Audio
from .base import AlignedWord, words_to_textgrid


def _syllables(word: str) -> int:
    v = sum(1 for c in word.lower() if c in "aeiouyàâäéèêëîïôöùûü")
    return max(1, v)


class EnergyAligner:
    def __init__(self, min_silence_len: int = 120, silence_thresh: float = -45.0, device="cuda"):
        self.min_silence_len = min_silence_len
        self.silence_thresh = silence_thresh
        self.device = device

    def align(self, audio: Audio, transcript: str | None = None) -> TextGrid:
        if not transcript:
            raise ValueError("EnergyAligner requires a transcript")
        audio = audio.to_mono()
        x = np.asarray(audio.samples, np.float32)
        runs = detect_nonsilent(x, audio.rate, self.min_silence_len, self.silence_thresh, device=self.device)
        if not runs:
            runs = [[0, int(audio.duration_seconds * 1000)]]
        words = transcript.split()
        if not words:
            return words_to_textgrid([], audio.duration_seconds)

        # apportion words to runs by duration share
        run_durs = np.array([e - s for s, e in runs], float)
        total_syl = sum(_syllables(w) for w in words)
        word_syl = np.array([_syllables(w) for w in words], float)
        cum_syl = np.cumsum(word_syl) / total_syl
        cum_dur = np.cumsum(run_durs) / run_durs.sum()

        aligned: list[AlignedWord] = []
        wi = 0
        for ri, (s, e) in enumerate(runs):
            hi_frac = cum_dur[ri]
            # words whose cumulative-syllable position falls in this run
            take = []
            while wi < len(words) and (cum_syl[wi] <= hi_frac + 1e-9 or ri == len(runs) - 1):
                take.append(wi)
                wi += 1
            if not take:
                continue
            syls = word_syl[take]
            bounds = np.concatenate([[0.0], np.cumsum(syls) / syls.sum()])
            for k, widx in enumerate(take):
                w_start = (s + bounds[k] * (e - s)) / 1000.0
                w_end = (s + bounds[k + 1] * (e - s)) / 1000.0
                aligned.append(AlignedWord(w_start, w_end, words[widx]))
        return words_to_textgrid(aligned, audio.duration_seconds)

    def transcribe(self, audio: Audio) -> str:
        raise NotImplementedError("EnergyAligner cannot transcribe; provide transcripts or use an ASR aligner")
