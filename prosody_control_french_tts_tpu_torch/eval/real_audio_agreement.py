"""Label-free alignment evidence on REAL audio.

No gold word boundaries exist for the reference's bundled real-French
corpus (its Data/voice/records/audio), so aligner quality there is
argued the way the reference's own gold harness frames it
(Code/whisper_testing/splitting.py:130-252 builds exactly this kind of
boundary comparison): independent aligners agreeing on the same boundaries,
and boundaries being consistent with acoustic silence.

Per segment:
- the packaged Whisper transcribes freely; if a reference text is supplied,
  WER against it is reported. NOTE: the bundled corpus ships WITHOUT gold
  transcripts — callers passing nominal stand-in text get a decode-
  stability proxy (hallucinating output scores ≈2-4 against any fluent
  French), not an accuracy measurement;
- CTC and the energy aligner teacher-force on WHISPER'S transcript, so all
  three produce the same word sequence and boundary deltas compare 1:1;
- every aligner's word intervals are checked against the acoustic silence
  map (ops.energy.detect_nonsilent): words should live in speech, long
  silences should carry no word mass.

Counterpart of the JAX package's ``eval/real_audio_agreement.py``.
``device`` (CUDA by default) goes to the aligners it builds and to the
silence scan; without a card they raise unless given ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..ops.kernels import resolve_device
from ..utils.textgridio import TextGrid
from ..utils.wavio import Audio, read_wav

__all__ = ["segment_agreement", "corpus_agreement_report"]


def _words(tg: TextGrid) -> list[tuple[float, float, str]]:
    return [(iv.min_time, iv.max_time, iv.mark.strip()) for iv in tg.tiers[0] if iv.mark.strip()]


def boundary_deltas_ms(a: TextGrid, b: TextGrid) -> np.ndarray:
    """|Δ| of every word start and end between two alignments of the SAME
    word sequence (teacher-forced on one transcript)."""
    wa, wb = _words(a), _words(b)
    if len(wa) != len(wb):
        raise ValueError(f"word count mismatch: {len(wa)} vs {len(wb)}")
    out = []
    for (s0, e0, _), (s1, e1, _) in zip(wa, wb):
        out.append(abs(s0 - s1) * 1000.0)
        out.append(abs(e0 - e1) * 1000.0)
    return np.asarray(out, np.float32)


def silence_consistency(tg: TextGrid, x: np.ndarray, rate: int, device="cuda") -> dict[str, float]:
    """Acoustic-consistency proxies (label-free):
    - ``word_time_in_silence``: fraction of total word-interval time that
      falls inside detected silence (lower = better localisation);
    - ``speech_covered_by_words``: fraction of detected speech time covered
      by word intervals (higher = nothing skipped)."""
    from ..ops.energy import detect_nonsilent

    length_ms = int(len(x) * 1000 / rate)
    speech = detect_nonsilent(x, rate, min_silence_len=180, silence_thresh=-42.0, device=device)
    grid = np.zeros(max(length_ms, 1), bool)
    for s, e in speech:
        grid[s:e] = True
    word_mask = np.zeros_like(grid)
    for s, e, _ in _words(tg):
        word_mask[int(s * 1000) : int(e * 1000)] = True
    word_ms = max(int(word_mask.sum()), 1)
    speech_ms = max(int(grid.sum()), 1)
    return {
        "word_time_in_silence": float((word_mask & ~grid).sum() / word_ms),
        "speech_covered_by_words": float((word_mask & grid).sum() / speech_ms),
    }


@dataclass
class SegmentAgreement:
    stem: str
    n_words: int
    wer_vs_reference: float | None
    whisper_ctc_ms: dict = field(default_factory=dict)
    whisper_energy_ms: dict = field(default_factory=dict)
    ctc_energy_ms: dict = field(default_factory=dict)
    silence: dict = field(default_factory=dict)  # per aligner

    def row(self) -> dict:
        return {
            "segment": self.stem,
            "n_words": self.n_words,
            "wer": self.wer_vs_reference,
            **{f"whisper_ctc_{k}": v for k, v in self.whisper_ctc_ms.items()},
            **{f"whisper_energy_{k}": v for k, v in self.whisper_energy_ms.items()},
            **{f"ctc_energy_{k}": v for k, v in self.ctc_energy_ms.items()},
            **{
                f"{al}_{k}": v
                for al, d in self.silence.items()
                for k, v in d.items()
            },
        }


def _delta_stats(d: np.ndarray) -> dict[str, float]:
    return {
        "median_ms": float(np.median(d)),
        "p90_ms": float(np.percentile(d, 90)),
    }


def segment_agreement(
    audio: Audio,
    stem: str,
    reference_text: str | None = None,
    whisper=None,
    ctc=None,
    energy=None,
    device="cuda",
) -> SegmentAgreement:
    from ..align.base import get_aligner

    resolve_device(device)
    whisper = whisper or get_aligner("whisper", device=device)
    ctc = ctc or get_aligner("ctc", device=device)
    energy = energy or get_aligner("energy", device=device)

    tg_w = whisper.align(audio, None)  # free ASR + DTW
    hyp = " ".join(w for _, _, w in _words(tg_w))
    wer_val = None
    if reference_text is not None:
        from .metrics import normalize_asr_text, wer

        # both sides through the published ASR normalization (Whisper's
        # BasicTextNormalizer): case/diacritics/punctuation styles differ
        # between the nominal refs and the byte decode; scoring raw strings
        # would count orthography, not words
        wer_val = round(wer(normalize_asr_text(reference_text), normalize_asr_text(hyp)), 3)
    if not hyp:
        return SegmentAgreement(stem, 0, wer_val)
    tg_c = ctc.align(audio, hyp)
    tg_e = energy.align(audio, hyp)
    x = np.asarray(audio.to_mono().samples, np.float32)
    return SegmentAgreement(
        stem=stem,
        n_words=len(_words(tg_w)),
        wer_vs_reference=wer_val,
        whisper_ctc_ms=_delta_stats(boundary_deltas_ms(tg_w, tg_c)),
        whisper_energy_ms=_delta_stats(boundary_deltas_ms(tg_w, tg_e)),
        ctc_energy_ms=_delta_stats(boundary_deltas_ms(tg_c, tg_e)),
        silence={
            "whisper": silence_consistency(tg_w, x, audio.rate, device=device),
            "ctc": silence_consistency(tg_c, x, audio.rate, device=device),
            "energy": silence_consistency(tg_e, x, audio.rate, device=device),
        },
    )


def corpus_agreement_report(
    wavs: list[Path], references: dict[str, str] | None = None, device="cuda"
) -> dict:
    """Run the full cross-aligner agreement over a corpus; returns
    {"segments": [row…], "summary": {…medians…}}."""
    from ..align.base import get_aligner

    whisper = get_aligner("whisper", device=device)
    ctc = get_aligner("ctc", device=device)
    energy = get_aligner("energy", device=device)
    references = references or {}
    segs = []
    for w in wavs:
        a = read_wav(w).to_mono()
        segs.append(
            segment_agreement(
                a, w.stem, references.get(w.stem), whisper=whisper, ctc=ctc, energy=energy, device=device
            )
        )
    rows = [s.row() for s in segs]

    def med(key):
        vals = [r[key] for r in rows if key in r and r[key] is not None]
        return round(float(np.median(vals)), 3) if vals else None

    summary = {
        "segments": len(rows),
        "wer_median": med("wer"),
        "whisper_ctc_median_ms": med("whisper_ctc_median_ms"),
        "whisper_energy_median_ms": med("whisper_energy_median_ms"),
        "ctc_energy_median_ms": med("ctc_energy_median_ms"),
        "whisper_word_time_in_silence": med("whisper_word_time_in_silence"),
        "ctc_word_time_in_silence": med("ctc_word_time_in_silence"),
        "energy_word_time_in_silence": med("energy_word_time_in_silence"),
        "whisper_speech_covered": med("whisper_speech_covered_by_words"),
        "ctc_speech_covered": med("ctc_speech_covered_by_words"),
        "energy_speech_covered": med("energy_speech_covered_by_words"),
    }
    return {"segments": rows, "summary": summary}
