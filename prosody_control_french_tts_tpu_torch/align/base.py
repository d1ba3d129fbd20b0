"""Aligner protocol: audio (+ optional transcript) → word-level TextGrid.

Every aligner returns a word tier with explicit silence intervals
(``utils.textgridio.word_tier_with_silences``), the artifact the rest of the
pipeline reads. The port serves the hermetic ``energy`` and ``precomputed``
aligners.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

from ..utils.textgridio import TextGrid, word_tier_with_silences
from ..utils.wavio import Audio


@dataclass
class AlignedWord:
    start: float
    end: float
    word: str


@runtime_checkable
class Aligner(Protocol):
    def align(self, audio: Audio, transcript: str | None = None) -> TextGrid:  # pragma: no cover
        ...

    def transcribe(self, audio: Audio) -> str:  # pragma: no cover
        ...


def words_to_textgrid(words: list[AlignedWord], duration: float) -> TextGrid:
    return word_tier_with_silences([(w.start, w.end, w.word) for w in words], duration)


def get_aligner(name: str, **kwargs) -> "Aligner":
    """Aligner registry: ``precomputed`` and ``energy``. The acoustic
    aligners (CTC, Whisper) are not ported yet."""
    if name == "precomputed":
        from .precomputed import PrecomputedAligner

        return PrecomputedAligner(**kwargs)
    if name == "energy":
        from .energy import EnergyAligner

        return EnergyAligner(**kwargs)
    if name in ("ctc", "whisper_jax", "whisper"):
        raise NotImplementedError(
            f"aligner {name!r} is not ported to PyTorch yet (ROADMAP Queue 1 items 9-10: CTC, Whisper); "
            "use 'energy' or 'precomputed'"
        )
    raise ValueError(f"unknown aligner {name!r}")
