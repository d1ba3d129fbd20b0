"""Aligner protocol: audio (+ optional transcript) → word-level TextGrid.

Every aligner returns a word tier with explicit silence intervals
(``utils.textgridio.word_tier_with_silences``), the artifact the rest of the
pipeline reads. The registry serves ``precomputed``, ``energy``, ``ctc``
and ``whisper`` (``whisper_jax`` is the JAX package's name for it, kept so
its configs run unchanged).
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
    """Aligner registry (the config switch of the reference's
    ``_alignement`` dispatcher). ``device`` passes through to the aligners
    that compute (``energy``, ``ctc``, ``whisper``): CUDA by default, and
    without a card they raise unless given ``device="cpu"``."""
    if name == "precomputed":
        from .precomputed import PrecomputedAligner

        return PrecomputedAligner(**kwargs)
    if name == "energy":
        from .energy import EnergyAligner

        return EnergyAligner(**kwargs)
    if name == "ctc":
        from .ctc_aligner import CTCAligner

        return CTCAligner(**kwargs)
    if name in ("whisper_jax", "whisper"):
        from .whisper import WhisperAligner

        return WhisperAligner(**kwargs)
    raise ValueError(f"unknown aligner {name!r}")
