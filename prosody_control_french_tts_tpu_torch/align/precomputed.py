"""Aligner that serves pre-existing TextGrids from a directory (the
resume-from-disk path: alignment skipped when TextGrids are on disk)."""

from __future__ import annotations

from pathlib import Path

from ..utils.textgridio import TextGrid, read_textgrid
from ..utils.wavio import Audio


class PrecomputedAligner:
    def __init__(self, textgrid_dir: str | Path, name: str | None = None):
        self.textgrid_dir = Path(textgrid_dir)
        self._current: str | None = name

    def for_segment(self, name: str) -> "PrecomputedAligner":
        return PrecomputedAligner(self.textgrid_dir, name)

    def align(self, audio: Audio, transcript: str | None = None) -> TextGrid:
        if self._current is None:
            raise ValueError("PrecomputedAligner needs a segment name (use for_segment)")
        return read_textgrid(self.textgrid_dir / f"{self._current}.TextGrid")

    def transcribe(self, audio: Audio) -> str:
        tg = self.align(audio)
        return " ".join(iv.mark.strip() for iv in tg.tiers[0] if iv.mark.strip())
