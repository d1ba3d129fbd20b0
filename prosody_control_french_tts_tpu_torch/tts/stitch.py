"""Waveform stitcher: TTS chunks + exact silence pauses → per-segment wavs
and the merged OUT.wav.

- syntagme rows with text: the synthesized chunk with 5 ms fade-in/out
  (click suppression at joints); "..." rows skipped;
- missing or failed chunks become zero-length silence, with a warning;
- pure-pause rows: silence of exactly ``pause`` ms, raised to
  ``end_punctuation_pause_ms`` when the previous text ended a sentence;
- per-segment buffers plus one global OUT buffer.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field

import numpy as np

from ..utils.wavio import Audio, fade, resample

_HAS_WORD = re.compile(r"\w")
log = logging.getLogger(__name__)


@dataclass
class StitchResult:
    out: Audio
    segments: dict[str, Audio] = field(default_factory=dict)


def stitch_rows(rows: list[dict], chunks: dict[int, Audio | None], sample_rate: int, end_pause_ms: int) -> StitchResult:
    """rows: synth-CSV rows [{segment, syntagme, pause}] in order; chunks:
    content index → synthesized Audio (indexed over text rows only, like the
    ``{idx:04d}.wav`` files)."""
    combined: list[np.ndarray] = []
    seg_bufs: dict[str, list[np.ndarray]] = {}
    current_seg = None
    content_idx = 0
    prev_text = None

    for row in rows:
        seg_id = str(row["segment"])
        if seg_id != current_seg:
            current_seg = seg_id
            seg_bufs.setdefault(seg_id, [])

        txt = str(row.get("syntagme", "") or "").strip()
        if txt and _HAS_WORD.search(txt):
            if txt == "...":
                continue
            chunk = chunks.get(content_idx)
            if chunk is None:
                log.warning("missing TTS chunk for %r; inserting silence", txt)
                samples = np.zeros(0, np.float32)
            else:
                if chunk.rate != sample_rate:
                    chunk = resample(chunk, sample_rate)
                samples = fade(np.asarray(chunk.samples, np.float32), sample_rate, 5, 5)
            combined.append(samples)
            seg_bufs[seg_id].append(samples)
            content_idx += 1
            prev_text = txt
        else:
            pause_ms = int(float(row.get("pause", 0) or 0))
            if prev_text and prev_text.endswith((".", "?", "!")):
                pause_ms = max(pause_ms, end_pause_ms)
            sil = np.zeros(int(round(pause_ms * sample_rate / 1000.0)), np.float32)
            combined.append(sil)
            seg_bufs[seg_id].append(sil)

    def cat(parts: list[np.ndarray]) -> Audio:
        return Audio(np.concatenate(parts) if parts else np.zeros(0, np.float32), sample_rate)

    segments = {seg: cat(parts) for seg, parts in seg_bufs.items() if parts}
    return StitchResult(out=cat(combined), segments=segments)
