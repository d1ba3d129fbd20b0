"""WAV concatenation in numeric segment order (host only).

A copy of the JAX package's ``audio/merge.py``. Replaces Code/Preprocessing/merge_wav.py: sort ``segment_phN`` files by N
(:20-25), skip undecodable files with a warning (:31-40), concatenate, and
export one wav. Sample-rate mismatches are resampled to the first file's
rate (pydub would do this implicitly via frame-rate coercion).
"""

from __future__ import annotations

import logging
import re
from pathlib import Path

import numpy as np

from ..utils.wavio import Audio, read_wav, resample, write_wav

log = logging.getLogger(__name__)
_NUM = re.compile(r"(\d+)")


def _numeric_key(p: Path):
    m = _NUM.findall(p.stem)
    return (int(m[-1]) if m else 1 << 30, p.stem)


def merge_wavs(paths: list[Path]) -> Audio | None:
    rate = None
    parts: list[np.ndarray] = []
    for p in paths:
        try:
            a = read_wav(p).to_mono()
        except (ValueError, FileNotFoundError) as e:
            log.warning("skipping unreadable wav %s: %s", p, e)
            continue
        if rate is None:
            rate = a.rate
        elif a.rate != rate:
            a = resample(a, rate)
        parts.append(np.asarray(a.samples))
    if not parts:
        return None
    return Audio(np.concatenate(parts), rate)


def merge_wav_from_folder(folder: str | Path, output: str | Path, pattern: str = "*.wav") -> bool:
    paths = sorted(Path(folder).glob(pattern), key=_numeric_key)
    merged = merge_wavs(paths)
    if merged is None:
        log.warning("no decodable wavs in %s", folder)
        return False
    write_wav(output, merged)
    return True
