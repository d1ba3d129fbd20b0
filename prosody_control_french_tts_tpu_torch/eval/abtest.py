"""AB-test pair preparation (Code/prepare_AB_test.py parity).

Builds N (raw, improved) audio pairs of target duration (default 60±15 s,
config.yaml:70-75) by greedy chunking of *consecutive* segments:

1. singles already inside [target−margin, target+margin];
2. contiguous runs accumulated until ≥ lower bound; overshoot resolved by
   dropping the last segment (if still ≥ lower) or trimming it to hit the
   target exactly (prepare_AB_test.py:63-109);
3. random sample of num_pairs chunks, exported as
   ``<idx>-<voice>_<segs>/raw.wav`` + ``improved.wav`` (:112-139).
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..utils.wavio import Audio, read_wav, write_wav

log = logging.getLogger(__name__)
_IDX = re.compile(r"segment_ph(\d+)")


def idx_key(stem: str) -> int:
    m = _IDX.search(stem)
    return int(m.group(1)) if m else -1


@dataclass
class Chunk:
    segments: list[str]
    trim_last: bool = False
    trim_duration_s: float | None = None
    voice: str = ""


def build_chunks(segments: list[str], dur_map: dict[str, float], target: float, margin: float) -> list[Chunk]:
    lower, upper = target - margin, target + margin
    avail = [s for s in segments if s in dur_map]
    chunks: list[Chunk] = []
    for stem in list(avail):
        if lower <= dur_map[stem] <= upper:
            chunks.append(Chunk(segments=[stem]))
            avail.remove(stem)
    idx = 0
    while idx < len(avail):
        total = 0.0
        group: list[str] = []
        j = idx
        last_idx = None
        while j < len(avail) and total < lower:
            seg = avail[j]
            seg_idx = idx_key(seg)
            if last_idx is not None and seg_idx != last_idx + 1:
                break
            group.append(seg)
            total += dur_map[seg]
            last_idx = seg_idx
            j += 1
        if total < lower:
            break
        if total <= upper:
            chunks.append(Chunk(segments=group.copy()))
            idx = j
        else:
            last = group[-1]
            prev_total = total - dur_map[last]
            if prev_total >= lower:
                good = group[:-1]
                chunks.append(Chunk(segments=good.copy()))
                idx = idx + len(good)
            else:
                chunks.append(Chunk(segments=group.copy(), trim_last=True, trim_duration_s=target - prev_total))
                idx = j
    return chunks


def _concat(paths: list[Path], trim_last: bool, trim_s: float | None) -> Audio | None:
    parts = []
    rate = None
    for i, p in enumerate(paths):
        try:
            a = read_wav(p).to_mono()
        except (FileNotFoundError, ValueError) as e:
            log.warning("skipping %s: %s", p, e)
            continue
        rate = rate or a.rate
        if trim_last and i == len(paths) - 1 and trim_s:
            a = a.slice_ms(0, trim_s * 1000)
        parts.append(np.asarray(a.samples))
    if not parts:
        return None
    return Audio(np.concatenate(parts), rate)


def prepare_ab_test(
    results_dir: str | Path,
    raw_data_dir: str | Path,
    out_dir: str | Path,
    voices: list[str] | None = None,
    num_pairs: int = 44,
    target_duration_s: float = 60.0,
    margin_s: float = 15.0,
    seed: int = 0,
) -> list[Chunk]:
    """Scan Out/results/<voice>/segmented_audio (improved) and
    Data/voice/<voice>_raw/audio (raw), build chunks per voice, sample,
    and export pairs."""
    results_dir, raw_data_dir, out_dir = Path(results_dir), Path(raw_data_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if voices is None:
        voices = [p.name for p in sorted(results_dir.iterdir()) if p.is_dir()]

    all_chunks: list[Chunk] = []
    imp_map: dict[str, dict[str, Path]] = {}
    raw_map: dict[str, dict[str, Path]] = {}
    for voice in voices:
        imp_dir = results_dir / voice / "segmented_audio"
        raw_dir = raw_data_dir / f"{voice}_raw" / "audio"
        if not imp_dir.is_dir() or not raw_dir.is_dir():
            continue
        imp_map[voice] = {p.stem: p for p in imp_dir.glob("segment_ph*.wav")}
        raw_map[voice] = {p.stem: p for p in raw_dir.glob("segment_ph*.wav")}
        stems = sorted(set(imp_map[voice]) & set(raw_map[voice]), key=idx_key)
        dur_map = {}
        for s in stems:
            try:
                dur_map[s] = read_wav(imp_map[voice][s]).duration_seconds
            except (ValueError, FileNotFoundError):
                continue
        for c in build_chunks(stems, dur_map, target_duration_s, margin_s):
            c.voice = voice
            all_chunks.append(c)

    rng = np.random.default_rng(seed)
    if len(all_chunks) > num_pairs:
        pick = rng.choice(len(all_chunks), size=num_pairs, replace=False)
        all_chunks = [all_chunks[i] for i in sorted(pick)]

    for idx, c in enumerate(all_chunks):
        folder = out_dir / f"{idx}-{c.voice}_{'-'.join(c.segments)}"
        folder.mkdir(parents=True, exist_ok=True)
        raw = _concat([raw_map[c.voice][s] for s in c.segments], c.trim_last, c.trim_duration_s)
        imp = _concat([imp_map[c.voice][s] for s in c.segments], c.trim_last, c.trim_duration_s)
        if raw is not None:
            write_wav(folder / "raw.wav", raw)
        if imp is not None:
            write_wav(folder / "improved.wav", imp)
    return all_chunks
