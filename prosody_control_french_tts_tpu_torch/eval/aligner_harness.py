"""Aligner-accuracy harness vs gold TextGrids.

Parity with Code/whisper_testing/splitting.py:94-252: align predicted word
intervals to manually-labelled gold intervals by text similarity, then
report boundary error (start/end), duration error, and aggregate stats at
three levels — entire file, fixed windows, sentence groups. Also covers
the Audacity gold-label workflow (word_level.py): import/export of
``start\tend\tword`` label files.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..utils.text import normalize_word, similarity_ratio
from ..utils.textgridio import TextGrid, read_textgrid


@dataclass
class WordInterval:
    start: float
    end: float
    word: str


def words_of(tg: TextGrid | str) -> list[WordInterval]:
    if isinstance(tg, (str, Path)):
        tg = read_textgrid(tg)
    return [WordInterval(iv.min_time, iv.max_time, iv.mark.strip()) for iv in tg.tiers[0] if iv.mark.strip()]


def textgrid_to_transcript(tg: TextGrid | str, normalize_spelling: bool = True) -> str:
    """Gold transcript from a (manually corrected) TextGrid
    (Code/whisper_testing/textgrid_to_transcript.py:13 —
    spelling normalisation here is whitespace/ellipsis cleanup; the
    reference's spaCy pass corrected casing variants)."""
    words = [w.word for w in words_of(tg)]
    text = " ".join(words)
    if normalize_spelling:
        text = text.replace("...", ".").replace("  ", " ").strip()
    return text


def read_audacity_labels(path: str | Path) -> list[WordInterval]:
    """Audacity label track (word_level.py:4-77 export format)."""
    out = []
    for line in Path(path).read_text(encoding="utf-8").splitlines():
        parts = line.split("\t")
        if len(parts) >= 3:
            out.append(WordInterval(float(parts[0]), float(parts[1]), parts[2].strip()))
    return out


def write_audacity_labels(words: list[WordInterval], path: str | Path) -> None:
    Path(path).write_text(
        "".join(f"{w.start:.6f}\t{w.end:.6f}\t{w.word}\n" for w in words), encoding="utf-8"
    )


def match_words(pred: list[WordInterval], gold: list[WordInterval], max_shift: int = 3):
    """Monotonic greedy text matching with a ±max_shift search window
    (splitting.py text-similarity interval alignment)."""
    matches: list[tuple[WordInterval, WordInterval]] = []
    gi = 0
    for p in pred:
        best = None
        best_score = 0.55  # minimum similarity to accept
        for k in range(gi, min(gi + 1 + max_shift, len(gold))):
            s = similarity_ratio(normalize_word(p.word), normalize_word(gold[k].word))
            if s > best_score:
                best, best_score = k, s
                if s == 1.0:
                    break
        if best is not None:
            matches.append((p, gold[best]))
            gi = best + 1
    return matches


@dataclass
class AlignStats:
    n_matched: int
    n_pred: int
    n_gold: int
    start_err_mean: float
    start_err_median: float
    end_err_mean: float
    duration_err_mean: float
    within_50ms: float
    within_100ms: float
    extra: dict = field(default_factory=dict)

    @classmethod
    def from_matches(cls, matches, n_pred: int, n_gold: int) -> "AlignStats":
        if not matches:
            return cls(0, n_pred, n_gold, 0, 0, 0, 0, 0, 0)
        se = np.array([abs(p.start - g.start) for p, g in matches])
        ee = np.array([abs(p.end - g.end) for p, g in matches])
        de = np.array([abs((p.end - p.start) - (g.end - g.start)) for p, g in matches])
        return cls(
            n_matched=len(matches),
            n_pred=n_pred,
            n_gold=n_gold,
            start_err_mean=float(se.mean()),
            start_err_median=float(np.median(se)),
            end_err_mean=float(ee.mean()),
            duration_err_mean=float(de.mean()),
            within_50ms=float((se <= 0.05).mean()),
            within_100ms=float((se <= 0.10).mean()),
        )


def evaluate_alignment(
    pred: list[WordInterval] | TextGrid | str,
    gold: list[WordInterval] | TextGrid | str,
    window_s: float = 30.0,
) -> dict[str, object]:
    """Three-level report: entire / fixed windows / sentences
    (splitting.py:171-252 structure)."""
    if not isinstance(pred, list):
        pred = words_of(pred)
    if not isinstance(gold, list):
        gold = words_of(gold)
    matches = match_words(pred, gold)
    entire = AlignStats.from_matches(matches, len(pred), len(gold))

    # fixed windows by gold start time
    windows: dict[int, list] = {}
    for p, g in matches:
        windows.setdefault(int(g.start // window_s), []).append((p, g))
    window_stats = {
        w: AlignStats.from_matches(m, len(m), len(m)) for w, m in sorted(windows.items())
    }

    # sentence groups: split gold at words ending with sentence punctuation
    sentences: list[list] = [[]]
    matched_gold = {id(g) for _, g in matches}
    pair_of = {id(g): (p, g) for p, g in matches}
    for g in gold:
        if id(g) in matched_gold:
            sentences[-1].append(pair_of[id(g)])
        if g.word.endswith((".", "?", "!")):
            sentences.append([])
    sentence_stats = [
        AlignStats.from_matches(s, len(s), len(s)) for s in sentences if s
    ]

    return {"entire": entire, "windows": window_stats, "sentences": sentence_stats}
