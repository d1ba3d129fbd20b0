"""Greedy Levenshtein merge of two TextGrids onto a shared word sequence.

Reimplements Code/Aligners/levenshtein_dist_align_txtgrids.py:98-163: walk
both word tiers in parallel; exact/close matches pass through, mismatches
resolve by edit distance (the closer word wins for both), and leftovers are
dropped — so natural and synthetic tiers end with identical word sequences
(the precondition for the Needleman-Wunsch CSV chain).
"""

from __future__ import annotations

from ..utils.text import levenshtein, normalize_word
from ..utils.textgridio import Interval, IntervalTier, TextGrid


def _words(tg: TextGrid) -> list[Interval]:
    return [iv for iv in tg.tiers[0] if iv.mark.strip()]


def merge_textgrids(tg_a: TextGrid, tg_b: TextGrid) -> tuple[TextGrid, TextGrid, list[str]]:
    """Returns rebuilt (tg_a', tg_b', shared_words). Timings are kept from
    each grid's own intervals; only the marks are reconciled."""
    wa, wb = _words(tg_a), _words(tg_b)
    ia = ib = 0
    out_a: list[Interval] = []
    out_b: list[Interval] = []
    shared: list[str] = []
    while ia < len(wa) and ib < len(wb):
        a, b = wa[ia], wb[ib]
        na, nb = normalize_word(a.mark), normalize_word(b.mark)
        if na == nb:
            out_a.append(a)
            out_b.append(b)
            shared.append(a.mark)
            ia += 1
            ib += 1
            continue
        # try skipping one word on either side; keep the cheaper repair
        skip_a = levenshtein(normalize_word(wa[ia + 1].mark), nb) if ia + 1 < len(wa) else 1e9
        skip_b = levenshtein(na, normalize_word(wb[ib + 1].mark)) if ib + 1 < len(wb) else 1e9
        subst = levenshtein(na, nb)
        if subst <= min(skip_a, skip_b):
            # substitution: keep the natural (a) spelling for both
            out_a.append(a)
            out_b.append(Interval(b.min_time, b.max_time, a.mark))
            shared.append(a.mark)
            ia += 1
            ib += 1
        elif skip_a < skip_b:
            ia += 1  # drop the unmatched natural word
        else:
            ib += 1
    return _rebuild(tg_a, out_a), _rebuild(tg_b, out_b), shared


def _rebuild(tg: TextGrid, words: list[Interval]) -> TextGrid:
    total = tg.max_time or (words[-1].max_time if words else 0.0)
    tier = IntervalTier(tg.tiers[0].name, 0.0, total)
    cursor = 0.0
    for iv in words:
        if iv.min_time > cursor + 1e-9:
            tier.intervals.append(Interval(cursor, iv.min_time, ""))
        tier.intervals.append(Interval(max(cursor, iv.min_time), iv.max_time, iv.mark))
        cursor = iv.max_time
    if total > cursor + 1e-9:
        tier.intervals.append(Interval(cursor, total, ""))
    out = TextGrid(0.0, total)
    out.append(tier)
    return out
