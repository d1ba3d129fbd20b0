"""Needleman-Wunsch global alignment of word-segment rows.

Reimplements Code/Pipeline/NeedlemanWunschAlignement.py:27-78 (match +1,
mismatch −1, gap −1, gap rows ('-', '', 0, 0, 0)) — the legacy BDD chain's
aligner between natural and synthetic per-interval CSVs. Kept host-side
(tiny inputs); ``ops.dtw`` on the device covers the eval-scale alignments.
"""

from __future__ import annotations

from typing import Sequence


def needleman_wunsch(
    a: Sequence[str], b: Sequence[str], match: int = 1, mismatch: int = -1, gap: int = -1
) -> list[tuple[str | None, str | None]]:
    """Returns aligned pairs; None marks a gap on that side."""
    n, m = len(a), len(b)
    score = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        score[i][0] = score[i - 1][0] + gap
    for j in range(1, m + 1):
        score[0][j] = score[0][j - 1] + gap
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            diag = score[i - 1][j - 1] + (match if a[i - 1] == b[j - 1] else mismatch)
            up = score[i - 1][j] + gap
            left = score[i][j - 1] + gap
            score[i][j] = max(diag, up, left)
    out: list[tuple[str | None, str | None]] = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and score[i][j] == score[i - 1][j - 1] + (
            match if a[i - 1] == b[j - 1] else mismatch
        ):
            out.append((a[i - 1], b[j - 1]))
            i -= 1
            j -= 1
        elif i > 0 and score[i][j] == score[i - 1][j] + gap:
            out.append((a[i - 1], None))
            i -= 1
        else:
            out.append((None, b[j - 1]))
            j -= 1
    out.reverse()
    return out
