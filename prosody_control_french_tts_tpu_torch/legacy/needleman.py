"""Needleman-Wunsch alignment of natural vs synthesized interval rows.

Row-level counterpart of Code/Pipeline/NeedlemanWunschAlignement.py:27-84:
word-text match +1 / mismatch −1 / gap −1 over the two per-interval row
lists; gaps materialise as rows with the counterpart's timing and flags
(the reference's ('-','',0,0,0) rows)."""

from __future__ import annotations

from ..utils.text import normalize_word


def nw_align_rows(natural: list[dict], synthesized: list[dict]):
    from .bdd import SegmentRow

    na = [normalize_word(r["Text"]) for r in natural]
    sy = [normalize_word(r["Text"]) for r in synthesized]
    pairs = _align_with_indices(na, sy)

    out: list[SegmentRow] = []
    for ni, si in pairs:
        n = natural[ni] if ni is not None else None
        s = synthesized[si] if si is not None else None
        text = (n or s)["Text"]
        out.append(
            SegmentRow(
                file=(n or s)["PhraseID"],
                text=text,
                start=(n or s)["Start"],
                end=(n or s)["End"],
                natural_file=n.get("File") if n else None,
                synthesized_file=s.get("File") if s else None,
                begin_natural=n["Start"] if n else (s["Start"] if s else 0.0),
                end_natural=n["End"] if n else (s["Start"] if s else 0.0),
                begin_synthesized=s["Start"] if s else (n["Start"] if n else 0.0),
                end_synthesized=s["End"] if s else (n["Start"] if n else 0.0),
                is_gap_natural=n is None,
                is_gap_synthesized=s is None,
            )
        )
    return out


def _align_with_indices(a: list[str], b: list[str]):
    match, mismatch, gap = 1, -1, -1
    n, m = len(a), len(b)
    score = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        score[i][0] = score[i - 1][0] + gap
    for j in range(1, m + 1):
        score[0][j] = score[0][j - 1] + gap
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            diag = score[i - 1][j - 1] + (match if a[i - 1] == b[j - 1] else mismatch)
            score[i][j] = max(diag, score[i - 1][j] + gap, score[i][j - 1] + gap)
    out = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and score[i][j] == score[i - 1][j - 1] + (
            match if a[i - 1] == b[j - 1] else mismatch
        ):
            out.append((i - 1, j - 1))
            i -= 1
            j -= 1
        elif i > 0 and score[i][j] == score[i - 1][j] + gap:
            out.append((i - 1, None))
            i -= 1
        else:
            out.append((None, j - 1))
            j -= 1
    out.reverse()
    return out
