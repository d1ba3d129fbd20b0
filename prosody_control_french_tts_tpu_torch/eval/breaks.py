"""Pause-fidelity comparison: expected SSML breaks vs measured silences.

Reimplements Code/audioPipeline.py:895-1074: group the final TextGrid into
speech blocks + trailing silences, fuzzy-align CSV speech chunks to blocks
by maximum total similarity (DP over SequenceMatcher ratios), then compare
each expected pause against the silence after its block.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

from ..utils.text import normalize_phrase, similarity_ratio
from ..utils.textgridio import TextGrid

_HAS_WORD = re.compile(r"\w")


@dataclass
class BreakReport:
    rows: list[dict] = field(default_factory=list)
    total: int = 0
    within: int = 0
    avg_abs_diff: float = 0.0
    avg_match_quality: float = 0.0


def _sim(a: str, b: str) -> float:
    return similarity_ratio(normalize_phrase(a), normalize_phrase(b))


def compare_breaks(csv_rows: list[dict], out_tg: TextGrid, tol_ms: int = 5) -> BreakReport:
    # 1) TextGrid → speech chunks + following silence (:909-933)
    intervals = [(iv.min_time, iv.max_time, iv.mark.strip()) for iv in out_tg.tiers[0]]
    tg_speech: list[str] = []
    silence_after: list[int] = []
    idx = 0
    while idx < len(intervals):
        _, _, mark = intervals[idx]
        if mark:
            words = []
            while idx < len(intervals) and intervals[idx][2].strip():
                words.append(intervals[idx][2])
                idx += 1
            tg_speech.append(" ".join(words))
            if idx < len(intervals) and not intervals[idx][2].strip():
                s0, s1, _ = intervals[idx]
                silence_after.append(int(round((s1 - s0) * 1000)))
                idx += 1
            else:
                silence_after.append(0)
        else:
            idx += 1

    # 2) CSV speech rows + break events (:935-962)
    csv_speech: list[dict] = []
    seq_to_speech_idx: dict[int, int] = {}
    for i, row in enumerate(csv_rows):
        txt = (row.get("syntagme") or "").strip()
        if _HAS_WORD.search(txt):
            seq_to_speech_idx[i] = len(csv_speech)
            csv_speech.append({"csv_idx": i, "text": txt, "segment": row["segment"]})

    break_events = []
    for i, row in enumerate(csv_rows):
        txt = (row.get("syntagme") or "").strip()
        if not txt and i > 0 and _HAS_WORD.search((csv_rows[i - 1].get("syntagme") or "")):
            sp = seq_to_speech_idx.get(i - 1)
            if sp is not None:
                break_events.append(
                    {
                        "speech_idx": sp,
                        "expected_ms": int(round(float(row.get("pause", 0) or 0))),
                        "segment": row["segment"],
                        "text": (csv_rows[i - 1].get("syntagme") or "").strip(),
                    }
                )

    # 3) DP alignment csv_speech → tg_speech (:964-999)
    n, m = len(csv_speech), len(tg_speech)
    dp = [[0.0] * (m + 1) for _ in range(n + 1)]
    prev = [[None] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            match_score = dp[i - 1][j - 1] + _sim(csv_speech[i - 1]["text"], tg_speech[j - 1])
            if dp[i - 1][j] >= dp[i][j - 1] and dp[i - 1][j] >= match_score:
                dp[i][j] = dp[i - 1][j]
                prev[i][j] = (i - 1, j)
            elif dp[i][j - 1] >= match_score:
                dp[i][j] = dp[i][j - 1]
                prev[i][j] = (i, j - 1)
            else:
                dp[i][j] = match_score
                prev[i][j] = (i - 1, j - 1)

    matches = []
    i, j = n, m
    while i > 0 and j > 0:
        pi, pj = prev[i][j]
        if pi == i - 1 and pj == j - 1:
            matches.append((i - 1, j - 1))
        i, j = pi, pj
    matches.reverse()
    speech_to_tg = dict(matches)

    # 3a) extended spans (:1001-1009)
    match_list = sorted(speech_to_tg.items())
    match_list.append((len(csv_speech), len(tg_speech)))
    ext_span: dict[int, list[int]] = {}
    for k in range(len(match_list) - 1):
        csv_i, tg_i = match_list[k]
        next_csv, next_tg = match_list[k + 1]
        for ci in range(csv_i, next_csv):
            ext_span[ci] = list(range(tg_i, next_tg))

    # 4) break event → last TG index of its span (:1011-1026)
    event_tg = []
    for ev in break_events:
        span = ext_span.get(ev["speech_idx"], [])
        if span:
            event_tg.append(span[-1])
        else:
            event_tg.append(speech_to_tg.get(ev["speech_idx"]))
    tg_to_events = defaultdict(list)
    for k, tg_idx in enumerate(event_tg):
        if tg_idx is not None:
            tg_to_events[tg_idx].append(k)

    # 5) result rows (:1028-1074)
    rows = []
    for k, ev in enumerate(break_events):
        tg_idx = event_tg[k]
        if tg_idx is not None and k == tg_to_events[tg_idx][-1] and tg_idx < len(silence_after):
            synth_ms = silence_after[tg_idx]
        else:
            synth_ms = 0
        diff = synth_ms - ev["expected_ms"]
        mq = _sim(ev["text"], tg_speech[tg_idx]) if tg_idx is not None and tg_idx < len(tg_speech) else 0.0
        rows.append(
            {
                "segment": ev["segment"],
                "syntagme": ev["text"],
                "nat_voice_ms": ev["expected_ms"],
                "synth_voice_ms": synth_ms,
                "diff_ms": diff,
                "ok": abs(diff) <= tol_ms,
                "match_quality": round(mq, 2),
            }
        )

    report = BreakReport(rows=rows, total=len(rows))
    if rows:
        report.within = sum(1 for r in rows if r["ok"])
        report.avg_abs_diff = sum(abs(r["diff_ms"]) for r in rows) / len(rows)
        report.avg_match_quality = sum(r["match_quality"] for r in rows) / len(rows)
    return report
