"""Praat TextGrid reading/writing (long and short text formats).

The reference uses the third-party ``textgrid`` package everywhere a word
tier is consumed or produced (Code/Preprocessing/gen_break_ssml.py:19-31,
Code/Aligners/use_whisper_timestamped.py:330-395, Code/audioPipeline.py:909).
This is a first-party implementation of the subset the pipeline needs:
interval tiers with (minTime, maxTime, mark), tolerant parsing of both the
"long" (``intervals [1]:``) and "short" formats, and long-format output that
Praat and the reference's downstream tooling accept.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class Interval:
    min_time: float
    max_time: float
    mark: str

    @property
    def duration(self) -> float:
        return self.max_time - self.min_time


@dataclass
class IntervalTier:
    name: str
    min_time: float = 0.0
    max_time: float = 0.0
    intervals: list[Interval] = field(default_factory=list)

    def add(self, min_time: float, max_time: float, mark: str) -> None:
        self.intervals.append(Interval(min_time, max_time, mark))
        self.max_time = max(self.max_time, max_time)

    def __iter__(self):
        return iter(self.intervals)

    def __len__(self):
        return len(self.intervals)


@dataclass
class TextGrid:
    min_time: float = 0.0
    max_time: float = 0.0
    tiers: list[IntervalTier] = field(default_factory=list)

    def append(self, tier: IntervalTier) -> None:
        self.tiers.append(tier)
        self.max_time = max(self.max_time, tier.max_time)

    def __getitem__(self, i: int) -> IntervalTier:
        return self.tiers[i]


_QUOTED = re.compile(r'"((?:[^"]|"")*)"')
_NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?")


def _unquote(s: str) -> str:
    return s.replace('""', '"')


def read_textgrid(path: str | Path) -> TextGrid:
    """Parse a TextGrid file (long or short format, UTF-8/UTF-16 tolerant)."""
    raw = Path(path).read_bytes()
    if raw[:2] in (b"\xff\xfe", b"\xfe\xff"):
        text = raw.decode("utf-16")
    else:
        text = raw.decode("utf-8-sig", errors="replace")

    # Drop bracketed indices ("item [1]:", "intervals [12]:") so the only
    # bare numbers left are meaningful values; then the long and short
    # formats share the same token stream.
    text = re.sub(r"\[\s*\d*\s*\]", "", text)
    tokens: list[tuple[str, str]] = []  # (kind, value); kind in {"s","n"}
    i = 0
    while i < len(text):
        ch = text[i]
        if ch == '"':
            m = _QUOTED.match(text, i)
            if not m:
                raise ValueError(f"{path}: unterminated string at offset {i}")
            tokens.append(("s", _unquote(m.group(1))))
            i = m.end()
        elif ch.isdigit() or (ch == "-" and i + 1 < len(text) and text[i + 1].isdigit()):
            m = _NUMBER.match(text, i)
            tokens.append(("n", m.group(0)))
            i = m.end()
        else:
            i += 1

    # Expected stream: "ooTextFile" "TextGrid" xmin xmax [exists flag] size
    # then per tier: "IntervalTier"|"TextTier" name xmin xmax n
    # then per interval: xmin xmax "mark"   (points: time "mark").
    pos = 0

    def next_tok(kind: str) -> str:
        nonlocal pos
        while pos < len(tokens) and tokens[pos][0] != kind:
            pos += 1
        if pos >= len(tokens):
            raise ValueError(f"{path}: truncated TextGrid")
        val = tokens[pos][1]
        pos += 1
        return val

    header_type = next_tok("s")  # ooTextFile
    obj_class = next_tok("s")  # TextGrid
    if "TextGrid" not in obj_class and "TextGrid" not in header_type:
        raise ValueError(f"{path}: not a TextGrid (class={obj_class!r})")
    xmin = float(next_tok("n"))
    xmax = float(next_tok("n"))
    ntiers = int(float(next_tok("n")))

    tg = TextGrid(min_time=xmin, max_time=xmax)
    for _ in range(ntiers):
        tier_class = next_tok("s")
        tier_name = next_tok("s")
        t_min = float(next_tok("n"))
        t_max = float(next_tok("n"))
        count = int(float(next_tok("n")))
        tier = IntervalTier(tier_name, t_min, t_max)
        if "IntervalTier" in tier_class:
            for _ in range(count):
                i0 = float(next_tok("n"))
                i1 = float(next_tok("n"))
                mark = next_tok("s")
                tier.intervals.append(Interval(i0, i1, mark))
        else:  # point tier: store as zero-length intervals
            for _ in range(count):
                t = float(next_tok("n"))
                mark = next_tok("s")
                tier.intervals.append(Interval(t, t, mark))
        tg.tiers.append(tier)
    return tg


def _q(s: str) -> str:
    return '"' + s.replace('"', '""') + '"'


def write_textgrid(tg: TextGrid, path: str | Path) -> None:
    """Write long-format TextGrid (the format the reference's tools emit,
    Code/Aligners/use_whisper_timestamped.py:396-422)."""
    xmax = tg.max_time or max((t.max_time for t in tg.tiers), default=0.0)
    out = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        f"xmin = {tg.min_time:g}",
        f"xmax = {xmax:g}",
        "tiers? <exists>",
        f"size = {len(tg.tiers)}",
        "item []:",
    ]
    for ti, tier in enumerate(tg.tiers, start=1):
        out += [
            f"    item [{ti}]:",
            '        class = "IntervalTier"',
            f"        name = {_q(tier.name)}",
            f"        xmin = {tier.min_time:g}",
            f"        xmax = {tier.max_time or xmax:g}",
            f"        intervals: size = {len(tier.intervals)}",
        ]
        for ii, iv in enumerate(tier.intervals, start=1):
            out += [
                f"        intervals [{ii}]:",
                f"            xmin = {iv.min_time:.6f}",
                f"            xmax = {iv.max_time:.6f}",
                f"            text = {_q(iv.mark)}",
            ]
    Path(path).write_text("\n".join(out) + "\n", encoding="utf-8")


def word_tier_with_silences(
    words: list[tuple[float, float, str]], total_duration: float, name: str = "words"
) -> TextGrid:
    """Build a word IntervalTier with explicit silence ("") intervals filling
    the gaps — the TextGrid shape the whole pipeline consumes
    (Code/Aligners/use_whisper_timestamped.py:330-395: words + "" silences).
    """
    tier = IntervalTier(name, 0.0, total_duration)
    cursor = 0.0
    for start, end, text in sorted(words, key=lambda w: w[0]):
        start = max(start, cursor)
        end = max(end, start)
        if start > cursor + 1e-9:
            tier.intervals.append(Interval(cursor, start, ""))
        if end > start:
            tier.intervals.append(Interval(start, end, text))
        cursor = max(cursor, end)
    if total_duration > cursor + 1e-9:
        tier.intervals.append(Interval(cursor, total_duration, ""))
    tg = TextGrid(0.0, total_duration)
    tg.append(tier)
    return tg
