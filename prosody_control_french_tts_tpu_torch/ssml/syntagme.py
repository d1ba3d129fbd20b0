"""Syntagme (pause-delimited word group) construction from aligned words.

Reimplements, against our TextGrid model, the reference's sequence
processing chain inside ``measure_prosody_and_build_ssml``:

- ``extract_words_and_pauses``  (Code/Preprocessing/gen_break_ssml.py:12-42)
- function-word pause filter    (Code/audioPipeline.py:451-465)
- sentence-end pause injection  (Code/audioPipeline.py:470-489)
- ``construct_syntagmes_seq``   (Code/audioPipeline.py:265-311)

All of this is variable-length token bookkeeping — host-side by design;
the numeric work on the resulting [start, end) windows runs on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

from ..utils import fr_pos
from ..utils.text import ends_sentence
from ..utils.textgridio import TextGrid, read_textgrid

# thresholds from Code/Preprocessing/gen_break_ssml.py:9-10
INITIAL_PAUSE_THRESHOLD_MS = 150
MIN_PAUSE_THRESHOLD_MS = 150

SeqItem = tuple[str, str | None, int]  # (kind, token, duration_ms)


@dataclass
class Syntagme:
    """One pause-delimited word group (or a pure pause).

    words == "" ⇒ pure pause of ``pause_ms`` (the reference represents
    pauses as their own syntagme rows, Code/audioPipeline.py:293-299).
    """

    words: str
    start_ms: int
    end_ms: int
    pause_ms: int = 0

    @property
    def is_pause(self) -> bool:
        return not self.words

    @property
    def word_count(self) -> int:
        return len(self.words.split()) if self.words else 0


def extract_words_and_pauses(tg: TextGrid | str) -> list[SeqItem]:
    """TextGrid word tier → [(kind, token, duration_ms)].

    Matches gen_break_ssml.extract_words_and_pauses: ms via round(), empty
    marks are pauses, initial pauses under 150 ms are dropped until the
    first word appears.
    """
    if isinstance(tg, str):
        tg = read_textgrid(tg)
    tier = tg.tiers[0]
    seq: list[SeqItem] = []
    ignore_initial_pause = True
    for iv in tier.intervals:
        text = iv.mark.strip()
        dur = round(iv.max_time * 1000) - round(iv.min_time * 1000)
        if not text:
            if not ignore_initial_pause or dur >= INITIAL_PAUSE_THRESHOLD_MS:
                seq.append(("pause", None, dur))
        else:
            seq.append(("word", text, dur))
            ignore_initial_pause = False
    return seq


def filter_function_word_pauses(
    seq: Sequence[SeqItem], pos_of: Callable[[str], str] = fr_pos.first_token_pos
) -> list[SeqItem]:
    """Drop any pause directly following a DET/ADP/CCONJ/SCONJ/PART/PRON
    word (Code/audioPipeline.py:451-465 — note the reference also advances
    its prev pointer onto the *dropped pause*, so a word after a dropped
    pause is never itself treated as 'previous word'; replicated here).

    Sentence-aware ``pos_of`` callables (``ContextualTagger.make_pos_of``)
    accept a second ``word_index`` argument so repeated tokens resolve to
    the exact occurrence being queried, not the next token match."""
    import inspect

    try:
        accepts_index = len(inspect.signature(pos_of).parameters) >= 2
    except (TypeError, ValueError):
        accepts_index = False
    out: list[SeqItem] = []
    prev: SeqItem | None = None
    widx = -1  # index of the most recent word item among words only
    for item in seq:
        kind, tok, dur = item
        if kind == "word":
            widx += 1
        if kind == "pause" and prev is not None:
            pkind, ptok, _ = prev
            if pkind == "word":
                tag = (
                    pos_of(ptok.strip(), widx)
                    if accepts_index
                    else pos_of(ptok.strip())
                )
                if tag in fr_pos.FORBIDDEN:
                    prev = item
                    continue
        out.append(item)
        prev = item
    return out


def inject_punctuation_pauses(seq: Sequence[SeqItem], end_pause_ms: int) -> list[SeqItem]:
    """Bump pauses after sentence-final punctuation up to ``end_pause_ms``
    and inject one where missing (Code/audioPipeline.py:470-489)."""
    out: list[SeqItem] = []
    n = len(seq)
    for i, (kind, tok, dur) in enumerate(seq):
        if kind == "pause" and i > 0:
            pkind, ptok, _ = seq[i - 1]
            if pkind == "word" and ends_sentence(ptok):
                dur = max(dur, end_pause_ms)
        out.append((kind, tok, dur))
        if kind == "word" and ends_sentence(tok):
            if not (i + 1 < n and seq[i + 1][0] == "pause"):
                out.append(("pause", "", end_pause_ms))
    return out


def construct_syntagmes(seq: Sequence[SeqItem]) -> list[Syntagme]:
    """[(kind, tok, dur)] → syntagme list with a running time cursor
    (Code/audioPipeline.py:265-311): word runs accumulate into one
    syntagme; each pause closes the run and becomes its own row."""
    synts: list[Syntagme] = []
    cursor = 0
    current: list[str] = []
    start = 0
    for kind, tok, dur in seq:
        if kind == "word":
            if not current:
                start = cursor
            current.append(tok.strip())
            cursor += dur
        else:
            if current:
                synts.append(Syntagme(" ".join(current), start, cursor, 0))
                current = []
            synts.append(Syntagme("", cursor, cursor + dur, dur))
            cursor += dur
    if current:
        synts.append(Syntagme(" ".join(current), start, cursor, 0))
    return synts


def pipeline_syntagmes(
    tg: TextGrid | str,
    end_pause_ms: int,
    clean_word: Callable[[str], str] | None = None,
    pos_of: Callable[[str], str] = fr_pos.first_token_pos,
    pos_of_factory: Callable[[list[str]], Callable[[str], str]] | None = None,
) -> list[Syntagme]:
    """The full chain as the measure step runs it
    (Code/audioPipeline.py:441-492): extract → per-word comma cleanup →
    function-word pause filter → punctuation pauses → syntagmes.

    ``pos_of_factory`` (e.g. ``ContextualTagger.make_pos_of``) receives the
    cleaned word sequence and returns a sentence-aware ``pos_of`` — the
    contextual-POS hook; when None the per-token ``pos_of`` is used."""
    seq = extract_words_and_pauses(tg)
    if clean_word is not None:
        seq = [(k, clean_word(t) if k == "word" else t, d) for k, t, d in seq]
    if pos_of_factory is not None:
        pos_of = pos_of_factory([t for k, t, _ in seq if k == "word"])
    seq = filter_function_word_pauses(seq, pos_of)
    seq = inject_punctuation_pauses(seq, end_pause_ms)
    return construct_syntagmes(seq)


def align_natural_to_transcript(seq: Sequence[SeqItem], transcript_words: list[str]):
    """Greedy alignment of corrected-transcript words onto the natural
    (word, pause) sequence — gen_break_ssml.align_sequences:65-139.

    Returns [("word", w) | ("pause", ms)] for break-only SSML generation.
    """
    from ..utils.text import normalize_word

    natural_words = [t for k, t, _ in seq if k == "word"]
    norm_nat = [normalize_word(w) for w in natural_words]
    norm_syn = [normalize_word(w) for w in transcript_words]

    mappings: dict[int, int] = {}
    for si, sw in enumerate(norm_syn):
        best_idx, best_score = -1, 0.0
        for ni, nw in enumerate(norm_nat):
            if sw == nw:
                best_idx = ni
                break
            elif sw and nw and (sw in nw or nw in sw):
                score = min(len(sw), len(nw)) / max(len(sw), len(nw))
                if score > best_score:
                    best_score, best_idx = score, ni
        if best_idx >= 0:
            mappings[si] = best_idx

    word_to_seq: dict[int, int] = {}
    wi = 0
    for qi, item in enumerate(seq):
        if item[0] == "word":
            word_to_seq[wi] = qi
            wi += 1

    out: list[tuple[str, object]] = []
    for si, w in enumerate(transcript_words):
        out.append(("word", w))
        if si in mappings:
            qi = word_to_seq[mappings[si]]
            if qi + 1 < len(seq) and seq[qi + 1][0] == "pause":
                out.append(("pause", seq[qi + 1][2]))
    if seq and seq[-1][0] == "pause":
        out.append(("pause", seq[-1][2]))
    return out
