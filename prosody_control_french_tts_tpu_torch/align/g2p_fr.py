"""Rule-based French grapheme→phoneme conversion + lexicon enrichment.

Fills the role of the reference's MFA-dictionary enricher
(Code/Aligners/enrichir_dictionnaire.py:24-31, :42-76): collect the
corpus's words, find the ones missing from a pronunciation lexicon, and
append a phonetic transcription for each. The reference shells out to
eSpeak for the G2P step; this framework is hermetic, so the G2P is a
deterministic longest-match rule engine over French orthography — no
subprocess, no downloads, and the same output on every host.

The phone inventory is IPA-ish (one symbol per phoneme) so lexicon files
stay human-readable. `PhonemeVocab` exposes the same surface as
`ctc_aligner.CharVocab`, making phoneme-target CTC training/alignment a
drop-in: ``CTCAligner(vocab=PhonemeVocab())``.

Rules cover the regular core of French orthography (digraphs, nasal
vowels, c/g softening, silent finals). Irregulars (e.g. "monsieur",
"femme") belong in the lexicon, which always wins over G2P — exactly the
reference's lexicon-first, G2P-for-OOV design.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass, field
from pathlib import Path

# -------------------------------------------------------------------------
# Phone inventory (NFC IPA strings; one list entry per phoneme)

VOWELS_ORAL = ["a", "e", "ɛ", "i", "o", "ɔ", "u", "y", "ø", "œ", "ə"]
VOWELS_NASAL = ["ɑ̃", "ɛ̃", "ɔ̃", "œ̃"]
GLIDES = ["j", "w", "ɥ"]
CONSONANTS = ["b", "d", "f", "ɡ", "k", "l", "m", "n", "ɲ", "p", "ʁ", "s", "ʃ", "t", "v", "z", "ʒ"]
PHONES = VOWELS_ORAL + VOWELS_NASAL + GLIDES + CONSONANTS

_VOWEL_LETTERS = "aeiouyàâäéèêëîïôöùûüÿœ"

# -------------------------------------------------------------------------
# Rule table: ordered (regex, phones) tried at the current position;
# longest/most-specific patterns first. `(?=...)` lookaheads encode context
# without consuming it. `$` anchors only match at true word end.

_RULES: list[tuple[re.Pattern, list[str]]] = [
    (re.compile(p), ph)
    for p, ph in [
        # --- multi-letter vowel + nasal clusters (longest first) ---
        (r"eaux?$", ["o"]),
        (r"eau", ["o"]),
        (r"aux?$", ["o"]),
        (r"au", ["o"]),
        (r"oin", ["w", "ɛ̃"]),
        (r"ouill", ["u", "j"]),
        (r"euill?|ueill?", ["œ", "j"]),
        (r"aill|ails?$", ["a", "j"]),
        (r"eill|eils?$", ["ɛ", "j"]),
        (r"ill", ["i", "j"]),
        (r"ien(?=[bcdfgjklpqstvxz]|$)", ["j", "ɛ̃"]),
        (r"tion$|tions$", ["s", "j", "ɔ̃"]),
        (r"oy(?=[" + _VOWEL_LETTERS + "])", ["w", "a", "j"]),
        (r"oi", ["w", "a"]),
        (r"ou(?=[" + _VOWEL_LETTERS + "])", ["w"]),
        (r"où|oû|ou", ["u"]),
        (r"(ain|aim|ein|eim)(?=[bcdfgjklmnpqrstvxz]|$)", ["ɛ̃"]),
        (r"(an|am|en|em)(?=[bcdfghjklpqrstvxz]|$)", ["ɑ̃"]),
        (r"(in|im|yn|ym)(?=[bcdfghjklpqrstvxz]|$)", ["ɛ̃"]),
        (r"(on|om)(?=[bcdfghjklpqrstvxz]|$)", ["ɔ̃"]),
        (r"(un|um)(?=[bcdfghjklpqrstvxz]|$)", ["œ̃"]),
        (r"ay(?=[" + _VOWEL_LETTERS + "])", ["ɛ", "j"]),
        (r"ai|ei|ay$", ["ɛ"]),
        (r"(eu|œu)x?$", ["ø"]),
        (r"eu|œu|œ", ["ø"]),
        (r"ui", ["ɥ", "i"]),
        # --- consonant digraphs ---
        (r"ch", ["ʃ"]),
        (r"ph", ["f"]),
        (r"th", ["t"]),
        (r"gn", ["ɲ"]),
        (r"qu", ["k"]),
        (r"gu(?=[eiéèêëiîy])", ["ɡ"]),
        (r"ge(?=[aou])", ["ʒ"]),  # mangeons
        (r"ss", ["s"]),
        (r"sc(?=[eiéèêy])", ["s"]),
        (r"cc(?=[eiéèêy])", ["k", "s"]),
        (r"x(?=[cpqst])", ["k", "s"]),  # expert
        # --- single letters with context ---
        (r"c(?=[eiéèêëîïy])", ["s"]),
        (r"ç", ["s"]),
        (r"c", ["k"]),
        (r"g(?=[eiéèêëîïy])", ["ʒ"]),
        (r"g", ["ɡ"]),
        (r"j", ["ʒ"]),
        (r"h", []),  # silent
        (r"y(?=[" + _VOWEL_LETTERS + "])", ["j"]),
        (r"y", ["i"]),
        (r"ies?$", ["i"]),  # final -ie(s): "philosophie" → …f i
        (r"i(?=[" + _VOWEL_LETTERS + "])", ["j"]),  # bien, nation handled above
        (r"(er|ez|ed)$", ["e"]),
        (r"é", ["e"]),
        (r"[èêë]", ["ɛ"]),
        (r"e(?=tt|ll|ss|rr|nn|mm|[cflr]$|[bcdfgklprstvx][bcdfgklmnprstvx])", ["ɛ"]),
        (r"es$", []),  # silent plural/verb ending ("tables")
        (r"e$", []),  # final schwa dropped (restored below for "le","que"…)
        (r"e", ["ə"]),
        (r"[àâä]", ["a"]),
        (r"a", ["a"]),
        (r"[îï]", ["i"]),
        (r"i", ["i"]),
        (r"[ôö]", ["o"]),
        (r"o(?=[bcdfgjklmnpqrstvxz]e?$)", ["ɔ"]),  # closed syllable: "botte"→ɔ
        (r"o", ["o"]),
        (r"[ùûü]", ["y"]),
        (r"u", ["y"]),
        (r"s(?=$)", []),  # silent final s
        (r"x(?=$)", []),
        (r"z(?=$)", []),
        (r"[tdp](?=$)", []),  # silent final t/d/p ("chat", "grand")
        (r"b", ["b"]),
        (r"d", ["d"]),
        (r"f", ["f"]),
        (r"k", ["k"]),
        (r"l", ["l"]),
        (r"m", ["m"]),
        (r"n", ["n"]),
        (r"p", ["p"]),
        (r"r", ["ʁ"]),
        (r"t", ["t"]),
        (r"v", ["v"]),
        (r"w", ["w"]),
        (r"x", ["k", "s"]),
        (r"z", ["z"]),
        (r"s", ["s"]),  # generic s (intervocalic handled in g2p_word)
        (r"'|-|’", []),
    ]
]


def g2p_word_spans(word: str) -> list[tuple[int, int, list[str]]]:
    """Like ``g2p_word`` but keeps the letter provenance: a list of
    (char_start, char_end, phones) over the NFC-normalized lowercased word,
    in scan order (``g2p_word`` is exactly the concatenation of the phone
    lists — it delegates here, so the two can never drift). Used by the
    formant synthesizer to map phoneme timing back to character spans."""
    w = unicodedata.normalize("NFC", word.lower().strip())
    out: list[tuple[int, int, list[str]]] = []
    i = 0
    while i < len(w):
        # intervocalic s → z (but not ss, handled earlier in rules scan)
        if (
            w[i] == "s"
            and 0 < i < len(w) - 1
            and w[i - 1] in _VOWEL_LETTERS
            and w[i + 1] in _VOWEL_LETTERS
        ):
            out.append((i, i + 1, ["z"]))
            i += 1
            continue
        for rx, phones in _RULES:
            m = rx.match(w, i)
            if m:
                j = max(m.end(), i + 1)
                out.append((i, j, list(phones)))
                i = j
                break
        else:
            out.append((i, i + 1, []))
            i += 1  # unknown char: skip
    # French has no phonemic geminates: collapse doubled consonants
    # ("guerre" → ɡ ɛ ʁ, "belle" → b ɛ l)
    last: str | None = None
    for _, _, phones in out:
        k = 0
        while k < len(phones):
            if last == phones[k] and phones[k] in CONSONANTS:
                del phones[k]
                continue
            last = phones[k]
            k += 1
    # monosyllabic clitics ("le", "que"): the final e IS pronounced — restore
    # the schwa when dropping it left the word without any vowel
    vowels = set(VOWELS_ORAL + VOWELS_NASAL)
    flat = [p for _, _, ph in out for p in ph]
    if w.endswith("e") and flat and not any(p in vowels for p in flat):
        out.append((len(w) - 1, len(w), ["ə"]))
        flat.append("ə")
    if not flat and w:  # never return empty for a non-empty word
        out.append((0, len(w), ["ə"]))
    return out


def g2p_word(word: str) -> list[str]:
    """Phoneme list for one French word (lowercased, NFC-normalized).

    Deterministic longest-match scan over `_RULES`; intervocalic single
    ``s`` voiced to /z/ ("maison" → m ɛ z ɔ̃). Unknown characters are
    dropped (the reference's eSpeak call is similarly total —
    enrichir_dictionnaire.py:24-31 never fails a word).
    """
    return [p for _, _, phones in g2p_word_spans(word) for p in phones]


# -------------------------------------------------------------------------
# Lexicon I/O + enrichment (the reference's add_missing_words flow)


def load_lexicon(path: str | Path) -> dict[str, list[str]]:
    """``word PHONE PHONE…`` per line (MFA-style); later entries win."""
    lex: dict[str, list[str]] = {}
    p = Path(path)
    if not p.exists():
        return lex
    for line in p.read_text(encoding="utf-8").splitlines():
        parts = line.split()
        if len(parts) >= 2:
            lex[parts[0].lower()] = parts[1:]
    return lex


def extract_words(texts: list[str]) -> set[str]:
    """Unique lowercase ``\\b\\w+\\b`` tokens — the reference's
    extract_words_from_text (enrichir_dictionnaire.py:46-51)."""
    words: set[str] = set()
    for t in texts:
        words.update(m.group(0).lower() for m in re.finditer(r"\b\w+\b", t, re.UNICODE))
    return words


def enrich_lexicon(words: set[str], lexicon: dict[str, list[str]]) -> dict[str, list[str]]:
    """G2P every word missing from `lexicon`; returns only the new entries
    (the reference appends them to the MFA dict, :54-58)."""
    return {w: g2p_word(w) for w in sorted(words) if w not in lexicon and w.strip()}


def enrich_lexicon_file(transcription_dir: str | Path, lexicon_path: str | Path) -> int:
    """End-to-end enrichment: read every ``*.txt`` under `transcription_dir`,
    append G2P entries for OOV words to `lexicon_path`. Returns the number
    of words added. Mirrors enrichir_dictionnaire.main (:42-76)."""
    texts = [p.read_text(encoding="utf-8") for p in sorted(Path(transcription_dir).glob("*.txt"))]
    lex = load_lexicon(lexicon_path)
    new = enrich_lexicon(extract_words(texts), lex)
    if new:
        with open(lexicon_path, "a", encoding="utf-8") as f:
            for w, phones in new.items():
                f.write(f"{w} {' '.join(phones)}\n")
    return len(new)


# -------------------------------------------------------------------------
# Phoneme CTC vocab — drop-in for ctc_aligner.CharVocab


@dataclass
class PhonemeVocab:
    """Phoneme-target vocab for `CTCAligner`: same surface as CharVocab
    (blank/__len__/encode/word_spans) but labels are G2P phonemes plus a
    word-boundary token. A lexicon (exceptions) overrides G2P per word."""

    lexicon: dict[str, list[str]] = field(default_factory=dict)
    phones: tuple[str, ...] = tuple(PHONES)

    def __post_init__(self):
        self._index = {p: i + 2 for i, p in enumerate(self.phones)}  # 0=blank, 1=boundary

    @property
    def blank(self) -> int:
        return 0

    @property
    def boundary(self) -> int:
        return 1

    def __len__(self) -> int:
        return len(self.phones) + 2

    def phones_for(self, word: str) -> list[str]:
        w = word.lower()
        return list(self.lexicon.get(w, ()) or g2p_word(w))

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for i, w in enumerate(text.split()):
            if i > 0:
                ids.append(self.boundary)
            ids.extend(self._index[p] for p in self.phones_for(w) if p in self._index)
        return ids

    def word_spans(self, words: list[str]) -> tuple[list[int], list[tuple[int, int]]]:
        labels: list[int] = []
        spans: list[tuple[int, int]] = []
        for i, w in enumerate(words):
            if i > 0:
                labels.append(self.boundary)
            start = len(labels)
            labels.extend(self._index[p] for p in self.phones_for(w) if p in self._index)
            spans.append((start, len(labels)))
        return labels, spans
