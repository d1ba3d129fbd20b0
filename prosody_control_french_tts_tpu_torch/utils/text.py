"""Text normalisation shared by alignment and SSML stages."""

from __future__ import annotations

import re
import unicodedata

# Accent-folding map from the reference's word normaliser
# (Code/Preprocessing/gen_break_ssml.py:52-63) — kept as the canonical
# behaviour so alignment keys match the reference byte-for-byte.
_ACCENTS = {
    "é": "e", "è": "e", "ê": "e", "ë": "e",
    "à": "a", "â": "a", "ä": "a",
    "î": "i", "ï": "i",
    "ô": "o", "ö": "o",
    "ù": "u", "û": "u", "ü": "u",
    "ÿ": "y", "ç": "c",
}

_NON_WORD = re.compile(r"[^\w\s]", re.UNICODE)
_WS = re.compile(r"\s+")


def normalize_word(word: str | None) -> str:
    """Lowercase, strip punctuation, fold accents
    (Code/Preprocessing/gen_break_ssml.py:44-63 semantics)."""
    if not word:
        return ""
    word = word.lower()
    word = _NON_WORD.sub("", word)
    for accent, plain in _ACCENTS.items():
        word = word.replace(accent, plain)
    return word


def normalize_phrase(s: str) -> str:
    """Lowercase, drop punctuation, squeeze spaces — the fuzzy-match
    normaliser of Code/audioPipeline.py:965-968."""
    s = s.lower()
    s = _NON_WORD.sub("", s)
    return _WS.sub(" ", s).strip()


def strip_diacritics(s: str) -> str:
    """Full Unicode decomposition fallback for characters outside the
    reference's explicit accent map."""
    return "".join(
        c for c in unicodedata.normalize("NFD", s) if unicodedata.category(c) != "Mn"
    )


def ends_sentence(token: str) -> bool:
    """Sentence-final punctuation test used for pause injection
    (Code/audioPipeline.py:478,485)."""
    return token.strip().endswith((".", "?", "!"))


def clean_transcript(text: str) -> str:
    """Remove bracketed annotations and ,;-punctuation — the TextGrid →
    transcript cleaner (Code/Pipeline/utils.py:25-27)."""
    text = re.sub(r"\[[^\]]*\]", "", text)
    text = text.replace(",", "").replace(";", "")
    return _WS.sub(" ", text).strip()


def xml_escape(s: str) -> str:
    """Escape &<> for SSML text content (xml.sax.saxutils.escape
    semantics used at Code/audioPipeline.py:607)."""
    return s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")


def levenshtein(a: str, b: str) -> int:
    """Plain edit distance (Code/Aligners/levenshtein_dist_align_txtgrids.py:43)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def similarity_ratio(a: str, b: str) -> float:
    """difflib.SequenceMatcher.ratio-compatible similarity used by the
    break comparator (Code/audioPipeline.py:970-971)."""
    from difflib import SequenceMatcher

    return SequenceMatcher(None, a, b).ratio()
