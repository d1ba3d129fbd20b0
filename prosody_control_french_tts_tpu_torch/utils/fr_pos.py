"""French closed-class part-of-speech tagging (host-side, lexicon-based).

The reference loads spaCy ``fr_core_news_sm`` purely to answer one question:
*is this token one of DET/ADP/CCONJ/SCONJ/PART/PRON?* — used to drop commas
after function words (Code/audioPipeline.py:26-27,64-81) and to suppress
pauses after function words (Code/audioPipeline.py:451-465). Those six UPOS
classes are closed in French, so an explicit lexicon answers the same
question without a 15 MB statistical model, deterministically and
vendor-independently. Words outside the lexicon are tagged "X" (content
word), which is exactly the permissive behaviour the filters need.

The tagger is pluggable: ``core.pipeline`` accepts any callable
``str -> str`` should a statistical tagger be preferred.
"""

from __future__ import annotations

import re

# Union Dictionnaire/UD-French-GSD closed classes. Contractions of
# preposition+article (au, aux, du, des) are ADP in UD French; ambiguous
# clitics (le/la/les, en, que) take their function-word reading — for the
# pause/comma filters both readings are "forbidden" classes, so the
# distinction is immaterial downstream.
DET = {
    "le", "la", "les", "un", "une", "des", "du",
    "ce", "cet", "cette", "ces",
    "mon", "ton", "son", "ma", "ta", "sa", "mes", "tes", "ses",
    "notre", "votre", "leur", "nos", "vos", "leurs",
    "quel", "quelle", "quels", "quelles",
    "chaque", "plusieurs", "quelques", "certains", "certaines",
    "aucun", "aucune", "nul", "nulle",
    "tout", "toute", "tous", "toutes",
    "maint", "maintes", "divers", "diverses", "différents", "différentes",
    "l'", "d'un", "d'une",
}
ADP = {
    "à", "a", "de", "en", "dans", "sur", "sous", "avec", "sans", "pour",
    "par", "entre", "vers", "chez", "contre", "depuis", "pendant", "avant",
    "après", "derrière", "devant", "dès", "durant", "envers", "hormis",
    "jusque", "jusqu'", "malgré", "moyennant", "outre", "parmi", "sauf",
    "selon", "via", "au", "aux", "d'", "concernant", "excepté", "suivant",
    "voici", "voilà",
}
# "puis"/"sinon"/"bien" are ADV in UD French (pauses after "Eh bien," /
# "Puis," are legitimate — spaCy would not suppress them); "donc" is kept
# although UD GSD leans ADV: mid-clause "donc" (its dominant position) is
# never pause-followed, so the conservative reading costs nothing.
CCONJ = {"mais", "ou", "et", "donc", "or", "ni", "car", "soit"}
SCONJ = {
    "que", "qu'", "si", "s'", "comme", "quand", "lorsque", "lorsqu'",
    "puisque", "puisqu'", "quoique", "quoiqu'", "parce",
    "tandis", "afin", "dès", "avant", "après", "pendant",
}
PRON = {
    "je", "j'", "tu", "il", "elle", "on", "nous", "vous", "ils", "elles",
    "me", "m'", "te", "t'", "se", "s'", "moi", "toi", "soi", "lui", "eux",
    "y", "en", "le", "la", "les", "leur",
    "qui", "que", "qu'", "quoi", "dont", "où",
    "celui", "celle", "ceux", "celles", "celui-ci", "celle-ci", "ceux-ci",
    "celui-là", "celle-là", "ceux-là", "ceci", "cela", "ça", "c'", "ce",
    "chacun", "chacune", "quelqu'un", "quelqu'une", "quelques-uns",
    "quelques-unes", "personne", "rien", "autrui", "quiconque",
    "lequel", "laquelle", "lesquels", "lesquelles", "auquel", "auxquels",
    "auxquelles", "duquel", "desquels", "desquelles",
    "mien", "tien", "sien", "mienne", "tienne", "sienne",
    "miens", "tiens", "siens", "miennes", "tiennes", "siennes",
    "nôtre", "vôtre", "nôtres", "vôtres",
}
PART = {"ne", "n'", "non", "-t", "est-ce"}

# Priority order mirrors UD French lexical frequency for the ambiguous
# forms: articles beat clitic pronouns; "que" is SCONJ-dominant between
# clauses but PRON elsewhere — either way it is filtered, so priority only
# affects the reported label.
_CLASSES: list[tuple[str, set[str]]] = [
    ("DET", DET),
    ("ADP", ADP),
    ("CCONJ", CCONJ),
    ("SCONJ", SCONJ),
    ("PRON", PRON),
    ("PART", PART),
]

FORBIDDEN = {"DET", "ADP", "CCONJ", "SCONJ", "PART", "PRON"}

_TOKEN_RE = re.compile(r"[\w'’-]+|[^\w\s]", re.UNICODE)
_ELISION_RE = re.compile(r"^([cdjlmnst]|qu|jusqu|lorsqu|puisqu|quoiqu)['’]", re.IGNORECASE)


def _strip_token(tok: str) -> str:
    return tok.strip().strip(".,;:!?…«»\"()[]").lower().replace("’", "'")


def pos_tag(word: str) -> str:
    """UPOS tag for a single French token — closed classes only; open-class
    or unknown words return "X"."""
    w = _strip_token(word)
    if not w:
        return "X"
    m = _ELISION_RE.match(w)
    if m:
        w = m.group(1) + "'"
    for label, lexicon in _CLASSES:
        if w in lexicon:
            return label
    return "X"


def is_function_word(word: str) -> bool:
    """True iff the word's tag is in the reference's forbidden set
    (Code/audioPipeline.py:27): no pause/comma may directly follow it."""
    return pos_tag(word) in FORBIDDEN


def first_token_pos(text: str) -> str:
    """POS of the first token of a (possibly multi-word) string — mirrors
    ``_nlp(ptok.strip())[0].pos_`` (Code/audioPipeline.py:459)."""
    toks = _TOKEN_RE.findall(text.strip())
    return pos_tag(toks[0]) if toks else "X"


def tokenize(text: str) -> list[str]:
    """Whitespace/punctuation tokenizer compatible with the comma-filter
    walk over spaCy tokens (Code/audioPipeline.py:70-81)."""
    return _TOKEN_RE.findall(text)


def remove_spurious_commas(text: str) -> str:
    """Strip commas (and "[*]" pause markers) that directly follow a
    function word — reimplementation of Code/audioPipeline.py:64-81.

    Reconstruction keeps original spacing by splicing the comma span out of
    the source string instead of re-joining tokens.
    """
    out = []
    removed_spans: list[tuple[int, int]] = []
    prev_tag = None
    for m in _TOKEN_RE.finditer(text):
        tok = m.group(0)
        if (tok == "," or tok == "[*]") and prev_tag in FORBIDDEN:
            removed_spans.append((m.start(), m.end()))
            continue
        # "[*]" splits into tokens "[", "*", "]" under the regex; handle the
        # literal marker by lookahead on the raw string.
        if tok == "[" and text[m.start() : m.start() + 3] == "[*]" and prev_tag in FORBIDDEN:
            removed_spans.append((m.start(), m.start() + 3))
            continue
        if tok.strip():
            prev_tag = pos_tag(tok) if tok[0].isalnum() or "'" in tok else prev_tag
            if not (tok[0].isalnum() or "'" in tok):
                prev_tag = None  # punctuation breaks the adjacency
        out.append(tok)
    if not removed_spans:
        return text
    res = []
    last = 0
    for s, e in removed_spans:
        res.append(text[last:s])
        # also swallow one following space so "mot , suite" → "mot suite"
        if e < len(text) and text[e] == " " and (s > 0 and text[s - 1] == " "):
            e += 1
        last = e
    res.append(text[last:])
    return "".join(res)
