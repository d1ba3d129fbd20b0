"""Silver French POS treebank generator (templates with tags known by
construction).

The reference's pipeline needs exactly one POS decision — *may a pause or
comma follow this token?* — and gets it from spaCy's contextual
``fr_core_news_sm`` (Code/audioPipeline.py:26-27,451-465). The hermetic
rebuild's ``utils/fr_pos`` lexicon answers per-token and therefore cannot
separate readings of ambiguous forms ("a" AUX vs unaccented "à", "son"
DET vs NOUN, "or"/"car" CCONJ vs NOUN, "personne" PRON vs NOUN, "tout"
DET vs ADV, "si" SCONJ vs intensifier…). This module generates a
template treebank where every token's UPOS is known by construction and
the forbidden-relevant ambiguities appear in BOTH readings, so a tiny
contextual tagger (models/pos_tagger.py) can learn what the lexicon
cannot express.

Tags follow UD French GSD conventions (copulas/tense auxiliaries are AUX;
sentence-initial "donc"/"puis"/"alors" are ADV — the lexicon's
conservative CCONJ reading of "donc" is a deliberate divergence the drift
eval quantifies).

Accent augmentation: the pipeline's ASR transcripts are lowercase and
unaccented (see align/pretrained corpora), while SSML-side text keeps
accents — every sentence is emitted in both spellings so one tagger
serves both text domains.
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass

import numpy as np

__all__ = [
    "TAGS",
    "TAG_TO_ID",
    "FORBIDDEN_TAGS",
    "Sentence",
    "generate_treebank",
    "strip_accents",
]

TAGS = [
    "<pad>",
    "ADJ",
    "ADP",
    "ADV",
    "AUX",
    "CCONJ",
    "DET",
    "INTJ",
    "NOUN",
    "NUM",
    "PART",
    "PRON",
    "PROPN",
    "PUNCT",
    "SCONJ",
    "VERB",
]
TAG_TO_ID = {t: i for i, t in enumerate(TAGS)}
# the reference's forbidden set (Code/audioPipeline.py:27) in UPOS terms
FORBIDDEN_TAGS = {"DET", "ADP", "CCONJ", "SCONJ", "PART", "PRON"}


@dataclass(frozen=True)
class Sentence:
    words: tuple[str, ...]
    tags: tuple[str, ...]


def strip_accents(s: str) -> str:
    return "".join(
        c for c in unicodedata.normalize("NFD", s) if unicodedata.category(c) != "Mn"
    )


# ---------------------------------------------------------------------------
# slot lexicons (every filler is used ONLY with the slot's tag)

N_M = [
    "chien", "livre", "village", "musée", "chemin", "train", "matin", "soir",
    "voyage", "jardin", "bruit", "projet", "travail", "marché", "journal",
    "bateau", "château", "piano", "violon", "concert", "film", "poème",
    "roman", "tableau", "visage", "sourire", "silence", "discours",
    "problème", "moment", "monde", "pays", "temps", "vent", "feu", "pont",
    "port", "bois", "champ", "ciel", "fleuve", "fruit", "gâteau", "repas",
    "métier", "bureau", "clavier", "rythme", "thème", "refrain",
]
N_F = [
    "maison", "table", "musique", "ville", "route", "lettre", "fleur",
    "montagne", "rivière", "chanson", "histoire", "école", "église",
    "fenêtre", "porte", "voiture", "cuisine", "forêt", "plage", "nuit",
    "journée", "semaine", "idée", "question", "réponse", "voix", "lumière",
    "couleur", "photo", "radio", "pluie", "neige", "mer", "lune", "étoile",
    "salle", "scène", "note", "mélodie", "émission", "pause", "phrase",
    "langue", "main", "tête", "rue", "place", "gare", "cloche", "guitare",
]
PP = [
    "mangé", "donné", "fini", "perdu", "trouvé", "vendu", "acheté", "ouvert",
    "fermé", "écrit", "lu", "vu", "pris", "mis", "dit", "fait", "chanté",
    "joué", "quitté", "appelé", "écouté", "regardé", "aimé", "choisi",
    "compris", "entendu", "oublié", "préparé", "rangé", "montré",
]
V3S = [
    "mange", "dort", "chante", "parle", "marche", "arrive", "regarde",
    "écoute", "travaille", "joue", "habite", "cherche", "trouve", "ouvre",
    "ferme", "monte", "descend", "tombe", "reste", "passe", "commence",
    "continue", "répond", "attend", "sourit", "danse", "brille", "sonne",
    "résonne", "recommence",
]
ADJ_M = [
    "grand", "petit", "beau", "vieux", "jeune", "long", "court", "clair",
    "sombre", "froid", "chaud", "lent", "rapide", "calme", "fort", "doux",
    "joli", "propre", "simple", "lourd", "léger", "haut", "bas", "neuf",
    "ancien", "moderne", "étrange", "précieux", "profond", "vif",
]
ADJ_F = [
    "grande", "petite", "belle", "vieille", "jeune", "longue", "courte",
    "claire", "sombre", "froide", "chaude", "lente", "rapide", "calme",
    "forte", "douce", "jolie", "propre", "simple", "lourde", "légère",
    "haute", "basse", "neuve", "ancienne", "moderne", "étrange",
    "précieuse", "profonde", "vive",
]
ADVS = [
    "doucement", "lentement", "rapidement", "souvent", "toujours", "encore",
    "déjà", "hier", "demain", "ici", "bientôt", "parfois", "ensuite",
    "enfin", "ensemble", "longtemps", "tôt", "tard", "vraiment",
    "beaucoup", "ailleurs", "dehors", "partout", "aussitôt", "maintenant",
]
PROPN = [
    "marie", "paul", "jean", "claire", "julien", "camille", "hugo", "louise",
    "emma", "lucas", "nina", "théo", "sarah", "léo", "anna", "victor",
]
CITY = [
    "paris", "lyon", "marseille", "toulouse", "lille", "nantes", "bordeaux",
    "rennes", "dijon", "amiens",
]
NUMS = ["deux", "trois", "quatre", "cinq", "six", "sept", "huit", "dix"]

_SLOTS: dict[str, tuple[list[str], str]] = {
    "Nm": (N_M, "NOUN"),
    "Nf": (N_F, "NOUN"),
    "PP": (PP, "VERB"),
    "V": (V3S, "VERB"),
    "Am": (ADJ_M, "ADJ"),
    "Af": (ADJ_F, "ADJ"),
    "Adv": (ADVS, "ADV"),
    "Prop": (PROPN, "PROPN"),
    "City": (CITY, "PROPN"),
    "Num": (NUMS, "NUM"),
}


def _t(spec: str) -> list[tuple[str, str]]:
    """Parse "word/TAG word/TAG {Slot}" template spec into (token, tag-or-slot)."""
    out = []
    for item in spec.split():
        if item.startswith("{") and item.endswith("}"):
            out.append((item[1:-1], "<slot>"))
        else:
            w, tag = item.rsplit("/", 1)
            out.append((w, tag))
    return out


# ---------------------------------------------------------------------------
# templates — unambiguous scaffolding + every forbidden-relevant ambiguity
# in both readings. "/TAG" literals are fixed; "{Slot}" draws from _SLOTS.

TEMPLATES: list[list[tuple[str, str]]] = [
    _t(s)
    for s in [
        # --- scaffolding: common unambiguous shapes ---------------------
        "le/DET {Nm} {V} {Adv}",
        "la/DET {Nf} est/AUX {Af}",
        "un/DET {Nm} {Am} {V}",
        "une/DET {Nf} {Af} {V}",
        "il/PRON {V} dans/ADP le/DET {Nm}",
        "elle/PRON {V} vers/ADP la/DET {Nf}",
        "{Prop} regarde/VERB la/DET {Nf}",
        "{Prop} et/CCONJ {Prop} chantent/VERB",
        "nous/PRON avons/AUX {PP} le/DET {Nm}",
        "vous/PRON avez/AUX {PP} la/DET {Nf}",
        "je/PRON ne/PART {V} pas/ADV",
        "tu/PRON ne/PART {V} plus/ADV",
        "c'/PRON est/AUX un/DET {Nm} {Am}",
        "c'/PRON est/AUX une/DET {Nf} {Af}",
        "les/DET {Nm} de/ADP {Prop} sont/AUX là/ADV",
        "{Num} {Nm} {V} sur/ADP la/DET {Nf}",
        "mon/DET {Nm} {V} chez/ADP {Prop}",
        "sa/DET {Nf} {V} près/ADV de/ADP la/DET {Nf}",
        "on/PRON {V} pour/ADP le/DET {Nm}",
        "quand/SCONJ le/DET {Nm} {V} ,/PUNCT la/DET {Nf} {V}",
        "lorsque/SCONJ {Prop} {V} ,/PUNCT on/PRON écoute/VERB",
        "mais/CCONJ la/DET {Nf} reste/VERB {Af}",
        "puis/ADV ,/PUNCT il/PRON {V}",
        "alors/ADV ,/PUNCT elle/PRON {V}",
        "ensuite/ADV ,/PUNCT le/DET {Nm} {V}",
        "donc/ADV ,/PUNCT on/PRON {V}",
        "eh/INTJ bien/ADV ,/PUNCT nous/PRON voilà/ADP",
        "{Prop} parle/VERB de/ADP la/DET {Nf} avec/ADP {Prop}",
        "le/DET {Nm} du/ADP {Nm} est/AUX {Am}",
        "la/DET {Nf} des/ADP {Nf} {V}",
        "il/PRON y/PRON a/AUX un/DET {Nm} ici/ADV",
        "ce/DET {Nm} -là/ADV {V} {Adv}",
        "cette/DET {Nf} {V} sans/ADP {Nm}",
        # --- a : AUX vs unaccented preposition ---------------------------
        "il/PRON a/AUX {PP} le/DET {Nm}",
        "elle/PRON a/AUX {Adv} {PP}",
        "on/PRON a/AUX {PP} la/DET {Nf}",
        "{Prop} a/AUX {PP} {Num} {Nm}",
        "il/PRON habite/VERB a/ADP {City}",
        "elle/PRON va/VERB a/ADP {City}",
        "le/DET train/NOUN arrive/VERB a/ADP {City}",
        "{Prop} pense/VERB a/ADP la/DET {Nf}",
        # --- son : DET vs NOUN -------------------------------------------
        "son/DET {Nm} {V} {Adv}",
        "elle/PRON aime/VERB son/DET {Nm}",
        "son/DET {Nf} est/AUX {Af}",
        "le/DET son/NOUN de/ADP la/DET {Nf} est/AUX {Am}",
        "un/DET son/NOUN {Am} {V}",
        "le/DET son/NOUN {V} dans/ADP la/DET {Nf}",
        "son/DET {Nm} aime/VERB le/DET son/NOUN {Am}",
        "il/PRON règle/VERB le/DET son/NOUN avant/ADP le/DET {Nm}",
        # --- or : CCONJ vs NOUN ------------------------------------------
        "or/CCONJ ,/PUNCT il/PRON {V}",
        "or/CCONJ ,/PUNCT la/DET {Nf} est/AUX {Af}",
        "or/CCONJ personne/PRON ne/PART {V}",
        "or/CCONJ il/PRON ne/PART {V} pas/ADV",
        "l'/DET or/NOUN brille/VERB {Adv}",
        "un/DET bijou/NOUN en/ADP or/NOUN",
        "l'/DET or/NOUN est/AUX {Am}",
        # --- car : CCONJ vs NOUN -----------------------------------------
        "il/PRON reste/VERB car/CCONJ il/PRON pleut/VERB",
        "{Prop} dort/VERB car/CCONJ la/DET {Nf} {V}",
        "on/PRON {V} car/CCONJ le/DET {Nm} est/AUX {Am}",
        "le/DET car/NOUN arrive/VERB a/ADP {City}",
        "un/DET car/NOUN {Am} passe/VERB",
        "le/DET car/NOUN est/AUX parti/VERB",
        "le/DET car/NOUN attend/VERB devant/ADP la/DET {Nf}",
        # both readings in ONE sentence — the repeated-form case the
        # pause filter hits (ADVICE r4 / golden sentence 7)
        "car/CCONJ il/PRON pleut/VERB le/DET car/NOUN attend/VERB",
        "il/PRON {V} car/CCONJ le/DET car/NOUN est/AUX parti/VERB",
        # --- personne : PRON vs NOUN -------------------------------------
        "personne/PRON ne/PART {V}",
        "il/PRON ne/PART voit/VERB personne/PRON",
        "personne/PRON ne/PART répond/VERB ici/ADV",
        "cette/DET personne/NOUN est/AUX {Af}",
        "une/DET personne/NOUN {Af} parle/VERB",
        "la/DET personne/NOUN {V} devant/ADP la/DET {Nf}",
        # --- tout : DET vs ADV vs PRON -----------------------------------
        "tout/DET le/DET {Nm} {V}",
        "toute/DET la/DET {Nf} écoute/VERB",
        "tous/DET les/DET {Nm} {V}",
        "il/PRON {V} tout/ADV doucement/ADV",
        "elle/PRON chante/VERB tout/ADV bas/ADV",
        "tout/PRON va/VERB bien/ADV",
        "il/PRON a/AUX tout/PRON {PP}",
        "le/DET tout/NOUN forme/VERB une/DET {Nf}",
        "le/DET tout/NOUN est/AUX {Am}",
        "il/PRON a/AUX tout/PRON {PP} pour/ADP la/DET {Nf}",
        "elle/PRON a/AUX tout/PRON {PP} ici/ADV",
        # --- si : SCONJ vs intensifier ADV -------------------------------
        "si/SCONJ tu/PRON viens/VERB ,/PUNCT je/PRON {V}",
        "il/PRON demande/VERB si/SCONJ elle/PRON dort/VERB",
        "si/SCONJ la/DET {Nf} {V} ,/PUNCT on/PRON part/VERB",
        "si/SCONJ le/DET {Nm} {V} il/PRON {V}",
        "si/SCONJ elle/PRON {V} nous/PRON partons/VERB",
        "le/DET {Nm} est/AUX si/ADV {Am}",
        "elle/PRON chante/VERB si/ADV bien/ADV",
        "une/DET {Nf} si/ADV {Af}",
        # --- soit : CCONJ vs subjunctive AUX ------------------------------
        "soit/CCONJ le/DET {Nm} soit/CCONJ la/DET {Nf}",
        "soit/CCONJ lundi/NOUN soit/CCONJ mardi/NOUN",
        "il/PRON faut/VERB qu'/SCONJ il/PRON soit/AUX là/ADV",
        "bien/ADV qu'/SCONJ elle/PRON soit/AUX {Af}",
        "il/PRON faut/VERB que/SCONJ la/DET {Nf} soit/AUX {Af}",
        "on/PRON veut/VERB que/SCONJ le/DET {Nm} soit/AUX {Am}",
        # --- avant / après : ADP vs ADV ----------------------------------
        "avant/ADP le/DET {Nm} ,/PUNCT on/PRON {V}",
        "avant/ADP la/DET nuit/NOUN ,/PUNCT il/PRON {V}",
        "il/PRON est/AUX parti/VERB avant/ADV",
        "elle/PRON arrive/VERB après/ADP le/DET {Nm}",
        "on/PRON verra/VERB après/ADV",
        "elle/PRON arrive/VERB peu/ADV après/ADV",
        "il/PRON {V} peu/ADV avant/ADV",
        "l'/DET avant/NOUN du/ADP bateau/NOUN est/AUX {Am}",
        # --- pendant / devant / derrière ---------------------------------
        "pendant/ADP la/DET {Nf} ,/PUNCT {Prop} {V}",
        "devant/ADP la/DET {Nf} ,/PUNCT le/DET {Nm} {V}",
        "le/DET devant/NOUN de/ADP la/DET maison/NOUN est/AUX {Am}",
        "derrière/ADP le/DET {Nm} ,/PUNCT elle/PRON {V}",
        # --- vers : ADP vs NOUN ------------------------------------------
        "vers/ADP le/DET {Nm} ,/PUNCT il/PRON {V}",
        "il/PRON écrit/VERB des/DET vers/NOUN {Am}",
        # --- entre : ADP vs VERB -----------------------------------------
        "entre/ADP les/DET {Nm} ,/PUNCT un/DET {Nm} {V}",
        "il/PRON entre/VERB dans/ADP la/DET {Nf}",
        # --- bien : ADV vs NOUN ------------------------------------------
        "elle/PRON chante/VERB bien/ADV",
        "c'/PRON est/AUX bien/ADV",
        "un/DET bien/NOUN {Am} se/PRON garde/VERB",
        # --- été : NOUN vs past participle -------------------------------
        "l'/DET été/NOUN est/AUX {Am}",
        "pendant/ADP l'/DET été/NOUN ,/PUNCT on/PRON {V}",
        "il/PRON a/AUX été/AUX {Am}",
        "elle/PRON a/AUX été/AUX {Af}",
        # --- pas : negation ADV vs NOUN ----------------------------------
        "il/PRON ne/PART dort/VERB pas/ADV",
        "elle/PRON fait/VERB un/DET pas/NOUN vers/ADP la/DET {Nf}",
        # --- leur : DET vs dative PRON -----------------------------------
        "leur/DET {Nm} est/AUX {Am}",
        "il/PRON leur/PRON parle/VERB {Adv}",
        "elle/PRON leur/PRON donne/VERB le/DET {Nm}",
        # --- en : ADP vs clitic PRON -------------------------------------
        "en/ADP hiver/NOUN ,/PUNCT la/DET {Nf} {V}",
        "il/PRON en/PRON parle/VERB {Adv}",
        "elle/PRON en/PRON a/AUX {PP} {Num}",
        # --- le/la/les : DET vs object clitic PRON -----------------------
        "il/PRON le/PRON voit/VERB {Adv}",
        "elle/PRON la/PRON regarde/VERB",
        "on/PRON les/PRON écoute/VERB {Adv}",
        # --- que : SCONJ vs relative PRON --------------------------------
        "je/PRON pense/VERB que/SCONJ tu/PRON dors/VERB",
        "le/DET {Nm} que/PRON je/PRON lis/VERB est/AUX {Am}",
        # --- comme : SCONJ vs ADV ----------------------------------------
        "comme/SCONJ il/PRON {V} ,/PUNCT on/PRON attend/VERB",
        "il/PRON chante/VERB comme/ADP un/DET oiseau/NOUN",
        # --- est : AUX vs NOUN (l'est du pays) ---------------------------
        "l'/DET est/NOUN du/ADP pays/NOUN est/AUX {Am}",
    ]
]


def _instantiate(tpl: list[tuple[str, str]], rng: np.random.Generator, pool: dict) -> Sentence:
    words, tags = [], []
    for tok, tag in tpl:
        if tag == "<slot>":
            fillers, slot_tag = pool[tok]
            words.append(fillers[rng.integers(len(fillers))])
            tags.append(slot_tag)
        else:
            words.append(tok)
            tags.append(tag)
    return Sentence(tuple(words), tuple(tags))


def generate_treebank(
    n: int = 12000,
    seed: int = 0,
    holdout_fillers: bool = False,
    accent_strip_prob: float = 0.5,
) -> list[Sentence]:
    """``n`` template instantiations. ``holdout_fillers=True`` draws slot
    fillers from the held-out half of each lexicon (disjoint from the
    training half), so eval measures generalisation to unseen content
    words, not memorisation."""
    rng = np.random.default_rng(seed)
    pool = {}
    for name, (fillers, tag) in _SLOTS.items():
        half = len(fillers) // 2
        pool[name] = (fillers[half:] if holdout_fillers else fillers[:half], tag)
    out = []
    for _ in range(n):
        tpl = TEMPLATES[rng.integers(len(TEMPLATES))]
        s = _instantiate(tpl, rng, pool)
        if rng.random() < accent_strip_prob:
            s = Sentence(tuple(strip_accents(w) for w in s.words), s.tags)
        out.append(s)
    return out
