"""Deterministic compositional speech synthesizer for aligner pretraining.

The reference's CTC-family aligners ship pretrained acoustic models
(MFA French dictionary+acoustic model, NeMo ``stt_fr_citrinet_1024``,
ctc-forced-aligner checkpoints — Code/Aligners/Use_MFA.py:50-53, NeMo.py,
CTCFA.py). This environment has no model downloads, so the out-of-the-box
``aligner: ctc`` checkpoint is pretrained on *synthetic speech from this
module*: every character of ``ctc_aligner.FR_CHARS`` maps to a distinct,
fixed spectral signature (two "formant" partials + character-dependent
noising), so audio built by concatenation is compositional — a model
trained on it generalises to unseen words and sentences, which is what the
held-out boundary-error gate in tests/test_ctc_pretrained.py checks.

Unlike ``tts.fake.FakeBackend`` (whose waveform depends on a text *hash*,
deliberately non-compositional so measurement tests can't overfit), this
synthesizer is invertible by design: char identity is recoverable from any
80 ms window, and gold word boundaries are returned exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

FR_CHARS = " abcdefghijklmnopqrstuvwxyzàâäéèêëîïôöùûüÿçœ'-"  # the CTC aligner's character set (align.ctc_aligner)

VOWELS = set("aeiouyàâäéèêëîïôöùûüœ")

# Character-specific partial frequencies, golden-ratio-spread over the
# speech band so adjacent charset indices land far apart in frequency.
_PHI = 0.6180339887498949


def char_formants(c: str) -> tuple[float, float]:
    i = FR_CHARS.index(c)
    f1 = 280.0 + 2400.0 * ((i * _PHI) % 1.0)
    f2 = 900.0 + 4200.0 * ((i * _PHI * _PHI) % 1.0)
    return f1, f2


@dataclass
class SynthSpec:
    sample_rate: int = 16000
    vowel_s: float = 0.105
    consonant_s: float = 0.065
    space_s: float = 0.075
    edge_s: float = 0.04  # leading/trailing silence
    f0: float = 120.0  # voicing buzz under vowels
    noise: float = 0.015


def _char_wave(c: str, spec: SynthSpec, rng: np.random.Generator) -> np.ndarray:
    sr = spec.sample_rate
    if c == " ":
        return np.zeros(int(spec.space_s * sr), np.float32)
    dur = spec.vowel_s if c in VOWELS else spec.consonant_s
    n = int(dur * sr)
    t = np.arange(n) / sr
    f1, f2 = char_formants(c)
    sig = 0.55 * np.sin(2 * np.pi * f1 * t) + 0.35 * np.sin(2 * np.pi * f2 * t)
    if c in VOWELS:  # voicing buzz — vowels get harmonic low-band energy
        sig += 0.25 * np.sin(2 * np.pi * spec.f0 * t) + 0.12 * np.sin(4 * np.pi * spec.f0 * t)
    else:  # consonants get a touch of wide-band frication
        sig += 4.0 * spec.noise * rng.standard_normal(n)
    sig += spec.noise * rng.standard_normal(n)
    ramp = max(int(0.004 * sr), 1)
    env = np.ones(n)
    env[:ramp] = np.linspace(0, 1, ramp)
    env[-ramp:] *= np.linspace(1, 0, ramp)
    return (0.3 * sig * env).astype(np.float32)


def synth_sentence(
    text: str, spec: SynthSpec | None = None, seed: int = 0, with_chars: bool = False
):
    """text → (mono float32 audio, gold [(t0, t1, word)] spans in seconds).

    With ``with_chars=True`` additionally returns gold per-character spans
    [(t0, t1, char)] (inter-word gaps as ' ') — the frame-supervision
    targets for aligner pretraining. Characters outside FR_CHARS are
    dropped (matching CharVocab.encode); words that lose every character
    are skipped.
    """
    spec = spec or SynthSpec()
    sr = spec.sample_rate
    rng = np.random.default_rng(seed)
    pieces = [np.zeros(int(spec.edge_s * sr), np.float32)]
    t = spec.edge_s
    spans: list[tuple[float, float, str]] = []
    char_spans: list[tuple[float, float, str]] = []
    words = text.lower().split()
    for k, word in enumerate(words):
        kept = [c for c in word if c in FR_CHARS and c != " "]
        if not kept:
            continue
        if spans:  # inter-word gap
            gap = _char_wave(" ", spec, rng)
            pieces.append(gap)
            char_spans.append((t, t + gap.size / sr, " "))
            t += gap.size / sr
        t0 = t
        for c in kept:
            w = _char_wave(c, spec, rng)
            pieces.append(w)
            char_spans.append((t, t + w.size / sr, c))
            t += w.size / sr
        spans.append((t0, t, word))
    pieces.append(np.zeros(int(spec.edge_s * sr), np.float32))
    audio = np.concatenate(pieces)
    if with_chars:
        return audio, spans, char_spans
    return audio, spans


# ---------------------------------------------------------------------------
# sentence sampling for the pretraining corpus
# ---------------------------------------------------------------------------

# compact everyday-French vocabulary (all 46 FR_CHARS characters covered)
WORDS = (
    "le la les un une des et ou mais dans sur avec pour par que qui est "
    "sont était être avoir fait dit voit sait peut veut vient va prend "
    "bonjour merci voilà demain hier aujourd'hui toujours jamais encore "
    "maison ville rue monde pays temps jour nuit matin soir année siècle "
    "homme femme enfant ami frère sœur père mère famille gens "
    "musique chanson voix radio émission histoire œuvre portrait artiste "
    "grand petit beau jeune vieux nouveau premier dernier français "
    "parle écoute chante joue commence termine raconte explique montre "
    "très bien plus moins aussi ici là peut-être vraiment beaucoup "
    "eau feu ciel mer terre vent pluie neige été hiver printemps automne "
    "cœur tête main pied yeux nez goût août île forêt théâtre hôtel "
    "garçon leçon façon ça déjà près après très où dû sûr fût "
    "noël haïr maïs égoïste naïf aiguë exiguë "
    "kiwi wagon yoga pyjama zèbre jazz quiz box taxi examen "
    "l'ami d'abord qu'il c'est j'ai n'est s'il t'aime m'aime"
).split()


# Frequency-list French beyond the charset-coverage core: common
# content/function words (standard top-frequency vocabulary, not tied to
# any test text) so the byte decoder learns real French orthotactics —
# silent endings (-ent, -s, -x, -e), digraphs (ou/au/eau/ai/ei/oi/gn/ch),
# liaison-prone function words. Used by the narrator-domain (formant)
# pretraining mix; the core WORDS list alone taught a 150-word LM whose
# free decode produced French-shaped non-words on real audio (r04/r05
# agreement evidence).
WORDS_RICH = WORDS + (
    "de du au aux ce cette ces son sa ses mon ma mes ton ta tes notre votre "
    "il elle ils elles nous vous je tu on se ne pas plein chaque quelques "
    "tout tous toute toutes autre autres même mêmes tel telle quel quelle "
    "être été suis es sommes êtes serait sera seront était étaient "
    "avait avaient aura aurait ayant eu a ont avons avez "
    "faire fais faisait faisaient fera ferait faite faites "
    "dire disait disent dira dirait dit dits "
    "aller allait vont ira irait allé venir venait viennent viendra venu "
    "pouvoir pouvait peuvent pourra pourrait pu devoir devait doivent devra dû "
    "vouloir voulait veulent voudra voulu savoir savait savent saura su "
    "voir voyait voient verra vu prendre prenait prennent prendra pris "
    "donner donnait donnent donnera donné trouver trouvait trouvent trouvé "
    "passer passait passent passé rester restait restent resté "
    "porter portait portent porté laisser laissait laissent laissé "
    "venue entendre entendait entendent entendu attendre attendait attendu "
    "répondre répondait répondu vivre vivait vivent vécu "
    "écrire écrivait écrivent écrit lire lisait lisent lu "
    "chose choses vie mort corps esprit idée idées mot mots nom noms "
    "point points place places forme formes partie parties côté côtés "
    "moment moments heure heures minute minutes semaine semaines mois "
    "fois raison question questions réponse réponses travail œil "
    "état états cas effet effets ordre ordres suite suites fin fins "
    "personne personnes groupe groupes nombre nombres mesure mesures "
    "eau air terre mer feu lumière ombre couleur couleurs bruit silence "
    "chemin route porte fenêtre table chambre salle jardin champ champs "
    "arbre arbres fleur fleurs oiseau oiseaux cheval chevaux chien chat "
    "livre livres page pages lettre lettres journal image images "
    "père mère fils fille filles frères sœurs oncle tante "
    "roi reine prince peuple pays nation guerre paix force "
    "amour joie peur espoir douleur plaisir bonheur malheur "
    "blanc blanche noir noire rouge bleu vert jaune gris clair sombre "
    "long longue court courte haut haute bas basse large étroit "
    "fort forte faible doux douce dur dure froid froide chaud chaude "
    "plein pleine vide seul seule libre vrai vraie faux fausse "
    "bon bonne mauvais mauvaise meilleur meilleure pire "
    "ainsi alors ensuite enfin puis donc pourtant cependant peut "
    "souvent parfois rarement bientôt tard tôt longtemps "
    "presque assez trop tant autant combien pourquoi comment quand "
    "devant derrière dessus dessous entre vers chez sans sous contre "
    "pendant depuis avant après jusque malgré selon parmi"
).split()


def sample_sentences(
    n: int, seed: int = 0, min_words: int = 3, max_words: int = 9, vocab=None
) -> list[str]:
    rng = np.random.default_rng(seed)
    words = np.asarray(vocab if vocab is not None else WORDS)
    out = []
    for _ in range(n):
        k = int(rng.integers(min_words, max_words + 1))
        out.append(" ".join(rng.choice(words, size=k)))
    return out


# ---------------------------------------------------------------------------
# grammatical Zipf-weighted sampler (round-5 ASR domain work)
# ---------------------------------------------------------------------------
#
# Uniform draws over a word list give every word probability 1/|V| — real
# French is Zipfian and ~45 % closed-class. A decoder trained on uniform
# word salad learns a flat implicit LM, so its free decode on real audio
# carries no prior toward the function words that dominate genuine speech.
# These class pools (drawn from WORDS/WORDS_RICH — no new characters) plus
# phrase templates produce sentences with realistic word-frequency and
# word-LENGTH statistics: determiners/pronouns/prepositions at their real
# rates, content words on a geometric (Zipf-like) tail, l'/d' elisions
# before vowels. Syntax is approximate (no agreement); the point is the
# distribution, not grammar.

FR_DET = "le la les un une des du ce cette ces son sa ses leur notre".split()
FR_PRON = "il elle ils elles nous vous on je".split()
FR_PREP = "de dans sur avec pour sous vers chez sans entre devant pendant depuis après avant".split()
FR_CONJ = "et mais ou donc alors ensuite puis enfin".split()
FR_NEG = ["ne"]
FR_AUX = "est sont était étaient a ont avait avaient sera serait".split()
FR_V = (
    "parle écoute chante joue commence termine raconte explique montre "
    "fait dit voit sait peut veut vient va prend trouvait donnait passait "
    "restait portait laissait attendait entendait répondait vivait écrivait "
    "lisait allait venait pouvait devait voulait savait voyait prenait"
).split()
FR_VPP = "fait dit vu pris donné trouvé passé resté porté laissé entendu attendu venu allé écrit lu".split()
FR_N = (
    "maison ville rue monde pays temps jour nuit matin soir année siècle "
    "homme femme enfant ami famille gens musique chanson voix radio émission "
    "histoire œuvre portrait artiste eau ciel mer terre vent pluie neige "
    "cœur tête main pied chose vie esprit idée mot nom point place forme "
    "partie côté moment heure minute semaine mois fois raison question "
    "réponse travail état cas effet ordre suite fin personne groupe nombre "
    "mesure air lumière ombre couleur bruit silence chemin route porte "
    "fenêtre table chambre salle jardin champ arbre fleur oiseau cheval "
    "chien chat livre page lettre journal image père mère fils fille "
    "oncle tante roi reine prince peuple nation guerre paix force amour "
    "joie peur espoir douleur plaisir bonheur"
).split()
FR_ADJ = (
    "grand petit beau jeune vieux nouveau premier dernier français blanc "
    "noir rouge bleu vert jaune gris clair sombre long court haut bas "
    "large fort faible doux dur froid chaud plein vide seul libre vrai bon"
).split()
FR_ADV = (
    "très bien plus moins aussi ici là vraiment beaucoup toujours jamais "
    "encore souvent parfois bientôt tard tôt longtemps presque assez trop "
    "ainsi pourtant cependant"
).split()

_VOWELS = "aeiouyàâéèêëîïôùûh"


def _geom_choice(rng: np.random.Generator, pool: list[str], p: float = 0.06) -> str:
    """Zipf-like draw: geometric rank weighting over a fixed pool order."""
    r = int(rng.geometric(p)) - 1
    return pool[r % len(pool)]


def _np_token(rng: np.random.Generator) -> list[str]:
    det = _geom_choice(rng, FR_DET, 0.25)
    noun = _geom_choice(rng, FR_N)
    if det in ("le", "la") and noun[0] in _VOWELS:
        return [f"l'{noun}"]
    if rng.random() < 0.25:
        return [det, noun, _geom_choice(rng, FR_ADJ)] if rng.random() < 0.5 else [
            det,
            _geom_choice(rng, FR_ADJ),
            noun,
        ]
    return [det, noun]


def _vp_token(rng: np.random.Generator) -> list[str]:
    r = rng.random()
    if r < 0.25:
        return [_geom_choice(rng, FR_AUX, 0.3), _geom_choice(rng, FR_VPP)]
    if r < 0.35:
        return [_geom_choice(rng, FR_AUX, 0.3), _geom_choice(rng, FR_ADJ)]
    v = [_geom_choice(rng, FR_V)]
    if rng.random() < 0.2:
        v.append(_geom_choice(rng, FR_ADV))
    return v


def _pp_token(rng: np.random.Generator) -> list[str]:
    prep = _geom_choice(rng, FR_PREP, 0.3)
    rest = _np_token(rng)
    if prep == "de" and rest and rest[0].startswith("l'"):
        return ["de", *rest] if rng.random() < 0.5 else [f"d'{rest[0][2:]}", *rest[1:]]
    return [prep, *rest]


def sample_sentences_fr(
    n: int, seed: int = 0, min_words: int = 3, max_words: int = 9
) -> list[str]:
    """Grammatical-template French with Zipfian content words — the
    narrator-domain training distribution (and the unigram source for the
    lexicon decoder's shallow fusion, align.lexicon_decode)."""
    rng = np.random.default_rng(seed)
    out: list[str] = []
    while len(out) < n:
        words: list[str] = []
        if rng.random() < 0.18:
            words.append(_geom_choice(rng, FR_CONJ, 0.35))
        subj = rng.random()
        if subj < 0.45:
            words.extend(_np_token(rng))
        else:
            words.append(_geom_choice(rng, FR_PRON, 0.3))
        words.extend(_vp_token(rng))
        r = rng.random()
        if r < 0.45:
            words.extend(_np_token(rng))
        if rng.random() < 0.5:
            words.extend(_pp_token(rng))
        if rng.random() < 0.15:
            words.append(_geom_choice(rng, FR_ADV))
        if min_words <= len(words) <= max_words:
            out.append(" ".join(words))
    return out


def sampler_vocabulary() -> list[str]:
    """Every surface form sample_sentences_fr can emit (elisions included) —
    the lexicon decoder's trie must cover them all."""
    base = (
        FR_DET + FR_PRON + FR_PREP + FR_CONJ + FR_NEG + FR_AUX + FR_V + FR_VPP + FR_N + FR_ADJ + FR_ADV
    )
    eli = [f"l'{n}" for n in FR_N if n[0] in _VOWELS] + [
        f"d'{n}" for n in FR_N if n[0] in _VOWELS
    ]
    return list(dict.fromkeys(base + eli))


def unigram_priors(n_sentences: int = 8000, seed: int = 123) -> dict[str, float]:
    """Empirical unigram distribution of the grammar sampler — the shallow-
    fusion prior for lexicon-constrained decode. Derived purely from the
    TRAINING distribution (never from evaluation text)."""
    from collections import Counter

    c: Counter[str] = Counter()
    for s in sample_sentences_fr(n_sentences, seed=seed):
        c.update(s.split())
    total = sum(c.values())
    return {w: k / total for w, k in c.items()}


def build_corpus(out_dir: str | Path, n: int = 256, seed: int = 0, spec: SynthSpec | None = None) -> list[Path]:
    """Write n wav+txt pairs (the train_ctc.load_pairs layout)."""
    from ..utils.wavio import write_wav

    spec = spec or SynthSpec()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, sent in enumerate(sample_sentences(n, seed=seed)):
        audio, _ = synth_sentence(sent, spec, seed=seed + i)
        wav = out_dir / f"synth_{i:04d}.wav"
        write_wav(wav, audio, spec.sample_rate)
        (out_dir / f"synth_{i:04d}.txt").write_text(sent, encoding="utf-8")
        paths.append(wav)
    return paths
