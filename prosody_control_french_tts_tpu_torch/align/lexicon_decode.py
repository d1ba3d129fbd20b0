"""Lexicon-constrained byte decoding for the packaged Whisper aligner.

The reference's aligner ships OpenAI weights whose decoder embeds a strong
French language model (Code/Aligners/use_whisper_timestamped.py:92-104), so
its free transcriptions are real French words. The hermetic checkpoint's
implicit LM knows only the synthetic training distribution; on real
(out-of-domain) audio its unconstrained byte decode emits French-SHAPED
non-words ("maucœure", "zèbis") and degenerate repetition loops — see
docs/real_audio_agreement_r04/r05.json.

Both failure modes have standard ASR fixes, implemented as pure table
lookups inside the greedy loop (no host control flow):

- **lexicon constraint** (the classical "dictionary decoding" of
  HMM/CTC systems, shallow-fusion in seq2seq ones): a byte trie over a
  real French vocabulary is lowered to two device tables —
  ``trans[node, byte] → node`` and ``can_end[node]`` — and the greedy
  argmax is masked to trie-legal continuations, so every emitted word IS
  a French word. Elided articles (l', d', qu'…) splice root transitions
  into their end node so "l'histoire" decodes as one whitespace word,
  matching French orthography;
- **unigram prior** (shallow fusion): word-final nodes carry the word's
  log-unigram score under the training distribution; it is added to the
  space/eot logit when closing a word, biasing ties toward frequent
  function words exactly like an n-gram fusion LM would;
- **repetition guard**: whisper itself rejects decodes on compression-
  ratio gates and re-samples; in a single greedy pass the equivalent is
  forbidding the same word from closing more than ``rep_limit`` times
  consecutively (the "z z z z" loops babble to the token cap otherwise).

The tables are built once per vocabulary on host (numpy) and captured as
tensors on the device once by the greedy decode; masking is one gather + one
concatenated boolean row per step — invisible next to the decoder matmuls.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = [
    "TrieTables",
    "build_trie",
    "french_lexicon",
    "default_trie",
]

SPACE = 0x20


class TrieTables:
    """Device-ready byte-trie tables.

    trans: [N, 256] int32 — next node per byte, -1 = not a legal
        continuation. Node 0 is the word start (root).
    can_end: [N] bool — a vocabulary word ends at this node (space/eot
        may close it).
    end_bonus: [N] f32 — log-unigram score added to the space/eot logit
        when closing at this node (zero-centred; 0 where can_end=False).
    """

    def __init__(self, trans: np.ndarray, can_end: np.ndarray, end_bonus: np.ndarray):
        self.trans = trans
        self.can_end = can_end
        self.end_bonus = end_bonus

    @property
    def n_nodes(self) -> int:
        return self.trans.shape[0]


def build_trie(
    words: list[str],
    priors: dict[str, float] | None = None,
    elision_suffix: str = "'",
) -> TrieTables:
    """Byte trie over UTF-8 ``words`` (1 byte = 1 token id, matching
    models.bpe_tokenizer.byte_level_french).

    Words ending in ``elision_suffix`` (l', d', qu'…) are treated as
    proclitics: their final node cannot close a word; instead it inherits
    the ROOT's transitions, so the next word attaches with no space —
    "l'histoire" is one whitespace token, as written in French.

    ``priors`` maps word → unigram probability; scores are log-probs
    centred on the median so the bonus biases rather than dominates.
    """
    trans_rows: list[np.ndarray] = [np.full(256, -1, np.int32)]
    can_end: list[bool] = [False]
    logp: list[float] = [0.0]

    def node_add() -> int:
        trans_rows.append(np.full(256, -1, np.int32))
        can_end.append(False)
        logp.append(0.0)
        return len(trans_rows) - 1

    elision_ends: list[int] = []
    floor = 1e-9
    for w in dict.fromkeys(words):  # stable de-dup
        bs = w.encode("utf-8")
        if not bs or SPACE in bs:
            continue
        cur = 0
        for b in bs:
            nxt = trans_rows[cur][b]
            if nxt < 0:
                nxt = node_add()
                trans_rows[cur][b] = nxt
            cur = nxt
        if w.endswith(elision_suffix):
            elision_ends.append(cur)
        else:
            can_end[cur] = True
            if priors:
                logp[cur] = float(np.log(max(priors.get(w, floor), floor)))
    trans = np.stack(trans_rows)
    # proclitics: continue straight into a fresh word (root transitions
    # win nothing over longer in-trie continuations — merge keeps both)
    for e in elision_ends:
        row = trans[e]
        trans[e] = np.where(row >= 0, row, trans[0])
    end = np.asarray(can_end, bool)
    scores = np.asarray(logp, np.float32)
    if priors:
        med = float(np.median(scores[end])) if end.any() else 0.0
        scores = np.where(end, scores - med, 0.0).astype(np.float32)
    else:
        scores = np.zeros_like(scores)
    return TrieTables(trans, end, scores)


def french_lexicon() -> tuple[list[str], dict[str, float]]:
    """(vocabulary, unigram priors) for the packaged checkpoint's decode.

    The vocabulary is exactly what the checkpoint was trained to spell —
    the synthetic sentence samplers' word lists (align.synth_speech WORDS ∪
    WORDS_RICH ∪ the grammar sampler's classes) plus the standard French
    proclitics. Priors are the unigram distribution of the grammar
    sampler (sample_sentences_fr), i.e. the same Zipf-like function-word
    statistics the decoder's implicit LM was trained on — shallow fusion
    with the TRAINING distribution, nothing fitted to evaluation text.
    """
    from .synth_speech import WORDS, WORDS_RICH, sampler_vocabulary, unigram_priors

    vocab = list(dict.fromkeys(WORDS + WORDS_RICH + sampler_vocabulary()))
    vocab += ["l'", "d'", "s'", "c'", "j'", "n'", "m'", "t'", "qu'", "jusqu'"]
    return vocab, unigram_priors()


@lru_cache(maxsize=2)
def default_trie() -> TrieTables:
    """The packaged aligner's trie (cached: ~5 k nodes, built once)."""
    vocab, priors = french_lexicon()
    return build_trie(vocab, priors)
