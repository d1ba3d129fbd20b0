"""Trainable WordPiece tokenizer (no network, no downloaded vocabularies).

The reference leans on downloaded HF vocabularies
(bert-base-multilingual-uncased for the break tagger, Qwen2.5 BPE for the
cascade). In a hermetic deployment the tokenizer is part of the framework:
a WordPiece vocabulary trained on the project's own training JSON (the
``x`` texts of bdd.json), with the same special-token and continuation
(``##``) conventions as BERT so the labeling logic of the break tagger
(first-subtoken labels) carries over. Host only; the port's own copy.
"""

from __future__ import annotations

import json
import re
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = [PAD, UNK, CLS, SEP, MASK]

_WORD_RE = re.compile(r"[\w'’]+|[^\w\s]", re.UNICODE)


def pretokenize(text: str) -> list[str]:
    return _WORD_RE.findall(text.lower())


@dataclass
class WordPieceTokenizer:
    vocab: dict[str, int] = field(default_factory=dict)
    max_word_len: int = 32

    # -- construction ---------------------------------------------------
    @classmethod
    def train(cls, texts: list[str], vocab_size: int = 8000, min_freq: int = 2) -> "WordPieceTokenizer":
        """Greedy WordPiece training (BPE-style pair merging over word
        frequency counts)."""
        word_freq = Counter()
        for t in texts:
            word_freq.update(pretokenize(t))

        # initial symbol inventory: characters (+ ## continuations)
        splits = {w: [w[0]] + [f"##{c}" for c in w[1:]] for w in word_freq}
        vocab = list(SPECIALS)
        seen = set(vocab)
        for w, pieces in splits.items():
            for p in pieces:
                if p not in seen:
                    seen.add(p)
                    vocab.append(p)

        def pair_scores():
            pair_freq = Counter()
            sym_freq = Counter()
            for w, f in word_freq.items():
                pieces = splits[w]
                for p in pieces:
                    sym_freq[p] += f
                for a, b in zip(pieces, pieces[1:]):
                    pair_freq[(a, b)] += f
            # WordPiece score: freq(ab) / (freq(a)·freq(b))
            return {
                p: f / (sym_freq[p[0]] * sym_freq[p[1]])
                for p, f in pair_freq.items()
                if f >= min_freq
            }

        while len(vocab) < vocab_size:
            scores = pair_scores()
            if not scores:
                break
            (a, b) = max(scores, key=scores.get)
            merged = a + b[2:] if b.startswith("##") else a + b
            if merged in seen:
                # merge the pieces in splits but skip re-adding
                pass
            else:
                seen.add(merged)
                vocab.append(merged)
            for w in splits:
                pieces = splits[w]
                out = []
                i = 0
                while i < len(pieces):
                    if i + 1 < len(pieces) and pieces[i] == a and pieces[i + 1] == b:
                        out.append(merged)
                        i += 2
                    else:
                        out.append(pieces[i])
                        i += 1
                splits[w] = out

        return cls(vocab={tok: i for i, tok in enumerate(vocab)})

    # -- persistence ------------------------------------------------------
    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.vocab, ensure_ascii=False), encoding="utf-8")

    @classmethod
    def load(cls, path: str | Path) -> "WordPieceTokenizer":
        return cls(vocab=json.loads(Path(path).read_text(encoding="utf-8")))

    # -- encoding ---------------------------------------------------------
    @property
    def pad_id(self) -> int:
        return self.vocab[PAD]

    @property
    def unk_id(self) -> int:
        return self.vocab[UNK]

    @property
    def cls_id(self) -> int:
        return self.vocab[CLS]

    @property
    def sep_id(self) -> int:
        return self.vocab[SEP]

    def __len__(self) -> int:
        return len(self.vocab)

    def word_to_pieces(self, word: str) -> list[str]:
        if len(word) > self.max_word_len:
            return [UNK]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def encode_words(self, words: list[str]) -> tuple[list[int], list[int]]:
        """→ (token_ids with [CLS]/[SEP], word_start_index per token; -1 for
        specials/continuations) — the first-subtoken convention the break
        tagger's labeling uses (pause_bert.py:74-91)."""
        ids = [self.cls_id]
        word_idx = [-1]
        for wi, w in enumerate(words):
            for k, piece in enumerate(self.word_to_pieces(w.lower())):
                ids.append(self.vocab.get(piece, self.unk_id))
                word_idx.append(wi if k == 0 else -1)
        ids.append(self.sep_id)
        word_idx.append(-1)
        return ids, word_idx

    def encode(self, text: str) -> list[int]:
        ids, _ = self.encode_words(pretokenize(text))
        return ids

    def pieces_with_boundaries(self, ids: list[int]) -> list[str]:
        """Per-token surface strings where a leading space marks a word
        start (the aligner's grouping contract): continuation pieces come
        through bare, word-initial pieces get the space prefix."""
        inv = {i: t for t, i in self.vocab.items()}
        out = []
        for i in ids:
            p = inv.get(i, UNK)
            if p in SPECIALS and p != UNK:
                out.append("")
            elif p.startswith("##"):
                out.append(p[2:])
            else:
                out.append(" " + p)
        return out

    def decode(self, ids: list[int]) -> str:
        inv = {i: t for t, i in self.vocab.items()}
        toks = [inv.get(i, UNK) for i in ids if inv.get(i) not in (PAD, CLS, SEP)]
        out = ""
        for t in toks:
            if t.startswith("##"):
                out += t[2:]
            else:
                out += (" " if out else "") + t
        return out
