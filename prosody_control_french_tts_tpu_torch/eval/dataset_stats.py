"""Corpus statistics (Code/visualisation/analyze_dataset.py parity).

Reports files, speakers, audio hours, sentence counts, token counts (our
WordPiece tokenizer instead of a downloaded Roberta tokenizer), and the
punctuation distribution over a natural-corpus directory of
``<voice>__segment_phN.{wav,txt}`` pairs (or any wav+txt pairing).
"""

from __future__ import annotations

import re
from collections import Counter
from pathlib import Path

from ..utils.wavio import read_wav

_SENT = re.compile(r"[.!?]+")
_PUNCT = re.compile(r"[,;:.!?…«»\"']")


def analyze_dataset(corpus_dir: str | Path, tokenizer=None) -> dict:
    corpus_dir = Path(corpus_dir)
    wavs = sorted(corpus_dir.glob("*.wav"))
    stats = {
        "files": len(wavs),
        "speakers": len({w.stem.split("__")[0] for w in wavs}),
        "audio_hours": 0.0,
        "sentences": 0,
        "words": 0,
        "tokens": 0,
        "punctuation": Counter(),
    }
    texts = []
    for w in wavs:
        try:
            stats["audio_hours"] += read_wav(w).duration_seconds / 3600.0
        except (ValueError, FileNotFoundError):
            continue
        txt = w.with_suffix(".txt")
        if txt.exists():
            t = txt.read_text(encoding="utf-8")
            texts.append(t)
            stats["sentences"] += max(len(_SENT.findall(t)), 1)
            stats["words"] += len(t.split())
            stats["punctuation"].update(_PUNCT.findall(t))
    if tokenizer is None and texts:
        from ..models.tokenizer import WordPieceTokenizer

        tokenizer = WordPieceTokenizer.train(texts, vocab_size=2000, min_freq=1)
    if tokenizer is not None:
        stats["tokens"] = sum(len(tokenizer.encode(t)) for t in texts)
    stats["punctuation"] = dict(stats["punctuation"])
    return stats
