"""The packaged Whisper aligner's checkpoint and its held-out gate.

Port of what inference needs from the JAX package's
``align/pretrain_whisper.py``: the packaged checkpoint's directory
(pretrained there on compositional synthetic French speech with byte-level
tokens and cross-attention supervision) and the held-out gate, which
measures word-boundary error and word accuracy through the transcript-free
alignment path (greedy KV-cache transcription + cross-attention DTW). The
pretraining recipe itself comes with the training slice.
"""

from __future__ import annotations

from difflib import SequenceMatcher
from pathlib import Path

import numpy as np

from ..utils.wavio import Audio
from .synth_speech import SynthSpec, synth_sentence

PACKAGED_DIR = Path(__file__).parent / "pretrained" / "whisper_fr_synth"


def boundary_error_ms(al, sentences: list[str], spec: SynthSpec, seed: int = 10_000, synth_fn=None) -> tuple[float, float]:
    """(mean |word-boundary error| ms, word accuracy) on freshly synthesized
    sentences, aligned with no transcript. Words are matched by sequence
    alignment (difflib, the WER convention) so that one inserted or dropped
    word costs itself, not every word after it. ``synth_fn`` picks the gold
    generator (default: the compositional synthesizer)."""
    synth = synth_fn or synth_sentence
    errs, hit, total = [], 0, 0
    for i, sent in enumerate(sentences):
        audio, gold = synth(sent, spec, seed=seed + i)
        tg = al.align(Audio(audio, spec.sample_rate))
        words = [(iv.min_time, iv.max_time, iv.mark) for iv in tg.tiers[0] if iv.mark.strip()]
        total += len(gold)
        sm = SequenceMatcher(a=[w.lower() for _, _, w in gold], b=[w.lower() for _, _, w in words], autojunk=False)
        for blk in sm.get_matching_blocks():
            for k in range(blk.size):
                hit += 1
                gt0, gt1, _ = gold[blk.a + k]
                t0, t1, _ = words[blk.b + k]
                errs.append(abs(gt0 - t0))
                errs.append(abs(gt1 - t1))
    if not errs:
        return float("inf"), 0.0
    return 1000.0 * float(np.mean(errs)), hit / max(total, 1)
