"""The packaged CTC aligner's checkpoint and its held-out gate.

Port of what inference needs from the JAX package's
``align/pretrain_ctc.py``: the path of the packaged checkpoint (pretrained
there on compositional synthetic French speech, ``align.synth_speech``)
and the held-out word-boundary error that gates it. The pretraining recipe
itself comes with the training slice.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.wavio import Audio
from .synth_speech import SynthSpec, synth_sentence

PACKAGED_WEIGHTS = Path(__file__).parent / "pretrained" / "ctc_fr_synth.npz"


def boundary_error_ms(al, sentences: list[str], spec: SynthSpec, seed: int = 10_000) -> float:
    """Mean |word-boundary error| in ms on freshly synthesized sentences
    with gold spans, aligned against their transcripts (words matched in
    order, equal words only)."""
    errs = []
    for i, sent in enumerate(sentences):
        audio, gold = synth_sentence(sent, spec, seed=seed + i)
        tg = al.align(Audio(audio, spec.sample_rate), sent)
        words = [(iv.min_time, iv.max_time, iv.mark) for iv in tg.tiers[0] if iv.mark.strip()]
        for (gt0, gt1, gw), (t0, t1, w) in zip(gold, words):
            if gw.lower() == w.lower():
                errs.append(abs(gt0 - t0))
                errs.append(abs(gt1 - t1))
    if not errs:
        return float("inf")
    return 1000.0 * float(np.mean(errs))
