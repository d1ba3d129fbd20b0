"""CTC forced alignment and the CTC loss.

Port of the JAX package's ``align/ctc.py``: given frame log-probabilities
from an acoustic model (``align.ctc_aligner.CTCEncoder``), Viterbi-align the
blank-interleaved label sequence to frames. The Viterbi is
``ops.ctc_viterbi`` (the CUDA kernel on the card, its plain version on the
CPU); ``states_to_words`` turns the state path into word spans. The
training loss, ``ctc_loss`` (the sum over alignments, differentiable with
respect to the log-probabilities), is ``ops.ctc_loss`` (the CUDA kernel
pair ``csrc/ctc_loss.cu`` on the card, its plain version on the CPU).
"""

from __future__ import annotations

import numpy as np

from ..ops.ctc_loss import ctc_loss
from ..ops.ctc_viterbi import NEG, ctc_forced_align, ctc_forced_align_plain, expand_labels

__all__ = ["NEG", "ctc_forced_align", "ctc_forced_align_plain", "ctc_loss", "expand_labels", "states_to_words"]


def states_to_words(
    states: np.ndarray,
    labels: list[int],
    word_spans: list[tuple[int, int]],
    frame_dt: float,
    words: list[str],
):
    """Expanded-state path → word time spans.

    word_spans: label-index [start, end) per word (labels are e.g.
    characters or phonemes). Returns [(t0, t1, word)].
    """
    states = np.asarray(states)
    lab_idx = np.where(states % 2 == 1, states // 2, -1)  # -1 = blank
    out = []
    for (ls, le), w in zip(word_spans, words):
        frames = np.nonzero((lab_idx >= ls) & (lab_idx < le))[0]
        if frames.size == 0:
            continue
        out.append((float(frames[0] * frame_dt), float((frames[-1] + 1) * frame_dt), w))
    return out
