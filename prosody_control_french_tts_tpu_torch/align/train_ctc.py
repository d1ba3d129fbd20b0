"""Training the CTC aligner on a project's own speech (the per-project recipe).

Port of the JAX package's ``align/train_ctc.py``: bootstraps the ``aligner:
ctc`` backend from wav + transcript pairs, the role MFA's pretrained
acoustic models play for the reference (Use_MFA.py), with nothing
downloaded:

- corpus: any directory of ``X.wav`` + ``X.txt`` pairs (a voice's
  ``audio`` + ``transcription`` directories, or the natural corpus built by
  ``audio.corpus.build_natural_corpus``), each clip cut at 20 s;
- training: ``CTCAligner.make_train_step`` on each utterance's log-mel
  (Adam, the CTC loss: the kernels of ``csrc/ctc_loss.cu`` on the card,
  four launches a step), the utterances in the order of
  ``np.random.default_rng(seed).permutation`` each epoch;
- output: float32 weights in the JAX layout (``ctc_aligner.npz``), loadable
  by either package (``aligner_options: {weights_path: …}``).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from ..ops.kernels import resolve_device
from ..utils.wavio import read_wav
from .ctc_aligner import CTCAligner, save_params

log = logging.getLogger(__name__)


def load_pairs(corpus_dir: str | Path, max_seconds: float = 20.0):
    """[(Audio, transcript)] for every wav with a sibling txt."""
    pairs = []
    for wav in sorted(Path(corpus_dir).glob("*.wav")):
        txt = wav.with_suffix(".txt")
        if not txt.exists():
            continue
        try:
            a = read_wav(wav).to_mono()
        except (ValueError, FileNotFoundError):
            continue
        if a.duration_seconds > max_seconds:
            a = a.slice_ms(0, max_seconds * 1000)
        text = txt.read_text(encoding="utf-8").strip().lower()
        if text:
            pairs.append((a, text))
    return pairs


def train_ctc_aligner(
    corpus_dir: str | Path,
    out_path: str | Path = "ctc_aligner.npz",
    epochs: int = 20,
    lr: float = 3e-4,
    dim: int = 128,
    layers: int = 2,
    seed: int = 0,
    device="cuda",
) -> tuple[CTCAligner, list[float]]:
    """Train a fresh encoder (flax's initialisation, ``seed``) on the
    corpus; returns the aligner and each epoch's mean loss, and writes the
    weights to ``out_path``."""
    resolve_device(device)
    pairs = load_pairs(corpus_dir)
    if not pairs:
        raise FileNotFoundError(f"no wav+txt pairs under {corpus_dir}")
    log.info("training CTC aligner on %d utterances", len(pairs))

    al = CTCAligner(dim=dim, layers=layers, device=device)
    al.init_params(seed)
    step = al.make_train_step(lr=lr)

    prepped = []  # features and labels, once
    for a, text in pairs:
        mel = al.features(a)
        labels = al.vocab.encode(" ".join(text.split()))
        if not labels or mel.shape[0] // 2 < len(labels):
            continue  # CTC needs T >= L
        prepped.append((mel, labels))

    rng = np.random.default_rng(seed)
    losses = []
    for epoch in range(epochs):
        order = rng.permutation(len(prepped))
        ep = []
        for i in order:
            mel, labels = prepped[i]
            ep.append(step(mel, mel.shape[0] // 2, labels, len(labels)))
        losses.append(float(sum(float(x) for x in ep)) / max(len(prepped), 1))
        log.info("epoch %d: mean CTC loss %.3f", epoch, losses[-1])
    al.model.eval()
    al.params = al.flax_params()
    save_params(al.params, out_path)
    log.info("saved CTC aligner weights to %s", out_path)
    return al, losses
