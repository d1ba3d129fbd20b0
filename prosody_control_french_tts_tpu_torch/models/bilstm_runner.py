"""BiLSTM prosody-regression experiment runner (bilstm.py parity).

``train_and_evaluate(bdd, seq_len, seed)`` reproduces the reference's
experiment surface (Code/baseline_models/bilstm.py:141-282): sentence
embeddings → sliding windows of SEQ_LEN∈{1..4} → BiLSTM regression of
z-scored [pitch, volume, rate], reporting both z-score and raw-% MSE/MAE.
Sentence embeddings come from the port's ``SentenceEncoder`` (the hermetic
stand-in for all-mpnet-base-v2).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.kernels import resolve_device
from .bert import BertConfig, SentenceEncoder
from .bilstm import BiLSTMConfig, BiLSTMProsody, sliding_windows, train_bilstm, zscore_calibrate
from .datasets import iter_voice_entries, sequence_to_prosody_rows
from .tokenizer import WordPieceTokenizer

log = logging.getLogger(__name__)


def init_encoder(cfg: BertConfig, seed: int, device) -> SentenceEncoder:
    """The encoder ``embed_sentences`` uses when given no parameters (tests
    replace it with the JAX package's initialisation, converted)."""
    return SentenceEncoder(cfg, seed=seed, device=device)


def embed_sentences(
    texts: list[str],
    tokenizer: WordPieceTokenizer,
    cfg: BertConfig | None = None,
    params: dict | None = None,
    batch: int = 64,
    seed: int = 0,
    device="cuda",
) -> np.ndarray:
    """Mean-pooled normalized embeddings [N, hidden] (float32). ``params``
    is a ``SentenceEncoder`` state_dict; without one, ``seed`` picks the
    encoder's initialisation (the substitution-contract tests measure that
    downstream results do not hinge on any one)."""
    dev = resolve_device(device)
    cfg = cfg or BertConfig.tiny(vocab_size=len(tokenizer))
    ids = np.full((len(texts), cfg.max_len), tokenizer.pad_id, np.int32)
    for i, t in enumerate(texts):
        e = tokenizer.encode(t)[: cfg.max_len]
        ids[i, : len(e)] = e
    mask = ids != tokenizer.pad_id
    if params is None:
        enc = init_encoder(cfg, seed, dev)
    else:
        enc = SentenceEncoder(cfg, seed=None, device=dev)
        enc.load_state_dict(params)
    enc.eval()

    out = []
    with torch.inference_mode():
        for i in range(0, len(texts), batch):
            out.append(enc(torch.as_tensor(ids[i : i + batch], device=dev), torch.as_tensor(mask[i : i + batch], device=dev)))
        return torch.cat(out).cpu().numpy()


@dataclass
class BiLSTMReport:
    seq_len: int
    z_mse: float
    z_mae: float
    raw_mse: dict[str, float]
    raw_mae: dict[str, float]
    n_train: int
    n_test: int


def train_and_evaluate(
    bdd: dict,
    seq_len: int = 3,
    seed: int = 42,
    tokenizer: WordPieceTokenizer | None = None,
    epochs: int = 40,
    device="cuda",
) -> BiLSTMReport:
    dev = resolve_device(device)
    texts, targets = [], []
    for _, seq in iter_voice_entries(bdd):
        for row in sequence_to_prosody_rows(seq):
            texts.append(row["text"])
            targets.append([row["pitch"], row["volume"], row["rate"]])
    targets = np.asarray(targets, np.float32)
    if tokenizer is None:
        tokenizer = WordPieceTokenizer.train(texts, vocab_size=2000, min_freq=1)
    emb = embed_sentences(texts, tokenizer, device=dev)

    z, (mu, sd) = zscore_calibrate(targets)
    xs, ys = sliding_windows(emb, z, seq_len)
    n = xs.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_test = max(1, int(n * 0.2))
    te, tr = perm[:n_test], perm[n_test:]

    state, _ = train_bilstm(xs[tr], ys[tr], seed=seed, epochs=epochs, device=dev)
    model = BiLSTMProsody(BiLSTMConfig(embed_dim=emb.shape[-1]), seed=None, device=dev)
    model.load_state_dict(state)
    with torch.inference_mode():
        pred_z = model(torch.as_tensor(np.asarray(xs[te], np.float32), device=dev)).cpu().numpy()
    err_z = pred_z - ys[te]
    pred_raw = pred_z * sd + mu
    gold_raw = ys[te] * sd + mu
    err_raw = pred_raw - gold_raw
    names = ["pitch", "volume", "rate"]
    return BiLSTMReport(
        seq_len=seq_len,
        z_mse=float(np.mean(err_z**2)),
        z_mae=float(np.mean(np.abs(err_z))),
        raw_mse={k: float(np.mean(err_raw[:, i] ** 2)) for i, k in enumerate(names)},
        raw_mae={k: float(np.mean(np.abs(err_raw[:, i]))) for i, k in enumerate(names)},
        n_train=len(tr),
        n_test=len(te),
    )


def seq_len_sweep(bdd: dict, seq_lens=(1, 2, 3, 4), seed: int = 42, **kw) -> list[BiLSTMReport]:
    """The reference's seeded multi-seq-len sweep (bilstm.py:274-282)."""
    return [train_and_evaluate(bdd, seq_len=s, seed=seed, **kw) for s in seq_lens]
