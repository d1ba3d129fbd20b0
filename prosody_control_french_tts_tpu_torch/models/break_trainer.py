"""Break-tagger training and bootstrap evaluation (pause_bert.py parity).

The reference trains bert-base-multilingual-uncased for 10 epochs at batch
64 and reports mean±std perplexity/F1 over 10 bootstrap resampling runs
(Code/baseline_models/pause_bert.py:101-115,135-146,212-253). This module
reproduces that harness on the port's tagger with the hermetic WordPiece
tokenizer: every step (forward, backward, AdamW update) runs on the
trainer's device, and evaluation is batched inference there.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.kernels import dsp_precision, resolve_device
from .bert import BertConfig, BreakTagger, cross_entropy_loss
from .datasets import IGNORE, BreakTagDataset, build_break_dataset
from .tokenizer import WordPieceTokenizer

log = logging.getLogger(__name__)

WEIGHT_DECAY = 1e-4  # optax.adamw's default (torch.optim.AdamW's is 1e-2)


@dataclass
class BreakMetrics:
    f1: float
    precision: float
    recall: float
    accuracy: float
    perplexity: float


def _load(model, params) -> torch.device:
    """Put ``params`` (a state_dict, or None for the model's own) into the
    model; returns the model's device."""
    if params is not None:
        model.load_state_dict(params)
    return next(model.parameters()).device


def evaluate_tagger(model: BreakTagger, params, ds: BreakTagDataset, batch_size: int = 64) -> BreakMetrics:
    """Masked-token P/R/F1 on the BREAK class + label perplexity
    (pause_bert.py:212-239 reporting), on the model's device."""
    dev = _load(model, params)
    tp = fp = fn = correct = total = 0
    nll_sum = 0.0
    for i in range(0, ds.ids.shape[0], batch_size):
        with torch.inference_mode():
            ids = torch.as_tensor(ds.ids[i : i + batch_size], device=dev)
            mask = torch.as_tensor(ds.mask[i : i + batch_size], device=dev)
            logits = model(ids, mask).cpu().numpy()
        labels = ds.labels[i : i + batch_size]
        logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        valid = labels != IGNORE
        pred = logits.argmax(-1)
        tp += int(((pred == 1) & (labels == 1) & valid).sum())
        fp += int(((pred == 1) & (labels == 0) & valid).sum())
        fn += int(((pred == 0) & (labels == 1) & valid).sum())
        correct += int(((pred == labels) & valid).sum())
        total += int(valid.sum())
        safe_labels = np.where(valid, labels, 0)
        nll_sum += float(-(np.take_along_axis(logp, safe_labels[..., None], -1)[..., 0] * valid).sum())
    prec = tp / (tp + fp) if tp + fp else 0.0
    rec = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    ppl = float(np.exp(nll_sum / max(total, 1)))
    return BreakMetrics(f1=f1, precision=prec, recall=rec, accuracy=correct / max(total, 1), perplexity=ppl)


def init_tagger(cfg: BertConfig, seed: int, device) -> BreakTagger:
    """The tagger ``train_tagger`` starts from (tests replace it with the JAX
    package's initialisation, converted)."""
    return BreakTagger(cfg, seed=seed, device=device)


def train_tagger(
    ds: BreakTagDataset,
    cfg: BertConfig,
    *,
    epochs: int = 10,  # pause_bert.py:17
    batch_size: int = 64,  # :18
    lr: float = 5e-5,
    seed: int = 0,
    device="cuda",
    losses: list | None = None,
):
    """AdamW (optax's defaults: b1 0.9, b2 0.999, eps 1e-8, weight decay
    1e-4 on every parameter) over ``epochs`` passes in the order of
    ``np.random.default_rng(seed)``, dropout masks from a generator seeded
    with ``seed`` on the device. Returns (model, state_dict, last loss); the
    loss is read from the device once, at the end, unless ``losses`` asks
    for every step's (appended to it)."""
    dev = resolve_device(device)
    model = init_tagger(cfg, seed, dev).train()
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=WEIGHT_DECAY)
    gen = torch.Generator(device=dev).manual_seed(seed)

    n = ds.ids.shape[0]
    nprng = np.random.default_rng(seed)
    loss = torch.zeros(())
    for _ in range(epochs):
        order = nprng.permutation(n)
        for i in range(0, n, batch_size):
            b = order[i : i + batch_size]
            mask = torch.as_tensor(ds.mask[b], device=dev)
            logits = model(torch.as_tensor(ds.ids[b], device=dev), mask, deterministic=False, generator=gen)
            loss = cross_entropy_loss(logits, torch.as_tensor(ds.labels[b], device=dev), mask)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            if losses is not None:
                losses.append(float(loss.detach()))
    model.eval()
    return model, {k: v.detach().clone() for k, v in model.state_dict().items()}, float(loss.detach())


def bootstrap_runs(
    bdd: dict,
    tokenizer: WordPieceTokenizer,
    cfg: BertConfig | None = None,
    runs: int = 10,  # pause_bert.py:101 bootstrap count
    test_frac: float = 0.2,
    epochs: int = 10,
    seed: int = 0,
    device="cuda",
) -> dict:
    """Bootstrap resampling harness: per run, resample train split with
    replacement, train, evaluate on the held-out split; report mean±std
    (pause_bert.py:101-115,240-253) and keep the best-F1 parameters."""
    cfg = cfg or BertConfig.tiny(vocab_size=len(tokenizer))
    ds = build_break_dataset(bdd, tokenizer, max_len=cfg.max_len)
    n = ds.ids.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_test = max(1, int(n * test_frac))
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    test = BreakTagDataset(ds.ids[test_idx], ds.mask[test_idx], ds.labels[test_idx])

    results: list[BreakMetrics] = []
    best = (-1.0, None)
    for r in range(runs):
        boot = rng.choice(train_idx, size=len(train_idx), replace=True)
        sub = BreakTagDataset(ds.ids[boot], ds.mask[boot], ds.labels[boot])
        model, params, _ = train_tagger(sub, cfg, epochs=epochs, seed=seed + r, device=device)
        m = evaluate_tagger(model, None, test)
        results.append(m)
        if m.f1 > best[0]:
            best = (m.f1, params)
        log.info("bootstrap run %d: F1=%.3f ppl=%.3f", r, m.f1, m.perplexity)

    def agg(attr):
        v = np.array([getattr(m, attr) for m in results])
        return {"mean": float(v.mean()), "std": float(v.std())}

    return {
        "runs": [dataclasses.asdict(m) for m in results],
        "f1": agg("f1"),
        "precision": agg("precision"),
        "recall": agg("recall"),
        "accuracy": agg("accuracy"),
        "perplexity": agg("perplexity"),
        "best_params": best[1],
        "config": cfg,
    }


def sentences_per_second(model: BreakTagger, params, ds: BreakTagDataset, batch_size: int = 256, iters: int = 10,
                         device="cuda") -> float:
    """The second north-star metric: batched inference throughput of the
    tagger, in sentences a second. ``iters`` forwards run back to back on
    the device with no host read between them, and one synchronisation at
    the end. Guards against elided work, as in the JAX package: each step's
    token ids differ (the step index is mixed into every live id), the whole
    output is summed into the accumulator, and the timed run's ``shift``
    differs from the warm-up's."""
    dev = resolve_device(device)
    if _load(model, params).type != dev.type:
        raise ValueError(f"the model is on {next(model.parameters()).device}, but device={str(dev)!r} was asked for")
    if dev.type == "cuda":
        dsp_precision()
    ids = torch.as_tensor(np.resize(ds.ids, (batch_size, ds.ids.shape[1])), device=dev)
    mask = torch.as_tensor(np.resize(ds.mask, (batch_size, ds.mask.shape[1])), device=dev)
    V = int(model.cfg.vocab_size)

    def run(shift: int, n: int) -> float:
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        with torch.inference_mode():
            for i in range(n):
                step_ids = torch.where(mask, (ids + (i + shift)) % V, ids)
                acc = acc + model(step_ids, mask).sum().float()
        return float(acc)  # the one host read (and synchronisation)

    run(0, min(2, iters))  # warm-up: allocator, cuBLAS algorithm choice
    t0 = time.perf_counter()
    acc = run(1, iters)
    dt = time.perf_counter() - t0
    if not np.isfinite(acc):
        raise FloatingPointError(f"tagger outputs summed to {acc}")
    return batch_size * iters / dt
