"""Pretraining recipe for the packaged CTC aligner, and its held-out gate.

Port of the JAX package's ``align/pretrain_ctc.py``. The reference's
aligner backends work without per-project training because they download
pretrained acoustic models (Use_MFA.py, NeMo.py, CTCFA.py); this recipe
makes the equivalent shipped artifact for ``aligner: ctc``: it trains the
default-geometry ``CTCEncoder`` on compositional synthetic French speech
(``align.synth_speech``), gates it on the held-out word-boundary error
against gold spans, and writes float16 weights in the JAX layout.

Training is frame-supervised, not CTC: the synthesizer returns gold
character timing, so a per-frame cross-entropy pins every emission to its
acoustic evidence (pure CTC lets the global attention emit a word's
characters in a burst at its end). The batches are padded [B, T, M] mels
with frame targets (−1 on padding, ignored by the loss), and the encoder
runs with no attention mask, as the JAX step applies it: padded frames take
part in the global attention. The packaged checkpoint stays where it is
unless ``out_path`` names it: callers that only exercise the recipe pass
another path.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from ..utils.wavio import Audio
from ..models.layers import master_weights
from .ctc_aligner import CTCAligner, half_tree, save_params
from .synth_speech import SynthSpec, sample_sentences, synth_sentence

log = logging.getLogger(__name__)

PACKAGED_WEIGHTS = Path(__file__).parent / "pretrained" / "ctc_fr_synth.npz"

# Label time of encoder frame j (nominal time 20j ms): the pooled frame's
# acoustic centre is 5 ms later (centred STFT frames) and states_to_words
# reports spans from frame left edges (another half frame); the JAX package
# calibrated the offset against gold spans.
_ENC_HOP_S = 0.02
_ENC_OFFSET_S = 0.010


def _frame_targets(char_spans, n_enc_frames: int, vocab) -> np.ndarray:
    """Gold char id per encoder frame; 0 (blank) for silence (edges)."""
    out = np.zeros(n_enc_frames, np.int32)
    centers = _ENC_HOP_S * np.arange(n_enc_frames) + _ENC_OFFSET_S
    for t0, t1, c in char_spans:
        lo = np.searchsorted(centers, t0, "left")
        hi = np.searchsorted(centers, t1, "left")
        out[lo:hi] = vocab.chars.index(c) + 1
    return out


def _prep_batches(al: CTCAligner, sentences: list[str], spec: SynthSpec, batch: int, seed: int):
    """Host-side prep: padded [N, T, M] mels (T a multiple of 128) + [N, T/2]
    frame targets (−1 = padding), N a multiple of ``batch``."""
    mels, targets = [], []
    for i, sent in enumerate(sentences):
        audio, _, chars = synth_sentence(sent, spec, seed=seed + i, with_chars=True)
        mel = al.features(Audio(audio, spec.sample_rate)).cpu().numpy()
        n_enc = mel.shape[0] // 2
        if n_enc < 4:
            continue
        mels.append(mel)
        targets.append(_frame_targets(chars, n_enc, al.vocab))
    T = int(np.ceil(max(m.shape[0] for m in mels) / 128) * 128)
    n = (len(mels) // batch) * batch
    mel_arr = np.zeros((n, T, al.n_mels), np.float32)
    tgt_arr = np.full((n, T // 2), -1, np.int32)
    for i in range(n):
        mel_arr[i, : mels[i].shape[0]] = mels[i]
        tgt_arr[i, : targets[i].shape[0]] = targets[i]
    return mel_arr, tgt_arr


def frame_ce_loss(logits: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the frames whose target is not −1: logits
    [B, T', V] float32, tgt [B, T'] int."""
    logp = torch.log_softmax(logits, dim=-1)
    valid = tgt >= 0
    ce = -torch.gather(logp, -1, tgt.clamp(min=0).long()[..., None])[..., 0]
    return torch.where(valid, ce, 0.0).sum() / valid.sum().clamp(min=1)


def _make_step(al: CTCAligner, lr: float):
    """Adam (optax.adam(lr)'s constants) on the frame cross-entropy; the
    encoder becomes float32 master weights. step(mel [B, T, M], tgt [B,
    T/2]) → loss (0-d tensor on the device)."""
    model = al.model
    master_weights(model).train()
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def step(mel: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = frame_ce_loss(model(mel), tgt)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


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


def pretrain(
    out_path: str | Path = PACKAGED_WEIGHTS,
    n_sentences: int = 384,
    epochs: int = 12,
    batch: int = 8,
    lr: float = 1e-3,
    seed: int = 0,
    target_boundary_ms: float = 60.0,
    device="cuda",
) -> tuple[CTCAligner, float]:
    """Train, gate on held-out boundary error, save float16 weights."""
    spec = SynthSpec()
    al = CTCAligner(device=device)
    al.init_params(seed)
    sentences = sample_sentences(n_sentences, seed=seed)
    mel, tgt = _prep_batches(al, sentences, spec, batch, seed)
    log.info("pretraining on %d sentences, mel %s", mel.shape[0], mel.shape)
    step = _make_step(al, lr)
    mel_d = torch.from_numpy(mel).to(al.device)
    tgt_d = torch.from_numpy(tgt).to(al.device)
    rng = np.random.default_rng(seed)
    t0 = time.time()
    for epoch in range(epochs):
        order = rng.permutation(mel.shape[0])
        ep = []
        for s in range(0, len(order), batch):
            idx = torch.from_numpy(order[s : s + batch]).to(al.device)
            ep.append(step(mel_d[idx], tgt_d[idx]))
        log.info("epoch %d: loss %.4f (%.0fs)", epoch, float(torch.stack(ep).mean()), time.time() - t0)
    al.model.eval()
    al.params = al.flax_params()

    holdout = sample_sentences(32, seed=seed + 777)
    err_ms = boundary_error_ms(al, holdout, spec)
    log.info("held-out boundary error: %.1f ms", err_ms)
    if err_ms > target_boundary_ms:
        raise RuntimeError(f"boundary error {err_ms:.1f} ms > {target_boundary_ms} ms gate")

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    save_params(half_tree(al.params), out_path)
    log.info("saved %s (%.1f KiB)", out_path, out_path.stat().st_size / 1024)
    return al, err_ms
