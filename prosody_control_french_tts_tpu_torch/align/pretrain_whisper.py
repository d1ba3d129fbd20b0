"""Pretraining recipe for the packaged Whisper aligner, and its held-out
gate.

Port of the JAX package's ``align/pretrain_whisper.py``. The reference's
primary aligner downloads a published Whisper model
(Code/Aligners/use_whisper_timestamped.py:92-104); with no network, the
shipped ``aligner: whisper`` checkpoint is pretrained here on synthetic
French speech (``align.synth_speech``, and the narrator-matched
``align.formant_speech``) with two supervision signals a sentence:

- next-token cross-entropy on ``[sot] + utf8 bytes + [eot]`` (1 byte = 1
  token, ``models.bpe_tokenizer.byte_level_french``), label smoothing 0.1;
- cross-attention supervision: each byte token's layer- and head-averaged
  cross-attention is pushed onto its character's gold encoder-frame span
  (−log of the attention mass inside the span), which pins the maps the
  DTW timestamp extractor walks.

The whole prepared dataset lives on the device (``att_target`` as uint8,
about 100 MB for 1,536 sentences) and each step gathers its batch by an
index vector there. Adam follows ``optax.adam(warmup_cosine_decay_schedule(
0, lr, warmup, total, lr/10))`` (``models.schedules``): the first update's
learning rate is 0. The held-out gate runs the transcript-free production
path (greedy KV-cache transcription + DTW) on the float16-rounded weights
that ship; a failed gate leaves them in ``<out_dir>.failed`` and raises.
The packaged checkpoint stays where it is unless ``out_dir`` names it.
"""

from __future__ import annotations

import logging
import time
from difflib import SequenceMatcher
from pathlib import Path

import numpy as np
import torch

from ..models.bpe_tokenizer import byte_level_french
from ..models.schedules import ScheduledAdam, warmup_cosine_decay_schedule
from ..ops.stft import log_mel
from ..utils.wavio import Audio
from .ctc_aligner import half_tree, nest
from .synth_speech import WORDS_RICH, SynthSpec, sample_sentences, sample_sentences_fr, synth_sentence
from .whisper import FRAME_DT, HOP, SAMPLE_RATE, WhisperAligner, WhisperConfig, WhisperModel

log = logging.getLogger(__name__)

PACKAGED_DIR = Path(__file__).parent / "pretrained" / "whisper_fr_synth"


def synth_fr_config() -> WhisperConfig:
    """Geometry of the shipped checkpoint (≈6.3 M parameters; the 10.24 s
    window covers the longest sampled sentence)."""
    return WhisperConfig(
        n_mels=80,
        n_audio_ctx=512,
        n_text_ctx=128,
        dim=256,
        heads=4,
        enc_layers=3,
        dec_layers=3,
        vocab_size=1864,  # 256 byte tokens + the Whisper special table
    )


def _byte_char_spans(sent: str, char_spans) -> list[tuple[float, float]] | None:
    """Per-utf8-byte (t0, t1) spans: each byte of a character inherits the
    character's gold span (inter-word spaces included). None when the
    synthesizer dropped a character."""
    if len(char_spans) != len(sent):
        return None
    out: list[tuple[float, float]] = []
    for ch, (t0, t1, c) in zip(sent, char_spans):
        if c != ch:
            return None
        out.extend([(t0, t1)] * len(ch.encode("utf-8")))
    return out


def _domain_synth(domain: str):
    """Per-sentence (synth_fn, spec) cycle of a training domain: "synth"
    (the compositional synthesizer), "formant" (the narrator-matched formant
    synthesizer), "mixed" (both in turn), "mixed2" (1 compositional : 2
    formant)."""
    from . import formant_speech

    comp = (synth_sentence, SynthSpec())
    form = (formant_speech.synth_sentence, formant_speech.FormantSpec())
    if domain == "synth":
        return [comp]
    if domain == "formant":
        return [form]
    if domain == "mixed":
        return [comp, form]
    if domain == "mixed2":
        return [comp, form, form]
    raise ValueError(f"unknown domain {domain!r}")


def _prep_batches(al: WhisperAligner, sentences: list[str], spec: SynthSpec, batch: int, seed: int, synth_fns=None):
    """Host-side prep → mel [N, 2·ctx, n_mels] float32, ids [N, L] int32
    (eot-padded), n_text [N] int32, att_target [N, L−1, F] bool (the gold
    frame span of each decoder-input byte token; sot/eot/pad rows empty), N
    a multiple of ``batch``. The mels are computed on the aligner's device
    in chunks of 64 windows."""
    cfg, tok = al.cfg, al.tokenizer
    L = cfg.n_text_ctx
    Fr = cfg.n_audio_ctx
    max_mel = cfg.n_audio_ctx * 2
    want = max_mel * HOP
    waves, ids_all, n_all, tgt_all = [], [], [], []
    if synth_fns is None:
        synth_fns = [(synth_sentence, spec)]
    for i, sent in enumerate(sentences):
        fn, sp = synth_fns[i % len(synth_fns)]
        audio, _, chars = fn(sent, sp, seed=seed + i, with_chars=True)
        spans = _byte_char_spans(sent, chars)
        ids = tok.encode(sent)  # [sot] + bytes + [eot]
        if spans is None or len(ids) > L or audio.shape[0] > want:
            continue
        waves.append(np.pad(np.asarray(audio, np.float32), (0, want - audio.shape[0])))
        ids_all.append(np.pad(np.asarray(ids, np.int32), (0, L - len(ids)), constant_values=tok.sep_id))
        n_all.append(len(ids) - 2)  # text bytes
        tgt = np.zeros((L - 1, Fr), bool)
        for p, (t0, t1) in enumerate(spans):  # byte token p sits at position p + 1
            lo = int(np.floor(t0 / FRAME_DT))
            hi = max(int(np.ceil(t1 / FRAME_DT)), lo + 1)
            tgt[p + 1, lo : min(hi, Fr)] = True
        tgt_all.append(tgt)
    nb = (len(waves) // batch) * batch
    if spec.sample_rate != SAMPLE_RATE:
        raise ValueError(f"the recipe synthesizes at {SAMPLE_RATE} Hz, got {spec.sample_rate}")
    with torch.no_grad():
        mels = [
            log_mel(torch.from_numpy(np.stack(waves[s : s + 64])).to(al.device), SAMPLE_RATE, n_fft=400, hop_length=HOP,
                    n_mels=cfg.n_mels)[:, :max_mel].cpu().numpy()
            for s in range(0, nb, 64)
        ]
    return (
        np.concatenate(mels)[:nb],
        np.stack(ids_all[:nb]),
        np.asarray(n_all[:nb], np.int32),
        np.stack(tgt_all[:nb]),
    )


def whisper_loss(logits: torch.Tensor, cross: list, ids: torch.Tensor, n_text: torch.Tensor,
                 att_target: torch.Tensor, att_weight: float):
    """(ce + att_weight · att, ce, att) of a teacher-forced batch: logits
    [B, L−1, V] for the inputs ids[:, :−1]; cross, each layer's
    cross-attention weights [B, heads, L−1, F] float32; ids [B, L]; n_text
    [B]; att_target [B, L−1, F] float32 (1 in the gold span)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, ids[:, 1:].long()[..., None])[..., 0]
    smooth = 0.1
    ll = (1.0 - smooth) * ll + smooth * logp.mean(-1)
    pos = torch.arange(ids.shape[1] - 1, device=ids.device)[None, :]
    tmask = (pos <= n_text[:, None]).float()  # the text bytes and the real eot
    ce = -(ll * tmask).sum() / tmask.sum().clamp(min=1.0)
    w = torch.stack([c.mean(dim=1) for c in cross]).mean(dim=0)  # [B, L−1, F]
    mass = (w * att_target).sum(-1)
    amask = ((pos >= 1) & (pos <= n_text[:, None])).float()  # the byte-token queries
    att = -(torch.log(mass + 1e-8) * amask).sum() / amask.sum().clamp(min=1.0)
    return ce + att_weight * att, ce, att


def whisper_schedule(lr: float, total_steps: int):
    warmup = min(50, max(total_steps // 10, 1))
    return warmup_cosine_decay_schedule(0.0, lr, warmup, max(total_steps, warmup + 1), lr * 0.1)


def _make_step(model: WhisperModel, lr: float, total_steps: int, att_weight: float):
    """The device-resident step: the dataset stays on the device and each
    step gathers its batch by ``idx``. step(idx, mel_all, ids_all, n_all,
    tgt_all) → (loss, ce, att) 0-d tensors on the device."""
    opt = ScheduledAdam(model.parameters(), whisper_schedule(lr, total_steps))

    def step(idx, mel_all, ids_all, n_all, tgt_all):
        mel = mel_all[idx]
        ids = ids_all[idx]
        n_text = n_all[idx]
        att_target = tgt_all[idx].float()
        opt.zero_grad()
        logits, cross = model(mel, ids[:, :-1], collect_cross=True)
        loss, ce, att = whisper_loss(logits, cross, ids, n_text, att_target, att_weight)
        loss.backward()
        opt.step()
        return loss.detach(), ce.detach(), att.detach()

    return step


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


def training_sentences(n_sentences: int, seed: int, domain: str) -> list[str]:
    """The recipe's sentences: for the narrator domains half from the
    grammatical Zipf sampler and half uniform draws from ``WORDS_RICH``,
    shuffled by ``default_rng(seed + 1)``; else the core sampler."""
    if domain in ("mixed", "mixed2", "formant"):
        half = n_sentences // 2
        sentences = sample_sentences_fr(half, seed=seed) + sample_sentences(n_sentences - half, seed=seed, vocab=WORDS_RICH)
        np.random.default_rng(seed + 1).shuffle(sentences)
        return sentences
    return sample_sentences(n_sentences, seed=seed)


def pretrain(
    out_dir: str | Path = PACKAGED_DIR,
    n_sentences: int = 1536,
    epochs: int = 12,
    batch: int = 16,
    lr: float = 3e-4,
    att_weight: float = 0.5,
    seed: int = 0,
    target_boundary_ms: float = 60.0,
    target_word_acc: float = 0.9,
    domain: str = "mixed2",
    target_formant_word_acc: float = 0.7,
    device="cuda",
) -> tuple[WhisperAligner, float, float]:
    """Train, gate on held-out boundary error and word accuracy (both
    through the transcript-free production path) and, for the narrator
    domains, formant-domain word accuracy; save the float16 checkpoint
    directory. The aligner keeps each epoch's (mean ce, mean att) as
    ``history`` and the gates' values as ``gates``."""
    spec = SynthSpec()
    cfg = synth_fr_config()
    al = WhisperAligner(cfg, tokenizer=byte_level_french(), device=device)
    sentences = training_sentences(n_sentences, seed, domain)
    mel, ids, n_text, att_target = _prep_batches(al, sentences, spec, batch, seed, _domain_synth(domain))
    log.info("pretraining whisper on %d sentences, mel %s", mel.shape[0], mel.shape)
    al.init_params(seed)
    al.model.train()
    steps_per_epoch = mel.shape[0] // batch
    step = _make_step(al.model, lr, epochs * steps_per_epoch, att_weight)
    dev = al.device
    mel_d = torch.from_numpy(mel).to(dev)
    ids_d = torch.from_numpy(ids).to(dev)
    n_d = torch.from_numpy(n_text).to(dev)
    tgt_d = torch.from_numpy(att_target.astype(np.uint8)).to(dev)
    rng = np.random.default_rng(seed)
    t0 = time.time()
    al.history = []
    for epoch in range(epochs):
        order = rng.permutation(mel.shape[0])
        ep_ce, ep_att = [], []
        for s in range(0, steps_per_epoch * batch, batch):
            idx = torch.from_numpy(order[s : s + batch]).to(dev)
            _, ce, att = step(idx, mel_d, ids_d, n_d, tgt_d)
            ep_ce.append(ce)
            ep_att.append(att)
        ce_m, att_m = float(torch.stack(ep_ce).mean()), float(torch.stack(ep_att).mean())
        al.history.append((ce_m, att_m))
        log.info("epoch %d: ce %.4f att %.4f (%.0fs)", epoch, ce_m, att_m, time.time() - t0)
    del mel_d, ids_d, n_d, tgt_d

    # gate what ships: the float16-rounded weights
    al.model.eval()
    from ..convert import whisper_params_to_jax

    al.load_params(nest(half_tree(whisper_params_to_jax(al.model.state_dict(), cfg.heads))))
    holdout = sample_sentences(32, seed=seed + 777)
    err_ms, acc = boundary_error_ms(al, holdout, spec)
    log.info("held-out boundary error: %.1f ms, word accuracy %.3f", err_ms, acc)
    form_acc = 1.0
    if domain in ("mixed", "mixed2", "formant"):
        from . import formant_speech

        held = sample_sentences_fr(16, seed=seed + 778) + sample_sentences(16, seed=seed + 778, vocab=WORDS_RICH)
        _, form_acc = boundary_error_ms(al, held, formant_speech.FormantSpec(), synth_fn=formant_speech.synth_sentence)
        log.info("held-out formant-domain word accuracy %.3f", form_acc)
    al.gates = {"boundary_ms": err_ms, "word_acc": acc, "formant_word_acc": form_acc}
    out_dir = Path(out_dir)
    if err_ms > target_boundary_ms or acc < target_word_acc or form_acc < target_formant_word_acc:
        # keep the rejected weights inspectable, never in the packaged directory
        failed = out_dir.parent / (out_dir.name + ".failed")
        al.save_pretrained(failed)
        raise RuntimeError(
            f"gate failed: boundary {err_ms:.1f} ms (≤{target_boundary_ms}), "
            f"word acc {acc:.3f} (≥{target_word_acc}), "
            f"formant acc {form_acc:.3f} (≥{target_formant_word_acc}); weights at {failed}"
        )
    al.save_pretrained(out_dir)
    size = sum(f.stat().st_size for f in out_dir.iterdir())
    log.info("saved %s (%.1f MiB)", out_dir, size / 2**20)
    return al, err_ms, acc
