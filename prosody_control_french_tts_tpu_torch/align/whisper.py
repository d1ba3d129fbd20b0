"""Whisper-family encoder-decoder in PyTorch, with word-level timestamps.

Port of the JAX package's ``align/whisper_jax.py``, the replacement for the
reference's primary aligner, the whisper-timestamped stack
(Code/Aligners/use_whisper_timestamped.py):

- the model: log-mel front end (``ops.stft.log_mel``), conv×2 (stride 2)
  encoder with sinusoidal positions, pre-LN transformer; decoder with
  learned positions, causal self-attention with a KV cache (which refuses
  to overflow) and cross-attention, tied embedding head. It rounds where
  the flax model rounds: the projections, the feed-forward layers and the
  attention products in the config's ``dtype`` (bfloat16 by default;
  ``models.layers``), the softmax of the scores in float32, the LayerNorms
  and the head in float32; the encoder's residual stream is float32 and the
  decoder's in ``dtype``, as the flax model's type promotion makes them. The scores are ``torch.matmul``
  products, not a fused attention, so that they round as XLA rounds them;
- greedy transcription (``make_greedy_fn``): mel → encoder → each layer's
  cross-attention K/V once → KV-cached one-token decoder steps, optionally
  lexicon-constrained (``align.lexicon_decode``). The JAX package runs the
  loop as one ``lax.while_loop``; here it is a Python loop over steps that
  stops when every row is done, which gives the same tokens;
- word timestamps: the monotonic-partition DP over the time-normalised
  cross-attention (``ops.dtw``), run on the device for the whole batch;
- the reference's audio gates and degraded outputs (RMS < 100 at int16
  scale or silence ratio > 95 % → the "..." placeholder).

Everything here is plain PyTorch on the aligner's device: in the JAX
package it is XLA code, no Pallas kernel. For training
(``align.pretrain_whisper``), ``init_whisper`` draws flax's default
initialisation from a ``torch.Generator`` into float32 master weights
(``models.layers.master_weights``; the layers cast them in the forward),
the teacher-forced forward returns every layer's cross-attention weights
with their gradient, and ``WhisperAligner.save_pretrained`` writes a
checkpoint directory in the JAX layout (``config.json``, ``weights.npz``,
the tokenizer).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..convert import whisper_params_from_jax, whisper_params_to_jax
from ..models.layers import Dense, LayerNorm, embed_normal, gelu_erf_bf16, lecun_normal, master_weights
from ..ops.dtw import monotonic_partition_backtrack, monotonic_partition_costs, monotonic_partition_spans_batched
from ..ops.kernels import dsp_precision, resolve_device
from ..ops.stft import log_mel
from ..utils.textgridio import TextGrid
from ..utils.wavio import Audio, resample
from .base import AlignedWord, words_to_textgrid

SAMPLE_RATE = 16000
HOP = 160
FRAME_DT = 2 * HOP / SAMPLE_RATE  # encoder stride 2 → 20 ms per frame
PACKAGED_DIR = Path(__file__).parent / "pretrained" / "whisper_fr_synth"
BF16 = torch.bfloat16


@dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    dtype: torch.dtype = BF16
    n_audio_ctx: int = 1500  # 30 s windows
    n_text_ctx: int = 448
    dim: int = 384
    heads: int = 6
    enc_layers: int = 4
    dec_layers: int = 4
    vocab_size: int = 8000  # hermetic tokenizer; 51865 for ported weights

    @classmethod
    def tiny(cls, vocab_size: int = 8000) -> "WhisperConfig":
        return cls(dim=384, heads=6, enc_layers=4, dec_layers=4, vocab_size=vocab_size)

    @classmethod
    def test(cls, vocab_size: int = 256) -> "WhisperConfig":
        return cls(dim=64, heads=2, enc_layers=1, dec_layers=1, vocab_size=vocab_size, n_audio_ctx=200, n_text_ctx=64)

    @classmethod
    def base(cls, vocab_size: int = 51865) -> "WhisperConfig":
        return cls(dim=512, heads=8, enc_layers=6, dec_layers=6, vocab_size=vocab_size)

    @classmethod
    def small(cls, vocab_size: int = 51865) -> "WhisperConfig":
        return cls(dim=768, heads=12, enc_layers=12, dec_layers=12, vocab_size=vocab_size)

    @classmethod
    def medium(cls, vocab_size: int = 51865) -> "WhisperConfig":
        return cls(dim=1024, heads=16, enc_layers=24, dec_layers=24, vocab_size=vocab_size)

    @classmethod
    def from_json(cls, path: str | Path) -> "WhisperConfig":
        d = json.loads(Path(path).read_text(encoding="utf-8"))
        d.pop("dtype", None)
        return cls(**d)


def sinusoids(length: int, channels: int) -> np.ndarray:
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


class KVCache:
    """One layer's self-attention cache: keys and values [B, S, heads, hd],
    written in place at absolute positions. A write past S raises."""

    def __init__(self, B: int, S: int, heads: int, hd: int, dtype, device):
        self.k = torch.zeros((B, S, heads, hd), dtype=dtype, device=device)
        self.v = torch.zeros_like(self.k)

    def write(self, pos: int, k: torch.Tensor, v: torch.Tensor) -> None:
        L, S = k.shape[1], self.k.shape[1]
        if pos < 0 or pos + L > S:
            raise ValueError(f"KV cache overflow: positions {pos}..{pos + L - 1} in a cache of {S}")
        self.k[:, pos : pos + L] = k
        self.v[:, pos : pos + L] = v


class _MHA(nn.Module):
    """Multi-head attention with the three entry modes of the decode path:
    full (encoder, teacher-forced decoder), precomputed K/V (cross-attention
    at decode: K/V projected from the encoder once by ``kv_proj``) and
    KV-cached causal self-attention (masked by absolute position)."""

    def __init__(self, cfg: WhisperConfig, causal: bool = False):
        super().__init__()
        self.cfg, self.causal = cfg, causal
        self.q = Dense(cfg.dim, cfg.dim, dtype=cfg.dtype)
        self.k = Dense(cfg.dim, cfg.dim, bias=False, dtype=cfg.dtype)
        self.v = Dense(cfg.dim, cfg.dim, dtype=cfg.dtype)
        self.out = Dense(cfg.dim, cfg.dim, dtype=cfg.dtype)

    def _split(self, x: torch.Tensor) -> torch.Tensor:  # [B, L, dim] → [B, L, heads, hd]
        return x.reshape(*x.shape[:-1], self.cfg.heads, self.cfg.dim // self.cfg.heads)

    def kv_proj(self, x: torch.Tensor):
        return self._split(self.k(x)), self._split(self.v(x))

    def forward(self, q_in, kv_in=None, return_weights: bool = False, cache: KVCache | None = None, pos: int = 0, kv=None):
        hd = self.cfg.dim // self.cfg.heads
        q = self._split(self.q(q_in))
        if kv is not None:
            k, v = kv
        else:
            k, v = self.kv_proj(kv_in)
            if cache is not None:
                cache.write(pos, k, v)
                k, v = cache.k, cache.v
        # [B, heads, L, S] scores in the config's dtype, divided by sqrt(hd) in it
        att = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1))
        att = att / torch.tensor(float(np.float32(np.sqrt(hd))), dtype=att.dtype, device=att.device)
        if self.causal:
            L, S = q_in.shape[-2], att.shape[-1]
            qpos = torch.arange(L, device=att.device)[:, None] + (pos if cache is not None else S - L)
            mask = torch.arange(S, device=att.device)[None, :] <= qpos
            att = torch.where(mask, att, torch.finfo(att.dtype).min)
        w = torch.softmax(att.float(), dim=-1)
        o = torch.matmul(w.to(q.dtype), v.transpose(1, 2))  # [B, heads, L, hd]
        o = self.out(o.transpose(1, 2).reshape(*q_in.shape[:-1], self.cfg.dim))
        return o, (w if return_weights else None)


class _Block(nn.Module):
    def __init__(self, cfg: WhisperConfig, use_cross: bool = False, use_causal: bool = False):
        super().__init__()
        self.ln_attn = LayerNorm(cfg.dim)
        self.attn = _MHA(cfg, causal=use_causal)
        self.use_cross = use_cross
        if use_cross:
            self.ln_cross = LayerNorm(cfg.dim)
            self.cross = _MHA(cfg)
        self.ln_ffn = LayerNorm(cfg.dim)
        self.fc1 = Dense(cfg.dim, cfg.dim * 4, dtype=cfg.dtype)
        self.fc2 = Dense(cfg.dim * 4, cfg.dim, dtype=cfg.dtype)

    def forward(self, x, enc=None, collect_cross: bool = False, cache=None, pos: int = 0, kv=None):
        hn = self.ln_attn(x)  # pre-norm: K/V project from the same normed h as q
        h, _ = self.attn(hn, hn, cache=cache, pos=pos)
        x = x + h
        cross_w = None
        if self.use_cross:
            h, cross_w = self.cross(self.ln_cross(x), enc, return_weights=collect_cross, kv=kv)
            x = x + h
        x = x + self.fc2(_gelu(self.fc1(self.ln_ffn(x))))
        return x, cross_w


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact gelu, rounded after each operation in bfloat16."""
    return gelu_erf_bf16(x) if x.dtype == BF16 else F.gelu(x)


class _Conv(nn.Module):
    """flax ``Conv(dim, (3,), strides, padding=((1, 1),), dtype=dtype)``
    (torch ``Conv1d(padding=1)``) over [B, T, C] → [B, T', dim] in ``dtype``."""

    def __init__(self, c_in: int, c_out: int, stride: int, dtype: torch.dtype = BF16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, 3, dtype=dtype), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c_out, dtype=dtype), requires_grad=False)
        self.stride = stride

    def forward(self, x):
        y = F.conv1d(x.to(self.dtype).transpose(1, 2), self.weight.to(self.dtype), stride=self.stride, padding=1)
        return y.transpose(1, 2) + self.bias.to(self.dtype)


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.conv1 = _Conv(cfg.n_mels, cfg.dim, 1, cfg.dtype)
        self.conv2 = _Conv(cfg.dim, cfg.dim, 2, cfg.dtype)
        self.register_buffer("pos", torch.from_numpy(sinusoids(cfg.n_audio_ctx, cfg.dim)), persistent=False)
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.enc_layers))
        self.ln_post = LayerNorm(cfg.dim)

    def forward(self, mel):  # mel [B, T, n_mels] float32 → [B, ceil(T/2), dim] float32
        x = _gelu(self.conv1(mel))
        x = _gelu(self.conv2(x))
        x = x.float() + self.pos[: x.shape[-2]]  # float32 from here: the flax model promotes
        for blk in self.blocks:
            x, _ = blk(x)
        return self.ln_post(x)


class WhisperDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Module()
        self.tok_emb.embedding = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.dim), requires_grad=False)
        self.pos_emb = nn.Parameter(torch.zeros(cfg.n_text_ctx, cfg.dim), requires_grad=False)
        self.blocks = nn.ModuleList(_Block(cfg, use_cross=True, use_causal=True) for _ in range(cfg.dec_layers))
        self.ln_post = LayerNorm(cfg.dim)

    def _embed(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        """Token embeddings plus positions pos..pos+L-1, both rounded to
        the config's dtype and added in it (flax ``Embed(dtype=dtype)``)."""
        L = tokens.shape[-1]
        if pos + L > self.cfg.n_text_ctx:
            raise ValueError(f"decoder positions {pos}..{pos + L - 1} past n_text_ctx {self.cfg.n_text_ctx}")
        dt = self.cfg.dtype
        return self.tok_emb.embedding[tokens.long()].to(dt) + self.pos_emb[pos : pos + L].to(dt)

    def _head(self, x):
        return torch.matmul(self.ln_post(x), self.tok_emb.embedding.T)  # float32

    def forward(self, tokens, enc, collect_cross: bool = False):
        x = self._embed(tokens, 0)
        cross_ws = []
        for blk in self.blocks:
            x, w = blk(x, enc, collect_cross=collect_cross)
            if collect_cross and w is not None:
                cross_ws.append(w)
        return self._head(x), cross_ws

    def cross_kv(self, enc):
        """Per-layer (K, V) of the cross attention, projected once per
        segment: the decode loop never touches the encoder again."""
        return [blk.cross.kv_proj(enc) for blk in self.blocks]

    def step(self, tokens, pos: int, caches: list[KVCache], cross_kvs):
        """One decode step: ``tokens`` [B, L] at absolute positions
        pos..pos+L-1 against the caches (written in place). Returns (logits
        [B, L, V] float32, the cross-attention row [B, L, F] float32, head-
        and layer-averaged: the DTW timestamp input)."""
        x = self._embed(tokens, pos)
        rows = []
        for blk, cache, kv in zip(self.blocks, caches, cross_kvs):
            x, w = blk(x, collect_cross=True, cache=cache, pos=pos, kv=kv)
            rows.append(w.mean(dim=1))
        return self._head(x), torch.stack(rows).mean(dim=0)


class WhisperModel(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = WhisperEncoder(cfg)
        self.decoder = WhisperDecoder(cfg)

    def forward(self, mel, tokens, collect_cross: bool = False):
        return self.decoder(tokens, self.encoder(mel), collect_cross)

    def encode(self, mel):
        return self.encoder(mel)

    def decode(self, tokens, enc, collect_cross: bool = False):
        return self.decoder(tokens, enc, collect_cross)

    def cross_kv(self, enc):
        return self.decoder.cross_kv(enc)

    def decode_step(self, tokens, pos, caches, cross_kvs):
        return self.decoder.step(tokens, pos, caches, cross_kvs)


def init_whisper(model: WhisperModel, seed: int) -> None:
    """flax's default initialisation of ``WhisperModel``, drawn in module
    order on the CPU from a generator seeded with ``seed`` (the flax key's
    numbers differ: the parity tests load the converted flax initialisation
    instead): lecun-normal kernels (fan-in 3·in for the convolutions, the
    flattened input axes for the attention's projections), zero biases,
    unit LayerNorm scales, N(0, 1/dim) token embeddings and N(0, 0.01²)
    decoder positions."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, _Conv):
                c_out, c_in, k = m.weight.shape
                m.weight.copy_(lecun_normal(k * c_in, (k, c_in, c_out), g).permute(2, 1, 0))
                m.bias.zero_()
            elif isinstance(m, Dense):
                m.kernel.copy_(lecun_normal(m.kernel.shape[0], m.kernel.shape, g))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, WhisperDecoder):
                m.tok_emb.embedding.copy_(embed_normal(m.tok_emb.embedding.shape, g))
                m.pos_emb.copy_(torch.randn(m.pos_emb.shape, generator=g) * 0.01)


SPACE = 0x20


class _Marks:
    """Named time marks of one pass: CUDA events on a card (read after the
    pass, no synchronise in between), the host clock on the CPU, nothing
    for ``None``. ``read()`` gives the ms from each mark's predecessor (the
    first from the object's creation)."""

    def __init__(self, device):
        import time

        self.on = device is not None
        self.cuda = self.on and torch.device(device).type == "cuda"
        self.names, self.stamps = [], []
        self._clock = time.perf_counter
        self.start = self._stamp() if self.on else None

    def _stamp(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return self._clock()

    def mark(self, name: str) -> None:
        if self.on:
            self.names.append(name)
            self.stamps.append(self._stamp())

    def read(self) -> dict:
        out, prev = {}, self.start
        for name, st in zip(self.names, self.stamps):
            if self.cuda:
                st.synchronize()
                out[name] = prev.elapsed_time(st)
            else:
                out[name] = (st - prev) * 1e3
            prev = st
        return out


class _TrieDevice:
    """The lexicon trie's tables on the device (``lm_weight`` folded into
    the end bonus)."""

    def __init__(self, trie, lm_weight: float, device):
        self.trans = torch.from_numpy(np.asarray(trie.trans)).long().to(device)
        self.can_end = torch.from_numpy(np.asarray(trie.can_end)).to(device)
        self.bonus = torch.from_numpy(np.asarray(trie.end_bonus * np.float32(lm_weight), np.float32)).to(device)


def make_greedy_fn(model: WhisperModel, max_new: int, trie=None, lm_weight: float = 1.0, rep_limit: int = 2):
    """Greedy transcription: mel → encoder → per-layer cross-K/V → a loop
    of KV-cached one-token decoder steps that stops when every row is done
    (or after ``max_new`` steps).

    With ``trie`` (``align.lexicon_decode.TrieTables``) the argmax is
    lexicon-constrained shallow fusion: a per-row trie-node state gathers
    the legal continuations from the transition table, word-final nodes add
    their log-unigram bonus to the space/eot logit, and closing the same
    word (or the same two words in turn) more than ``rep_limit`` times in a
    row is forbidden. The byte tokenizer's ids 0..255 are the trie's byte
    axis.

    Returns fn(mel [B, T, n_mels], sot_id, eot_id, active [B] bool) →
    (tokens [B, max_new+1] int32 with tokens[:, 0] = sot, att [B, max_new+1,
    F] float32): att[s] is the layer/head-averaged cross-attention of the
    query at position s, rows 1..n the per-token DTW input. Rows with
    ``active`` False (batch padding to the power-of-two bucket) are done
    before step 0.
    """
    cfg = model.cfg
    tables = {}

    @torch.no_grad()
    def run(mel, sot_id: int, eot_id: int, active: torch.Tensor, marks=None):
        dev = mel.device
        marks = marks or _Marks(None)
        if trie is not None and dev not in tables:
            tables[dev] = _TrieDevice(trie, lm_weight, dev)
        tt = tables.get(dev)
        enc = model.encode(mel)
        cross_kvs = model.cross_kv(enc)
        marks.mark("encode_s")
        B, Fr = enc.shape[0], enc.shape[-2]
        hd = cfg.dim // cfg.heads
        total = max_new + 1
        caches = [KVCache(B, total, cfg.heads, hd, cfg.dtype, dev) for _ in range(cfg.dec_layers)]
        tokens = torch.full((B, total), eot_id, dtype=torch.int32, device=dev)
        tokens[:, 0] = sot_id
        att = torch.zeros((B, total, Fr), dtype=torch.float32, device=dev)
        # lexicon state: trie node per row, the last two closed words' end
        # nodes (word identity) and a consecutive-cycle count
        cur = torch.zeros(B, dtype=torch.long, device=dev)
        p1 = torch.full((B,), -1, dtype=torch.long, device=dev)
        p2 = torch.full((B,), -2, dtype=torch.long, device=dev)
        rep = torch.zeros(B, dtype=torch.long, device=dev)
        cols = None

        def pick_next(logits, cur, p1, p2, rep):
            nonlocal cols
            lg = logits.float()
            if tt is None:
                return torch.argmax(lg, dim=-1), cur, p1, p2, rep
            V = lg.shape[-1]
            if cols is None:
                cols = torch.arange(V, device=dev)[None, :]
            row = tt.trans[cur]  # [B, 256]
            endable = tt.can_end[cur]
            rep_block = ((cur == p1) & (rep >= rep_limit - 1)) | ((cur == p2) & (rep >= rep_limit))
            mask = F.pad(row >= 0, (0, V - 256))
            mask[:, SPACE] = endable & ~rep_block
            mask = mask | ((cols == eot_id) & (endable | (cur == 0))[:, None])
            add = torch.where((cols == eot_id) | (cols == SPACE), tt.bonus[cur][:, None], 0.0)
            nxt = torch.argmax(torch.where(mask, lg + add, -1e30), dim=-1)
            closes = nxt == SPACE
            new_cur = torch.where(closes | (nxt == eot_id), 0, tt.trans[cur, nxt.clamp(0, 255)])
            cyc = (cur == p1) | (cur == p2)
            rep = torch.where(closes, torch.where(cyc, rep + 1, 0), rep)
            p2 = torch.where(closes, p1, p2)
            p1 = torch.where(closes, cur, p1)
            return nxt, new_cur, p1, p2, rep

        done = ~active.to(dev)
        step = 0
        while step < max_new and not bool(done.all()):
            logits, row = model.decode_step(tokens[:, step : step + 1], step, caches, cross_kvs)
            att[:, step] = row[:, 0]
            nxt, cur, p1, p2, rep = pick_next(logits[:, -1], cur, p1, p2, rep)
            nxt = torch.where(done, eot_id, nxt)
            done = done | (nxt == eot_id)
            tokens[:, step + 1] = nxt.to(torch.int32)
            step += 1
        run.steps = step
        # one more decode step for the query at position max_new: rows that
        # hit the cap without emitting eot have all max_new tokens as text,
        # and the last one's attention row is never written by the loop.
        # Rows that finished early never read it.
        _, row = model.decode_step(tokens[:, max_new : max_new + 1], max_new, caches, cross_kvs)
        att[:, max_new] = row[:, 0]
        marks.mark("greedy_s")
        return tokens, att

    run.steps = 0
    return run


def _attention_spans_device(att, n, fr, max_rows: int):
    """Cross-attention rows → DTW spans on the device. att [B, R, F] (row
    1+t is text token t's attention), n [B] real token counts, fr [B] real
    encoder frames: per-token normalisation over the real frames, then the
    monotonic-partition DP with its ``<=`` tie rule → [B, max_rows, 2]."""
    Fr = att.shape[-1]
    dev = att.device
    w = att[:, 1 : 1 + max_rows, :]
    fmask = torch.arange(Fr, device=dev)[None, None, :] < fr[:, None, None]
    rmask = torch.arange(max_rows, device=dev)[None, :, None] < n[:, None, None]
    wm = w * fmask
    wn = wm / torch.clamp(wm.sum(dim=-1, keepdim=True), min=1e-9)
    cost = -(wn * rmask)
    return monotonic_partition_spans_batched(cost, n, fr)


def make_greedy_spans_fn(model: WhisperModel, max_new: int, trie=None, lm_weight: float = 1.0, rep_limit: int = 2):
    """The alignment pass: greedy decode (``make_greedy_fn``) + eot scan +
    cross-attention DTW + backtrack, all on the device. fn(mel, sot, eot,
    fr [B] int32, active [B] bool) → (tokens [B, max_new+1], n [B] token
    counts, spans [B, max_new, 2] frame indices)."""
    greedy = make_greedy_fn(model, max_new, trie=trie, lm_weight=lm_weight, rep_limit=rep_limit)

    @torch.no_grad()
    def run(mel, sot_id, eot_id, fr, active, marks=None):
        marks = marks or _Marks(None)
        tokens, att = greedy(mel, sot_id, eot_id, active, marks=marks)
        run.steps = greedy.steps
        is_eot = tokens[:, 1:] == eot_id
        n = torch.where(is_eot.any(dim=1), torch.argmax(is_eot.to(torch.uint8), dim=1), max_new)
        fr = fr.to(device=mel.device, dtype=torch.int64)
        spans = _attention_spans_device(att, n, fr, max_new)
        marks.mark("dtw_s")
        return tokens, n, spans

    run.steps = 0
    return run


# ---------------------------------------------------------------------------
# cross-attention DTW timestamps (whisper-timestamped technique)
# ---------------------------------------------------------------------------


def _frame_bucket(n_fr: int, step: int = 256) -> int:
    """Frame-axis pad bucket for the partition DP (D's column prefix is
    exact, so padding is free numerically)."""
    return max(step, ((n_fr + step - 1) // step) * step)


def spans_from_attention(w: np.ndarray, frame_dt: float = FRAME_DT, device="cuda") -> np.ndarray:
    """[tokens, frames] attention → [tokens, 2] start/end seconds:
    normalised per token, the monotonic-partition DP on the device, the
    O(L+F) backtrack on the host (rows padded to 16s, frames to 256s, as in
    the JAX package; both DP prefixes are exact)."""
    return spans_from_attention_batch([w], frame_dt, device=device)[0]


def spans_from_attention_batch(ws: list[np.ndarray], frame_dt: float = FRAME_DT, device="cuda") -> list[np.ndarray]:
    """Batched ``spans_from_attention``: every matrix pads to the common
    (token-bucket, frame-bucket, pow-2 batch) envelope, the DP runs once for
    all; each item's result equals its solo run."""
    if not ws:
        return []
    dev = resolve_device(device)
    ws = [np.asarray(w, np.float32) for w in ws]
    pad_l = max(((w.shape[0] + 15) // 16) * 16 for w in ws)
    pad_f = _frame_bucket(max(w.shape[1] for w in ws))
    pad_b = 1 << max(len(ws) - 1, 1).bit_length()
    cost = np.zeros((pad_b, pad_l, pad_f), np.float32)
    for i, w in enumerate(ws):
        w = w / np.maximum(w.sum(axis=-1, keepdims=True), 1e-9)
        cost[i, : w.shape[0], : w.shape[1]] = -w
    D = monotonic_partition_costs(torch.from_numpy(cost).to(dev)).cpu().numpy()
    return [
        monotonic_partition_backtrack(D[i, : w.shape[0] + 1, : w.shape[1] + 1]) * frame_dt for i, w in enumerate(ws)
    ]


def group_word_times(tokens: list[str], token_spans: np.ndarray) -> list[AlignedWord]:
    """Whitespace-boundary grouping of subword tokens into words."""
    words: list[AlignedWord] = []
    cur = ""
    t0 = None
    t1 = 0.0
    for tok, (s, e) in zip(tokens, token_spans):
        starts_word = tok.startswith(" ") or not cur
        if starts_word and cur:
            words.append(AlignedWord(t0, t1, cur.strip()))
            cur = ""
            t0 = None
        if t0 is None:
            t0 = float(s)
        cur += tok
        t1 = float(e)
    if cur.strip():
        words.append(AlignedWord(t0 or 0.0, t1, cur.strip()))
    return words


# ---------------------------------------------------------------------------
# audio gates (use_whisper_timestamped.py:197-261)
# ---------------------------------------------------------------------------


def check_audio_content(samples: np.ndarray, int_scale: float = 32768.0) -> tuple[bool, str]:
    data = np.asarray(samples, np.float32) * int_scale
    if data.size == 0:
        return False, "empty audio"
    rms = float(np.sqrt(np.mean(np.square(data))))
    silence_ratio = 1.0 - float(np.sum(np.abs(data) > 500) / data.size)
    if silence_ratio > 0.95:
        return False, f"File mainly contains silence ({silence_ratio:.2f})"
    if rms < 100:
        return False, f"Very low audio level (RMS={rms:.0f})"
    return True, "Audio valide"


EMPTY_TEXT = "..."
DISFLUENCY_MARK = "[*]"  # whisper-timestamped's pause/disfluency marker


def vad_speech_regions(
    audio: Audio,
    min_silence_ms: int = 400,
    silence_thresh_db: float = -40.0,
    keep_silence_ms: int = 100,
    device="cuda",
) -> list[tuple[float, float]]:
    """Energy-based VAD: speech spans in seconds (the auditok stand-in the
    reference passes to whisper.transcribe, use_whisper_timestamped.py:152).
    Raises ValueError mentioning ``max_silence`` on audio too short to
    window, the failure the reference's no-VAD retry catches (:163-170)."""
    from ..ops.energy import split_on_silence_ranges

    a = audio.to_mono()
    x = np.asarray(a.samples, np.float32)
    dur_ms = len(x) * 1000.0 / a.rate
    if dur_ms < 2 * min_silence_ms:
        raise ValueError(f"max_silence ({min_silence_ms} ms) is larger than audio duration")
    ranges = split_on_silence_ranges(x, a.rate, min_silence_ms, silence_thresh_db, keep_silence_ms, device=device)
    return [(s / 1000.0, e / 1000.0) for s, e in ranges]


def mark_disfluencies(
    words: list[AlignedWord],
    speech_regions: list[tuple[float, float]],
    min_gap_s: float = 0.3,
) -> list[AlignedWord]:
    """Insert ``[*]`` entries in word-stream gaps that fall inside detected
    speech (whisper-timestamped's detect_disfluencies,
    use_whisper_timestamped.py:154)."""

    def in_speech(t0: float, t1: float) -> bool:
        mid = 0.5 * (t0 + t1)
        return any(s <= mid <= e for s, e in speech_regions)

    out: list[AlignedWord] = []
    prev_end = speech_regions[0][0] if speech_regions else 0.0
    for w in sorted(words, key=lambda w: w.start):
        gap = w.start - prev_end
        if gap >= min_gap_s and in_speech(prev_end, w.start):
            out.append(AlignedWord(prev_end, w.start, DISFLUENCY_MARK))
        out.append(w)
        prev_end = max(prev_end, w.end)
    return out


class WhisperAligner:
    """Aligner-protocol wrapper: transcribe (greedy) + timestamps by
    cross-attention DTW, on ``device`` (CUDA by default; a CPU run is asked
    for with ``device="cpu"``). Built with no arguments it loads the
    packaged checkpoint (``pretrained/whisper_fr_synth``, a copy of the JAX
    package's)."""

    def __init__(
        self,
        cfg: WhisperConfig | None = None,
        params=None,
        tokenizer=None,
        weights_path=None,
        use_vad: bool = True,
        detect_disfluencies: bool = True,
        lexicon_decode: bool = True,
        lm_weight: float = 1.0,
        rep_limit: int = 2,
        device="cuda",
    ):
        from .ctc_aligner import load_params

        self.device = resolve_device(device)
        dsp_precision()
        if cfg is None and params is None and tokenizer is None and weights_path is None:
            if (PACKAGED_DIR / "weights.npz").exists():
                from ..models.bpe_tokenizer import load_whisper_tokenizer

                cfg = WhisperConfig.from_json(PACKAGED_DIR / "config.json")
                tokenizer = load_whisper_tokenizer(PACKAGED_DIR)
                weights_path = PACKAGED_DIR / "weights.npz"
        self.cfg = cfg or WhisperConfig.tiny()
        self.model = WhisperModel(self.cfg)
        self.tokenizer = tokenizer
        if weights_path is not None:
            params = load_params(weights_path)
        self.params = params
        if params is not None:
            self.model.load_state_dict(whisper_params_from_jax(params), strict=True)
        self.model.to(self.device).eval()
        self.use_vad = use_vad
        self.detect_disfluencies = detect_disfluencies
        # lexicon-constrained free decode: only for the byte-level hermetic
        # tokenizer, whose ids 0..255 are the trie's byte axis
        self.lexicon_decode = lexicon_decode and self._byte_level_tokenizer()
        self.lm_weight = lm_weight
        self.rep_limit = rep_limit
        self._fns: dict = {}
        #: the last ``align_batch``'s split (host clock after a device
        #: synchronise): seconds of the free jobs' mel (``mel_s``) and the
        #: rest of their pass (``free_s``), that pass split by device events
        #: into the encoder with the cross K/V, the greedy loop and the DTW
        #: spans (``encode_s``, ``greedy_s``, ``dtw_s``), the greedy steps
        #: taken, and the teacher-forced jobs' whole pass (``forced_s``)
        self.last_split: dict = {}

    @classmethod
    def from_pretrained(cls, path, **kwargs) -> "WhisperAligner":
        """A checkpoint directory: ``config.json``, ``weights.npz`` (flax
        layout) and a supported tokenizer artifact."""
        from ..models.bpe_tokenizer import load_whisper_tokenizer
        from .ctc_aligner import load_params

        p = Path(path)
        cfg = WhisperConfig.from_json(p / "config.json") if (p / "config.json").exists() else WhisperConfig.base()
        return cls(cfg, params=load_params(p / "weights.npz"), tokenizer=load_whisper_tokenizer(p), **kwargs)

    def init_params(self, seed: int = 0) -> dict:
        """Float32 master weights with flax's default initialisation
        (``init_whisper``) on the aligner's device; returns (and keeps as
        ``params``) the flax tree of numpy arrays."""
        from .ctc_aligner import nest

        self.model.cpu()
        master_weights(self.model)
        init_whisper(self.model, seed)
        self.model.to(self.device)
        self.params = nest(whisper_params_to_jax(self.model.state_dict(), self.cfg.heads))
        return self.params

    def load_params(self, params: dict) -> None:
        """Keep ``params`` (a flax tree) and load it into the model, whose
        parameters keep their storage type."""
        self.params = params
        self.model.load_state_dict(whisper_params_from_jax(params), strict=True)

    def save_pretrained(self, path) -> None:
        """A checkpoint directory the JAX package's ``from_pretrained`` (and
        this one) loads: ``config.json`` (the geometry), ``weights.npz``
        (``params`` as they are, '/'-joined flax keys) and the tokenizer."""
        import dataclasses

        from .ctc_aligner import save_params

        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        d = dataclasses.asdict(self.cfg)
        d.pop("dtype", None)
        (p / "config.json").write_text(json.dumps(d), encoding="utf-8")
        save_params(self.params, p / "weights.npz")
        if hasattr(self.tokenizer, "specials"):  # ByteLevelBPE artifact
            self.tokenizer.save(p / "tokenizer.bpe.json")
        elif hasattr(self.tokenizer, "save"):  # WordPiece vocab json
            self.tokenizer.save(p / "wordpiece_vocab.json")

    def _byte_level_tokenizer(self) -> bool:
        tok = self.tokenizer
        return tok is not None and getattr(tok, "merges", None) == {} and len(getattr(tok, "vocab", ())) == 256

    def _audio_window(self, audio: Audio) -> np.ndarray:
        """Mono, model rate, zero-padded to exactly the model window."""
        audio = audio.to_mono()
        if audio.rate != SAMPLE_RATE:
            audio = resample(audio, SAMPLE_RATE)
        x = np.asarray(audio.samples, np.float32)
        want = self.cfg.n_audio_ctx * 2 * HOP
        if x.shape[0] < want:
            x = np.pad(x, (0, want - x.shape[0]))
        return x[:want]

    def _mel_batch(self, xs: torch.Tensor) -> torch.Tensor:
        """[B, window] samples → [B, max_mel, n_mels] log-mels on the device."""
        mels = log_mel(xs, SAMPLE_RATE, n_fft=400, hop_length=HOP, n_mels=self.cfg.n_mels)
        return mels[:, : self.cfg.n_audio_ctx * 2]

    def features(self, audio: Audio) -> torch.Tensor:
        return self._mel_batch(torch.from_numpy(self._audio_window(audio)[None]).to(self.device))[0]

    def _stack_windows(self, jobs: list[dict]) -> torch.Tensor:
        """The jobs' windows (``j["xd"]``, on the device) stacked [Bp,
        window], padded with zero rows to the power-of-two batch."""
        B = len(jobs)
        Bp = 1 << max(B - 1, 1).bit_length()
        xs = torch.stack([j["xd"] for j in jobs])
        if Bp != B:
            xs = torch.cat([xs, torch.zeros((Bp - B, xs.shape[1]), dtype=xs.dtype, device=xs.device)])
        return xs

    def align(self, audio: Audio, transcript: str | None = None) -> TextGrid:
        return self.align_batch([audio], [transcript])[0]

    def align_batch(self, audios: list[Audio], transcripts: list[str | None] | None = None) -> list[TextGrid]:
        """Batched alignment: every clip's speech regions are planned on the
        host, then all transcript-free sub-clips decode in one batched
        greedy pass (padded to a power-of-two batch) with their DTWs, and
        all teacher-forced sub-clips in one batched encode+decode. Per clip
        the result is that of ``align``."""
        transcripts = list(transcripts) if transcripts is not None else [None] * len(audios)
        if len(transcripts) != len(audios):
            raise ValueError(f"align_batch: {len(audios)} audios but {len(transcripts)} transcripts")
        plans: list[dict] = []
        jobs: list[dict] = []
        for idx, (audio, transcript) in enumerate(zip(audios, transcripts)):
            a = audio.to_mono()
            ok, _reason = check_audio_content(np.asarray(a.samples))
            if not ok:
                # the gate precedes the weights requirement: the "..."
                # placeholder works without a model (reference parity)
                plans.append({"empty": True, "dur": a.duration_seconds})
                continue
            if self.params is None or self.tokenizer is None:
                raise ValueError("WhisperAligner needs weights + tokenizer")
            regions, clip_jobs = self._plan_jobs(a, transcript)
            for j in clip_jobs:
                j["clip"] = idx
                j["xd"] = torch.from_numpy(self._audio_window(j["audio"])).to(self.device)
            jobs.extend(clip_jobs)
            plans.append({"empty": False, "dur": a.duration_seconds, "regions": regions})

        self.last_split = {"mel_s": 0.0, "free_s": 0.0, "forced_s": 0.0, "steps": 0}
        free = [j for j in jobs if j["transcript"] is None]
        forced = [j for j in jobs if j["transcript"] is not None]
        if free:
            self._run_free_jobs(free)
        if forced:
            self._run_forced_jobs(forced)

        by_clip: dict[int, list[dict]] = {}
        for j in jobs:
            by_clip.setdefault(j["clip"], []).append(j)
        out: list[TextGrid] = []
        for idx, plan in enumerate(plans):
            dur = plan["dur"]
            if plan["empty"]:
                out.append(words_to_textgrid([AlignedWord(0.0, min(1.0, dur), EMPTY_TEXT)], dur))
                continue
            words: list[AlignedWord] = []
            for j in by_clip.get(idx, ()):
                sub_dur = j["audio"].duration_seconds
                for w in j.get("words", []):
                    words.append(AlignedWord(min(w.start, sub_dur) + j["t0"], min(w.end, sub_dur) + j["t0"], w.word))
            regions = plan["regions"]
            if self.detect_disfluencies:
                words = mark_disfluencies(words, regions if regions else [(0.0, dur)])
            # the reference's TextGrid replaces the marker with " "
            # (use_whisper_timestamped.py:375): pure markers become silences
            words = [AlignedWord(w.start, w.end, w.word.replace(DISFLUENCY_MARK, " ").strip()) for w in words]
            out.append(words_to_textgrid([w for w in words if w.word], dur))
        return out

    # -- planning (host) ---------------------------------------------------

    def _plan_jobs(self, audio: Audio, transcript: str | None):
        """(regions, jobs): VAD speech regions with transcript words
        apportioned by duration, then >window chunking: each job is a
        ≤window sub-clip with an absolute offset ``t0`` and an optional
        transcript."""
        regions: list[tuple[float, float]] | None = None
        if self.use_vad:
            try:
                regions = vad_speech_regions(audio, device=self.device)
            except ValueError as e:
                # audio too short for the VAD's window → run without VAD,
                # as the reference retries without it (:163-170)
                if "max_silence" not in str(e):
                    raise
                regions = None
        jobs: list[dict] = []
        if regions:
            words_all = transcript.split() if transcript is not None else None
            total_speech = sum(e - s for s, e in regions) or 1e-9
            wi = 0
            for k, (t0, t1) in enumerate(regions):
                sub = audio.slice_ms(t0 * 1000, t1 * 1000)
                if words_all is not None:
                    if k < len(regions) - 1:
                        share = int(round(len(words_all) * (t1 - t0) / total_speech))
                        chunk = words_all[wi : wi + max(share, 0)]
                    else:
                        chunk = words_all[wi:]
                    wi += len(chunk)
                    if not chunk:
                        continue
                    sub_tr = " ".join(chunk)
                else:
                    sub_tr = None
                jobs.extend(self._window_chunks(sub, sub_tr, t0))
        else:
            jobs = self._window_chunks(audio, transcript, 0.0)
        return regions, jobs

    def _window_chunks(self, audio: Audio, transcript: str | None, base_t0: float) -> list[dict]:
        """Split audio longer than the model window into ≤window jobs with
        word budgets apportioned by duration."""
        window_s = self.cfg.n_audio_ctx * FRAME_DT
        dur = audio.duration_seconds
        if dur <= window_s:
            return [{"t0": base_t0, "audio": audio, "transcript": transcript}]
        words_all = transcript.split() if transcript is not None else None
        out: list[dict] = []
        n_chunks = int(np.ceil(dur / window_s))
        wi = 0
        for c in range(n_chunks):
            t0 = c * window_s
            sub = audio.slice_ms(t0 * 1000, min((c + 1) * window_s, dur) * 1000)
            if words_all is not None:
                share = int(round(len(words_all) * sub.duration_seconds / dur))
                chunk_words = words_all[wi : wi + max(share, 0)] if c < n_chunks - 1 else words_all[wi:]
                wi += len(chunk_words)
                sub_tr = " ".join(chunk_words)
                if not sub_tr:
                    continue
            else:
                sub_tr = None
            out.extend(self._window_chunks(sub, sub_tr, base_t0 + t0))
        return out

    # -- execution (device) ------------------------------------------------

    def _sync_time(self) -> float:
        import time

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _real_frames(self, jobs: list[dict], Bp: int) -> torch.Tensor:
        """Real encoder frames per job (pad rows 1): the DP is restricted to
        them, so attention mass in the mel pad never places a word past the
        audio's end."""
        fr = np.ones(Bp, np.int64)
        for i, j in enumerate(jobs):
            fr[i] = max(1, int(np.ceil(j["audio"].duration_seconds / FRAME_DT)))
        return torch.from_numpy(np.minimum(fr, self.cfg.n_audio_ctx))

    def _run_free_jobs(self, free: list[dict], max_tokens: int = 128) -> None:
        """Transcript-free jobs: one batched greedy decode + DTW over the
        stacked mels (the batch padded to a power of two; pad rows inactive).
        Fills job["words"]."""
        max_new = min(max_tokens, self.cfg.n_text_ctx - 1)
        t0 = self._sync_time()
        xs = self._stack_windows(free)
        B, Bp = len(free), xs.shape[0]
        mels = self._mel_batch(xs)
        t1 = self._sync_time()
        key = ("spans", max_new)
        fn = self._fns.get(key)
        if fn is None:
            trie = None
            if self.lexicon_decode:
                from .lexicon_decode import default_trie

                trie = default_trie()
            fn = self._fns[key] = make_greedy_spans_fn(
                self.model, max_new, trie=trie, lm_weight=self.lm_weight, rep_limit=self.rep_limit
            )
        active = torch.zeros(Bp, dtype=torch.bool)
        active[:B] = True
        marks = _Marks(self.device)
        tokens, n, spans = fn(mels, self.tokenizer.cls_id, self.tokenizer.sep_id, self._real_frames(free, Bp),
                              active.to(self.device), marks=marks)
        tokens, n, spans = tokens[:B].cpu().numpy(), n[:B].cpu().numpy(), spans[:B].cpu().numpy()
        t2 = self._sync_time()
        self.last_split["mel_s"] += t1 - t0
        self.last_split["free_s"] += t2 - t1
        for name, ms in marks.read().items():
            self.last_split[name] = self.last_split.get(name, 0.0) + ms / 1e3
        self.last_split["steps"] += fn.steps
        for i, j in enumerate(free):
            ni = int(n[i])
            if ni == 0:
                j["words"] = []
                continue
            pieces = self.tokenizer.pieces_with_boundaries([int(t) for t in tokens[i, 1 : ni + 1]])
            j["words"] = group_word_times(pieces, spans[i, :ni] * FRAME_DT)

    @torch.no_grad()
    def _run_forced_jobs(self, forced: list[dict]) -> None:
        """Teacher-forced jobs (known transcripts): one batched encode +
        decode over the stacked mels and token rows (padded to a 16-bucket;
        causal self-attention keeps pad columns inert for the real rows),
        then one batched DTW. Fills job["words"]."""
        t0 = self._sync_time()
        tok_rows = []
        for j in forced:
            token_ids = self.tokenizer.encode(j["transcript"])[1:-1]
            j["_token_ids"] = token_ids
            tok_rows.append([self.tokenizer.cls_id] + token_ids)
        L = max(len(r) for r in tok_rows)
        Lb = min(((L + 15) // 16) * 16, self.cfg.n_text_ctx)
        ids = np.full((len(forced), Lb), self.tokenizer.sep_id, np.int32)
        for i, r in enumerate(tok_rows):
            ids[i, : min(len(r), Lb)] = r[:Lb]
        xs = self._stack_windows(forced)
        B, Bp = len(forced), xs.shape[0]
        if Bp != B:
            ids = np.pad(ids, ((0, Bp - B), (0, 0)), constant_values=self.tokenizer.sep_id)
        mels = self._mel_batch(xs)
        n_tok = np.zeros(Bp, np.int64)
        for i, j in enumerate(forced):
            n_tok[i] = min(len(j["_token_ids"]), Lb - 1)
        enc = self.model.encode(mels)
        _, cross = self.model.decode(torch.from_numpy(ids).to(self.device), enc, True)
        att = torch.stack([w.mean(dim=1) for w in cross]).mean(dim=0)  # [B, L, F]
        n_dev = torch.from_numpy(n_tok).to(self.device)
        fr = self._real_frames(forced, Bp).to(self.device)
        spans_all = _attention_spans_device(att, n_dev, fr, att.shape[1] - 1)[:B].cpu().numpy()
        self.last_split["forced_s"] += self._sync_time() - t0
        for i, j in enumerate(forced):
            # per-token surface strings with a leading space marking word
            # starts (both tokenizer families implement this)
            nt = int(n_tok[i])
            pieces = self.tokenizer.pieces_with_boundaries(j["_token_ids"][:nt])
            j["words"] = group_word_times(pieces, spans_all[i, :nt] * FRAME_DT)

    def _greedy_tokens(self, audio: Audio, max_tokens: int = 128) -> tuple[list[int], np.ndarray]:
        """Greedy KV-cache transcription (no lexicon) → (text token ids,
        their cross-attention rows [n, F])."""
        if self.params is None or self.tokenizer is None:
            raise ValueError("WhisperAligner needs weights + tokenizer")
        max_new = min(max_tokens, self.cfg.n_text_ctx - 1)
        key = ("greedy", max_new)
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = make_greedy_fn(self.model, max_new)
        mel = self.features(audio)
        tokens, att = fn(mel[None], self.tokenizer.cls_id, self.tokenizer.sep_id,
                         torch.ones(1, dtype=torch.bool, device=self.device))
        toks = tokens[0].cpu().numpy()
        eots = np.nonzero(toks[1:] == self.tokenizer.sep_id)[0]
        n = int(eots[0]) if eots.size else max_new
        return [int(t) for t in toks[1 : n + 1]], att[0, 1 : n + 1].cpu().numpy()

    def transcribe(self, audio: Audio, max_tokens: int = 128) -> str:
        token_ids, _ = self._greedy_tokens(audio, max_tokens)
        return self.tokenizer.decode(token_ids)
