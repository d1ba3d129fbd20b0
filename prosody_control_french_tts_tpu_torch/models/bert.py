"""BERT-style encoder and break-tagging head, in PyTorch.

The port of the JAX package's flax encoder: token classification with two
labels (BREAK / NO_BREAK) over a pre-LN transformer with learned positions
and GELU, sized by ``BertConfig`` (the defaults are bert-base's geometry).
Batched inference of the tagger is the system's second north-star path.

The modules round where the flax modules round, not where PyTorch's
defaults would:

- the parameters are float32 (flax's ``param_dtype``); a layer with
  ``dtype=bfloat16`` casts its input and its kernel to bfloat16, rounds the
  product to bfloat16, then adds the bias in bfloat16 (two roundings, where
  ``F.linear``'s fused epilogue takes one);
- token and position embeddings are gathered from bfloat16 tables and
  summed in bfloat16, and the residual stream stays bfloat16;
- LayerNorm is float32 with epsilon 1e-6 and the variance as
  E[x²] − E[x]² (``layers.LayerNorm``);
- attention scores are a bfloat16 product divided in bfloat16 by
  sqrt(head_dim) (itself rounded to bfloat16); masked keys are set to the
  most negative bfloat16; the softmax runs in float32 and is cast to
  bfloat16 before the value product. The products are explicit: a fused
  attention kernel would skip the score rounding and the probabilities'
  cast;
- gelu is the tanh approximation (the flax model's default), rounded to
  bfloat16 once (``gelu``). XLA on the CPU rounds each of its operations
  instead: about 40 % of the elements then differ in the last bit, and the
  logits move by a few 1e-2 (``tests/test_torch_bert.py`` measures both);
- the classifier is a float32 layer, so TF32 must be off on the card
  (``ops.kernels.dsp_precision``).

Dropout draws its masks from an explicit ``torch.Generator`` (flax's
``Dropout``: keep with probability 1 − rate, scale the kept by
1 / (1 − rate) in the tensor's type); ``F.dropout`` takes no generator.
Parameters are initialised as flax initialises them (lecun-normal kernels,
zero biases, unit LayerNorm scales, N(0, 1/hidden) embeddings), drawn on
the CPU from a generator seeded with ``seed``, so one seed gives the same
weights on every device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import dsp_precision, resolve_device
from . import layers

BF16 = torch.bfloat16
_BF16_MIN = torch.finfo(BF16).min
_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 8000
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    ffn: int = 3072
    max_len: int = 128  # pause_bert.py:15 window
    dropout: float = 0.1
    num_labels: int = 2  # BREAK / NO_BREAK

    @classmethod
    def tiny(cls, vocab_size: int = 8000) -> "BertConfig":
        return cls(vocab_size=vocab_size, hidden=128, layers=2, heads=4, ffn=512)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax ``Dropout`` with its mask drawn from ``generator``."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a torch.Generator: pass generator= with deterministic=False")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The flax model's gelu (tanh approximation) in one pass, rounded once."""
    return F.gelu(x, approximate="tanh")


class Dense(nn.Module):
    """flax ``Dense`` / ``DenseGeneral`` with a float32 kernel flattened to
    [in, out]: x [..., in] → [..., out] in ``dtype``, the bias added after
    the product is rounded."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype = BF16):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))
        self.bias = nn.Parameter(torch.empty(d_out))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype)) + self.bias.to(self.dtype)


class LayerNorm(layers.LayerNorm):
    """flax ``LayerNorm(dtype=float32)`` with trainable scale and bias."""

    def __init__(self, dim: int):
        super().__init__(dim)
        self.requires_grad_(True)


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.heads = cfg.heads
        self.head_dim = cfg.hidden // cfg.heads
        self.rate = cfg.dropout
        self.qkv = Dense(cfg.hidden, 3 * cfg.heads * self.head_dim)  # flax [dim, 3, heads, hd]
        self.out = Dense(cfg.heads * self.head_dim, cfg.hidden)  # flax [heads, hd, dim]
        self.scale = float(torch.tensor(math.sqrt(self.head_dim)).to(BF16))

    def forward(self, x, mask, deterministic: bool = True, generator=None):
        B, L, _ = x.shape
        q, k, v = self.qkv(x).view(B, L, 3, self.heads, self.head_dim).permute(2, 0, 3, 1, 4).unbind(0)
        att = torch.matmul(q, k.transpose(-1, -2)) / self.scale  # [B, heads, L, L] bf16
        att = att.masked_fill(~mask[:, None, None, :], _BF16_MIN)
        att = torch.softmax(att, -1, dtype=torch.float32).to(BF16)
        if not deterministic:
            att = dropout(att, self.rate, generator)
        out = torch.matmul(att, v).transpose(1, 2).reshape(B, L, self.heads * self.head_dim)
        return self.out(out)


class Block(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.rate = cfg.dropout
        self.ln1 = LayerNorm(cfg.hidden)
        self.attn = SelfAttention(cfg)
        self.ln2 = LayerNorm(cfg.hidden)
        self.fc1 = Dense(cfg.hidden, cfg.ffn)
        self.fc2 = Dense(cfg.ffn, cfg.hidden)

    def forward(self, x, mask, deterministic: bool = True, generator=None):
        def drop(t):
            return t if deterministic else dropout(t, self.rate, generator)

        x = x + drop(self.attn(self.ln1(x), mask, deterministic, generator))
        h = gelu(self.fc1(self.ln2(x)))
        return x + drop(self.fc2(h))


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden))
        self.pos_emb = nn.Parameter(torch.empty(cfg.max_len, cfg.hidden))
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.layers))
        self.ln_f = LayerNorm(cfg.hidden)

    def forward(self, ids, mask, deterministic: bool = True, generator=None):
        """ids [B, L] (L ≤ max_len, every id < vocab_size), mask [B, L] bool
        → float32 [B, L, hidden]."""
        L = ids.shape[-1]
        x = F.embedding(ids.long(), self.tok_emb.to(BF16)) + self.pos_emb[:L].to(BF16)
        if not deterministic:
            x = dropout(x, self.cfg.dropout, generator)
        for blk in self.layers:
            x = blk(x, mask, deterministic, generator)
        return self.ln_f(x)


def lecun_normal(fan_in: int, shape, g: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated to ±2 standard deviations,
    scaled to variance 1 / fan_in (out-of-range draws are drawn again)."""
    w = torch.randn(shape, generator=g)
    bad = w.abs() > 2.0
    while bad.any():
        w[bad] = torch.randn(int(bad.sum()), generator=g)
        bad = w.abs() > 2.0
    return w * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def init_params(module: nn.Module, seed: int) -> None:
    """flax's default initialisers, drawn in module order on the CPU."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Dense):
                m.kernel.copy_(lecun_normal(m.kernel.shape[0], m.kernel.shape, g))
                m.bias.zero_()
            elif isinstance(m, layers.LayerNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, BertEncoder):
                for p in (m.tok_emb, m.pos_emb):
                    p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p.shape[1]))


class _Model(nn.Module):
    """Built on the CPU, initialised from ``seed`` (left uninitialised with
    ``seed=None``, for a ``load_state_dict`` to fill), then moved to
    ``device``."""

    def _finish(self, seed: int | None, device) -> None:
        dev = resolve_device(device)
        if seed is not None:
            init_params(self, seed)
        if dev.type == "cuda":
            dsp_precision()
        self.to(dev)


class BreakTagger(_Model):
    """Token-classification head over the encoder (pause_bert parity):
    ids [B, L], mask [B, L] → float32 logits [B, L, num_labels]."""

    def __init__(self, cfg: BertConfig, seed: int | None = 0, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.encoder = BertEncoder(cfg)
        self.classifier = Dense(cfg.hidden, cfg.num_labels, torch.float32)
        self._finish(seed, device)

    def forward(self, ids, mask, deterministic: bool = True, generator=None):
        return self.classifier(self.encoder(ids, mask, deterministic, generator))


class SentenceEncoder(_Model):
    """Mean-pooled, L2-normalised sentence embeddings [B, hidden] (float32):
    the hermetic stand-in for the reference's downloaded sentence encoder."""

    def __init__(self, cfg: BertConfig, seed: int | None = 0, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.encoder = BertEncoder(cfg)
        self._finish(seed, device)

    def forward(self, ids, mask, deterministic: bool = True, generator=None):
        h = self.encoder(ids, mask, deterministic, generator)
        m = mask[..., None].to(h.dtype)
        pooled = (h * m).sum(-2) / torch.clamp(m.sum(-2), min=1.0)
        return pooled / torch.clamp(torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-6)


def cross_entropy_loss(logits, labels, label_mask):
    """Masked token-level cross-entropy (labels −100 ignored, the HF
    convention the reference relies on, pause_bert.py:88-91)."""
    logp = torch.log_softmax(logits, -1)
    ll = torch.gather(logp, -1, torch.clamp(labels, min=0).long()[..., None])[..., 0]
    m = label_mask & (labels >= 0)
    return -(ll * m).sum() / torch.clamp(m.sum(), min=1)
