"""Decoder-only LLM (Qwen2-family geometry) with LoRA, and its serving path.

The replacement for the reference's cascaded Qwen2.5-7B stages: stage A tags
break positions in plain text, stage B fills prosody values into a templated
SSML — both are instruction-tuned causal LMs with LoRA adapters. RMSNorm
(pre-norm), rotary position embeddings, grouped-query attention, SwiGLU MLP,
untied LM head — dimensioned by config (``qwen25_7b`` matches the
reference's checkpoints; ``tiny`` runs in tests).

Two layouts, as in the JAX package:

- the **training layout**, :class:`DecoderLM`: separate q/k/v/o/gate/up/down
  ``LoRALinear`` projections with float32, bfloat16 (frozen) or quantized
  base kernels stored ``[in, out]``, KV caches ``[B, S, kv_heads, hd]``; the
  training step over it is ``models.training``, its attention
  ``ops.vmem_attn`` at short sequence lengths or ``ops.flash_attention`` at
  any length, and its loss ``ops.fused_ce`` (hand-written CUDA kernels on
  the card, forward and backward);
- the **serving layout**, :func:`fuse_decode_params`: LoRA folded into the
  base, q|k|v and gate|up concatenated, everything bfloat16 (optionally an
  int8 weight stream, :func:`quantize_fused_decode_params`), KV caches packed
  ``[B, S, kv_heads·hd]``. Its decode step runs attention in
  ``ops.decode_attn`` (a hand-written CUDA kernel on the card).

PyTorch runs eagerly: the greedy loops here are Python loops, caches are
updated in place, and ``pos`` is a host integer.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from ..core import profiling
from ..ops import decode_attn, flash_attention, fused_ce, vmem_attn
from ..ops.kernels import dsp_precision, resolve_device
from .lora import LoRALinear, lecun_normal_


@dataclass(frozen=True)
class LLMConfig:
    vocab_size: int = 8192
    dim: int = 256
    layers: int = 2
    heads: int = 8
    kv_heads: int = 2
    ffn: int = 512
    max_len: int = 1024  # the reference's truncation length
    rope_theta: float = 1e6
    lora_rank: int = 8
    lora_alpha: float = 16.0
    dtype: torch.dtype = torch.bfloat16
    # weight-only base-kernel storage: None (float) | "int8" (per-channel)
    # | "nf4" (4-bit blockwise, the checkpoint/train format) | "int8b"
    # (blockwise int8 — NF4 recoded for serving, quant.recode_params_nf4_serving)
    quant: str | None = None
    # training-path attention: "dot" (mask + softmax with the [B, H, L, L]
    # score tensor in device memory) | "vmem" (ops.vmem_attn: score rows stay
    # on chip, forward and backward; L a multiple of 128 up to
    # vmem_attn.MAX_L) | "flash" (ops.flash_attention, the counterpart of the
    # upstream Pallas TPU flash-attention op: K/V tiles streamed with an
    # online softmax, forward and backward; any L that is a positive multiple
    # of 128, K/V repeated to all heads). Both apply only to the pure causal
    # no-cache shape; decode, padded-mask calls and other L use "dot".
    attn_impl: str = "dot"
    # q|k|v and gate|up as ONE matmul each at apply time (LoRA adapters ride
    # along as [A_q|A_k|A_v] and a block-diagonal B): fewer launches, x read
    # once. The state_dict is unchanged: the concat happens in the forward.
    fused_qkv: bool = False
    # recompute each decoder layer in the backward pass instead of storing
    # its activations (no-cache calls only)
    remat: bool = False
    # with remat=True: None saves nothing (full recompute); "dots" saves the
    # matrix products' outputs and recomputes the elementwise work
    remat_policy: str | None = None

    def __post_init__(self):
        if self.attn_impl not in ("dot", "vmem", "flash"):
            raise ValueError(f"LLMConfig.attn_impl={self.attn_impl!r}: expected 'dot', 'vmem' or 'flash'")
        if self.remat_policy not in (None, "dots"):
            raise ValueError(f"LLMConfig.remat_policy={self.remat_policy!r}: expected None or 'dots'")

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "LLMConfig":
        return cls(vocab_size=vocab_size, dim=64, layers=2, heads=4, kv_heads=2, ffn=128, max_len=128)

    @classmethod
    def qwen25_7b(cls, vocab_size: int = 152064) -> "LLMConfig":
        return cls(
            vocab_size=vocab_size,
            dim=3584,
            layers=28,
            heads=28,
            kv_heads=4,
            ffn=18944,
            max_len=1024,
            rope_theta=1e6,
        )

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


def rope_tables(positions: torch.Tensor, d: int, theta: float):
    """cos and sin of the rotary angles, float32 [..., L, 1, d/2], for integer
    positions [..., L]. One forward computes them once for all its layers."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) / d))
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate x [..., L, H, D] by the tables of :func:`rope_tables`:
    half-split (GPT-NeoX/Qwen2) convention, computed in float32, cast back."""
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [..., L, H, D] at integer positions [..., L]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def _write_cache(cache: torch.Tensor, new: torch.Tensor, cache_pos: int) -> None:
    """In-place ``cache[:, cache_pos : cache_pos + L] = new``; a write that
    would run past the cache raises."""
    L, S = new.shape[1], cache.shape[1]
    if cache_pos < 0 or cache_pos + L > S:
        raise ValueError(f"cache write of {L} rows at {cache_pos} runs past the cache's {S} rows")
    cache[:, cache_pos : cache_pos + L] = new.to(cache.dtype)


def _masked_attention(q, k, v, mask, kv_heads: int) -> torch.Tensor:
    """GQA attention with a boolean mask [B or 1, L, K]: q [B, L, H, hd],
    k/v [B, K, kv_heads, hd] → [B, L, H·hd]. Scores are divided by √hd
    rounded to q's dtype, masked with the dtype's minimum, softmaxed in
    float32 and cast back before the second product."""
    B, L, H, hd = q.shape
    group = H // kv_heads
    qg = q.reshape(B, L, kv_heads, group, hd)
    root = float(torch.tensor(math.sqrt(hd), dtype=torch.float32).to(q.dtype))  # host scalar
    att = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / root
    att = torch.where(mask[:, None, None, :, :], att, torch.finfo(att.dtype).min)
    att = torch.softmax(att.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", att, v).reshape(B, L, H * hd)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones((dim,), dtype=torch.float32, device=device))

    def forward(self, x):
        var = x.float().square().mean(dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.scale.to(x.dtype)


def _fused_lora_matmul(x, parts, alpha: float):
    """One matmul over N concatenated ``LoRALinear`` parameter surfaces.

    ``parts`` are ``(kernel, bias, lora_a, lora_b)`` tuples from
    ``LoRALinear.surface()`` (all with bias or none, all with adapters or
    none). Computes the per-projection outputs side by side:
    ``x @ [W1|…|WN] + [b1|…|bN] + (α/r)·(x @ [A1|…|AN]) @ blockdiag(B)``.
    Each output column's contraction is unchanged (the off-block zeros of
    blockdiag(B) add exact 0.0 terms), so results match the per-projection
    matmuls."""
    y = x @ torch.cat([p[0] for p in parts], dim=1)
    if parts[0][1] is not None:
        y = y + torch.cat([p[1] for p in parts]).to(y.dtype)
    if parts[0][2] is not None:
        rank = parts[0][2].shape[1]
        acat = torch.cat([p[2] for p in parts], dim=1).to(x.dtype)
        bblk = torch.block_diag(*[p[3].to(x.dtype) for p in parts])
        y = y + (alpha / rank) * ((x @ acat) @ bblk)
    return y


_NO_SHARDED_SERVING = "a tensor-parallel model has no serving path (KV caches, the fused serving tree)"


class Attention(nn.Module):
    shards = None  # set by parallel.sharding.shard_params

    def __init__(self, cfg: LLMConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        kw = dict(rank=cfg.lora_rank, alpha=cfg.lora_alpha, dtype=cfg.dtype, quant=cfg.quant, device=device, generator=generator)
        # q/k/v carry biases (Qwen2 convention); o does not
        self.q = LoRALinear(cfg.dim, cfg.heads * hd, use_bias=True, **kw)
        self.k = LoRALinear(cfg.dim, cfg.kv_heads * hd, use_bias=True, **kw)
        self.v = LoRALinear(cfg.dim, cfg.kv_heads * hd, use_bias=True, **kw)
        self.o = LoRALinear(cfg.heads * hd, cfg.dim, **kw)

    def forward(self, x, positions, mask, cache=None):
        c = self.cfg
        hd = c.head_dim
        B, L = x.shape[0], x.shape[1]
        heads, kv_heads = c.heads, c.kv_heads
        if self.shards is not None:
            # the rank's heads: a contiguous block of q heads and of KV heads,
            # so each q head's KV group (h // (heads / kv_heads)) is local
            heads, kv_heads = heads // self.shards.model_size, kv_heads // self.shards.model_size
            x = self.shards.copy_to_model(x)
        if c.fused_qkv:
            nq, nkv = heads * hd, kv_heads * hd
            qkv = _fused_lora_matmul(x, [self.q.surface(), self.k.surface(), self.v.surface()], c.lora_alpha)
            q, k, v = qkv[..., :nq], qkv[..., nq : nq + nkv], qkv[..., nq + nkv :]
        else:
            q, k, v = self.q(x), self.k(x), self.v(x)
        q = q.reshape(B, L, heads, hd)
        k = k.reshape(B, L, kv_heads, hd)
        v = v.reshape(B, L, kv_heads, hd)
        q = rope(q, positions, c.rope_theta)
        k = rope(k, positions, c.rope_theta)
        new_cache = None
        if cache is not None:
            ck, cv, cache_pos = cache
            _write_cache(ck, k, cache_pos)
            _write_cache(cv, v, cache_pos)
            k, v = ck, cv
            new_cache = (ck, cv)
        if mask is None and c.attn_impl == "flash":
            # pure-causal training shape, L a multiple of 128 (DecoderLM.forward
            # decides): ops.flash_attention_gqa reads q and the GQA K/V in
            # this layout, no [B, H, L, L] tensor forward or backward
            out = flash_attention.flash_attention_gqa(q, k, v, float(1.0 / math.sqrt(hd))).reshape(B, L, heads * hd)
        elif mask is None:
            # pure-causal training shape, short L (DecoderLM.forward decides):
            # ops.vmem_attn, no [B, H, L, L] tensor forward or backward
            out = vmem_attn.causal_attention_vmem(q, k, v, float(1.0 / math.sqrt(hd))).reshape(B, L, heads * hd)
        else:
            out = _masked_attention(q, k, v, mask, kv_heads)
        return self.o(out), new_cache


class MLP(nn.Module):
    shards = None  # set by parallel.sharding.shard_params

    def __init__(self, cfg: LLMConfig, device=None, generator=None):
        super().__init__()
        kw = dict(rank=cfg.lora_rank, alpha=cfg.lora_alpha, dtype=cfg.dtype, quant=cfg.quant, device=device, generator=generator)
        self.gate = LoRALinear(cfg.dim, cfg.ffn, **kw)
        self.up = LoRALinear(cfg.dim, cfg.ffn, **kw)
        self.down = LoRALinear(cfg.ffn, cfg.dim, **kw)
        self.cfg = cfg

    def forward(self, x):
        c = self.cfg
        ffn = c.ffn
        if self.shards is not None:
            ffn //= self.shards.model_size
            x = self.shards.copy_to_model(x)
        if c.fused_qkv:
            gu = _fused_lora_matmul(x, [self.gate.surface(), self.up.surface()], c.lora_alpha)
            gate, up = gu[..., :ffn], gu[..., ffn:]
        else:
            gate, up = self.gate(x), self.up(x)
        return self.down(nn.functional.silu(gate) * up)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LLMConfig, device=None, generator=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.dim, device=device)
        self.attn = Attention(cfg, device, generator)
        self.ln2 = RMSNorm(cfg.dim, device=device)
        self.mlp = MLP(cfg, device, generator)

    def forward(self, x, positions, mask, cache=None):
        h, new_cache = self.attn(self.ln1(x), positions, mask, cache)
        x = x + h
        x = x + self.mlp(self.ln2(x))
        return x, new_cache


class _Embed(nn.Module):
    """Token table [V, D] float32 (normal, variance 1/D); rows are cast to
    the compute dtype after the lookup."""

    def __init__(self, vocab: int, dim: int, device=None, generator=None):
        super().__init__()
        t = torch.empty((vocab, dim), dtype=torch.float32, device=device)
        with torch.no_grad():
            t.normal_(0.0, math.sqrt(1.0 / dim), generator=generator)
        self.embedding = nn.Parameter(t)


class _Head(nn.Module):
    """Untied LM head kernel [D, V], float32 (bfloat16 when frozen and
    downcast); logits are computed in float32."""

    def __init__(self, dim: int, vocab: int, device=None, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal_(torch.empty((dim, vocab), dtype=torch.float32, device=device), dim, generator))


_DOT_OPS = (
    torch.ops.aten.mm.default,
    torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.baddbmm.default,
)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOT_OPS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(policy: str | None):
    """``context_fn`` of a checkpointed layer: nothing saved (None), or the
    matrix products' outputs saved and the rest recomputed ("dots")."""
    if policy == "dots":
        return functools.partial(_ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return _ckpt.noop_context_fn


def _recomputing(layer, index: int):
    """``layer`` as the checkpointed function, its run inside a backward (the
    remat recompute, under either policy) the span ``llm.layer.recompute``."""

    def run(*args):
        if torch._C._current_graph_task_id() == -1:
            return layer(*args)
        with profiling.span("llm.layer.recompute", index):
            return layer(*args)

    return run


class DecoderLM(nn.Module):
    """The training-layout model. Parameters are made on ``device`` from
    ``seed`` (truncated-normal kernels of variance 1/fan_in, N(0, 1/r)
    ``lora_a``, zero ``lora_b`` and biases, unit norm scales); load a carried
    checkpoint with ``load_state_dict(convert.llm_params_from_jax(...))``.
    ``on_built(module)`` is called on each top-level part (the embedding, each
    decoder layer, the final norm, the head) as soon as it is made:
    ``models.training.init_train`` freezes and downcasts the base there, so a
    7B float32 tree never exists whole.

    ``parallel.sharding.shard_params`` turns a built model into this rank's
    tensor-parallel shard (``shards`` is then set): heads, MLP columns and
    rows, the embedding's D and the head's vocabulary are split over the
    mesh's "model" dim, and the forward calls the collectives itself. A
    sharded model trains (``models.training``) and is refused by every KV-cache
    call and by the serving layout."""

    shards = None  # set by parallel.sharding.shard_params

    def __init__(self, cfg: LLMConfig, device="cuda", seed: int = 0, on_built=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        built = on_built or (lambda m: None)

        def make(module):
            built(module)
            return module

        self.cfg = cfg
        self.embed = make(_Embed(cfg.vocab_size, cfg.dim, dev, gen))
        self.layers = nn.ModuleList(make(DecoderLayer(cfg, dev, gen)) for _ in range(cfg.layers))
        self.ln_f = make(RMSNorm(cfg.dim, device=dev))
        self.lm_head = make(_Head(cfg.dim, cfg.vocab_size, dev, gen))

    def forward(self, ids, positions=None, kv_caches=None, cache_pos=None, attn_mask=None, return_hidden=False):
        """Training: ids [B, L] → logits [B, L, V] float32 (causal mask, and
        ``attn_mask`` [B, L] over keys where given). Decoding: pass
        ``kv_caches`` [(k, v) × layers] (updated in place) and ``cache_pos``
        → (logits, caches). ``return_hidden`` gives the post-``ln_f`` state
        instead of logits. On a sharded model the logits are the rank's block
        of the vocabulary, [B, L, V / model]."""
        c = self.cfg
        B, L = ids.shape
        dev = ids.device
        if self.shards is not None and kv_caches is not None:
            raise ValueError(_NO_SHARDED_SERVING)
        if positions is None:
            positions = torch.arange(L, device=dev).expand(B, L)
        x = self.embed.embedding[ids].to(c.dtype)
        if self.shards is not None:
            x = self.shards.gather_from_model(x)  # RMSNorm needs all of D
        if kv_caches is None:
            # the flash kernels' tiles are 128-wide: short shapes take the dot
            # path; "vmem" keeps whole score rows on chip, bounded to MAX_L, and
            # to the 128-multiples the TPU kernel takes; padded masks take the
            # dot path
            kernel_ok = (c.attn_impl == "flash" and L >= 128 and L % 128 == 0) or (
                c.attn_impl == "vmem" and L % 128 == 0 and L <= vmem_attn.MAX_L
            )
            if kernel_ok and attn_mask is None:
                mask = None  # Attention routes mask=None to ops.flash_attention or ops.vmem_attn
            else:
                mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))[None, :, :]
                if attn_mask is not None:
                    mask = mask & attn_mask.bool()[:, None, :]
        else:
            kl = kv_caches[0][0].shape[1]
            mask = torch.arange(kl, device=dev)[None, None, :] <= positions[:, :, None]
        new_caches = []
        remat = c.remat and kv_caches is None and torch.is_grad_enabled()
        backward = profiling.backward_spans("llm.layer.backward")
        for i, layer in enumerate(self.layers):
            cache = None
            if kv_caches is not None:
                cache = (kv_caches[i][0], kv_caches[i][1], cache_pos)
            x = backward(x, i)
            with profiling.span("llm.layer.forward", i):
                if remat:
                    fn = _recomputing(layer, i) if profiling.spans_enabled() else layer
                    x, nc = _ckpt.checkpoint(fn, x, positions, mask, None, use_reentrant=False, context_fn=_remat_context(c.remat_policy))
                else:
                    x, nc = layer(x, positions, mask, cache)
            new_caches.append(nc)
        x = backward(x)
        x = self.ln_f(x)
        if return_hidden:
            # fused-CE training path: the caller feeds the final hidden state
            # and the raw lm_head kernel to ops.fused_ce
            return x
        if self.shards is not None:
            x = self.shards.copy_to_model(x)  # the vocabulary-parallel head's input
        logits = x.float() @ self.lm_head.kernel.float()
        return (logits, new_caches) if kv_caches is not None else logits


def init_kv_caches(cfg: LLMConfig, batch: int, max_len: int, device="cuda"):
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.kv_heads, cfg.head_dim)
    return [(torch.zeros(shape, dtype=cfg.dtype, device=dev), torch.zeros(shape, dtype=cfg.dtype, device=dev)) for _ in range(cfg.layers)]


def _masked_mean(total, count, shards):
    """``total / max(count, 1)``; on a sharded model both are summed over the
    batch dims first, so every rank gets the global masked mean (a mean of
    the ranks' means would weigh their rows unequally)."""
    if shards is not None:
        total, count = shards.sum_over_batch(total), shards.sum_over_batch(count)
    return total / count.clamp_min(1.0)


def _vocab_parallel_ll(lg, tgt, shards):
    """gather − logsumexp over logits split on the vocabulary over "model":
    the max and the sum of exponentials are reduced over "model", and the
    rank that owns a target contributes its logit."""
    vl = lg.shape[-1]
    mx = shards.max_over_model(lg.max(dim=-1).values)
    lse = mx + torch.log(shards.reduce_from_model(torch.exp(lg - mx[..., None]).sum(dim=-1)))
    local = tgt - shards.model_rank * vl
    owned = (local >= 0) & (local < vl)
    picked = torch.gather(lg, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    picked = shards.reduce_from_model(torch.where(owned, picked, torch.zeros_like(picked)))
    return picked - lse


def causal_lm_loss(logits, ids, loss_mask, shards=None):
    """Next-token CE with instruction masking (labels = ids shifted; only
    positions where loss_mask=1 count — the prompt is masked out). Written
    as gather − logsumexp, so no second [B, L, V] tensor is made. With the
    ``shards`` of a sharded model, ``logits`` are the rank's vocabulary block
    and its rows the rank's batch rows; the result is the global loss."""
    lg = logits[:, :-1]
    tgt = ids[:, 1:].long()
    if shards is None:
        picked = torch.gather(lg, -1, tgt[..., None])[..., 0]
        ll = picked - torch.logsumexp(lg, dim=-1)
    else:
        ll = _vocab_parallel_ll(lg, tgt, shards)
    m = loss_mask[:, 1:].to(ll.dtype)
    return _masked_mean(-(ll * m).sum(), m.sum(), shards)


def causal_lm_loss_fused(hidden, head_w, ids, loss_mask, shards=None):
    """:func:`causal_lm_loss` computed by the fused linear cross-entropy
    (``ops.fused_ce``): same gather − logsumexp formula, but the [B, L, V]
    logits never exist in device memory. The head product runs in
    ``hidden.dtype`` with float32 sums, where the dense path computes
    float32 logits, so in bfloat16 the two agree only to about 1e-3
    relative. ``hidden`` is the post-``ln_f`` state from
    ``model(ids, return_hidden=True)``; ``head_w`` the raw ``lm_head`` kernel
    [D, V], frozen (no dW is computed); on a sharded model the whole head
    (``models.training`` gathers it), the rank's batch rows, and ``shards``
    for the global mean."""
    B, L, D = hidden.shape
    h = hidden[:, :-1].reshape(B * (L - 1), D)
    tgt = ids[:, 1:].reshape(-1)
    m = loss_mask[:, 1:].reshape(-1).to(torch.float32)
    nll = fused_ce.linear_ce_rows(h, head_w.to(hidden.dtype), tgt)
    return _masked_mean((nll * m).sum(), m.sum(), shards)


def require_on(t: torch.Tensor, dev: torch.device, what: str) -> None:
    if t.device.type != dev.type:
        raise ValueError(f"{what} is on {t.device}, but device={str(dev)!r} was asked for")


def _greedy_loop(step_fn, prompt: torch.Tensor, max_new: int, eos_id: int | None) -> torch.Tensor:
    """The greedy loop both layouts share. ``step_fn(ids [B, L], pos)`` →
    last-position logits [B, V] after writing cache rows pos..pos+L−1.

    ``tokens`` starts as zeros; the loop stops as soon as every row has
    emitted ``eos_id``, so positions after the stop stay 0, and a finished
    row keeps writing ``eos_id``. With an ``eos_id`` the stop test reads one
    flag from the device every step (a host synchronisation per token);
    with ``eos_id=None`` nothing synchronises until the caller reads."""
    B, P = prompt.shape
    tokens = torch.zeros((B, P + max_new), dtype=torch.int32, device=prompt.device)
    tokens[:, :P] = prompt
    tokens[:, P] = torch.argmax(step_fn(prompt, 0), dim=-1)
    done = torch.zeros((B,), dtype=torch.bool, device=prompt.device)
    for step in range(max_new - 1):
        pos = P + step
        nxt = torch.argmax(step_fn(tokens[:, pos : pos + 1], pos), dim=-1)
        if eos_id is not None:
            done = done | (nxt == eos_id)
            nxt = torch.where(done, eos_id, nxt)
        tokens[:, pos + 1] = nxt
        if eos_id is not None and bool(done.all()):
            break
    return tokens


@torch.no_grad()
def greedy_generate(model: DecoderLM, prompt_ids, max_new: int, eos_id: int | None = None, device="cuda") -> torch.Tensor:
    """KV-cache greedy decoding in the training layout: prefill, then one
    forward per token. prompt_ids [B, P] (fixed-length prompts; right-padded
    prompts are not supported) → int32 tokens [B, P + max_new] on ``device``,
    where the model must already be."""
    dev = resolve_device(device)
    require_on(model.embed.embedding, dev, "the model")
    if model.shards is not None:
        raise ValueError(_NO_SHARDED_SERVING)
    dsp_precision()
    prompt = torch.as_tensor(prompt_ids).to(dev, torch.int32)
    B, P = prompt.shape
    caches = init_kv_caches(model.cfg, B, P + max_new, dev)

    def step_fn(ids, pos):
        L = ids.shape[1]
        positions = (pos + torch.arange(L, device=dev)).expand(B, L)
        logits, _ = model(ids, positions=positions, kv_caches=caches, cache_pos=pos)
        return logits[:, -1]

    return _greedy_loop(step_fn, prompt, max_new, eos_id)


# ---------------------------------------------------------------------------
# Fused serving path
#
# The training module keeps q/k/v/gate/up as separate kernels; a decode step
# at small batch is bound by the weight stream, so serving wants the OPPOSITE
# layout: LoRA folded into the base (merge_lora math), q|k|v and gate|up
# concatenated into one kernel each, and everything stored bfloat16 — half
# the bytes of the float32 training tree and fewer launches per layer.


def fuse_decode_params(params, cfg: LLMConfig, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Training tree (a :class:`DecoderLM` or its ``state_dict``) → fused
    serving tree in ``dtype`` with LoRA folded in, on the tree's device.
    Quantized trees (``kernel_q`` storage) and tensor-parallel models are
    refused."""
    if isinstance(params, nn.Module) and params.shards is not None:
        raise ValueError(_NO_SHARDED_SERVING)
    p = params.state_dict() if isinstance(params, nn.Module) else params

    def folded(stem):
        if stem + ".kernel" not in p:
            raise ValueError("fuse_decode_params: quantized trees are not fusable")
        k = p[stem + ".kernel"]
        if stem + ".lora_a" in p:
            a, b = p[stem + ".lora_a"], p[stem + ".lora_b"]
            k = k + (cfg.lora_alpha / a.shape[-1]) * (a @ b)
        return k.to(dtype)

    def bias(stem, width):
        b = p.get(stem + ".bias")
        if b is None:
            b = torch.zeros((width,), dtype=torch.float32, device=p[stem + ".kernel"].device)
        return b.to(dtype)

    hd = cfg.head_dim
    layers = []
    with torch.no_grad():
        for i in range(cfg.layers):
            at, mlp = f"layers.{i}.attn", f"layers.{i}.mlp"
            layers.append(
                {
                    "wqkv": torch.cat([folded(at + ".q"), folded(at + ".k"), folded(at + ".v")], dim=1),
                    "bqkv": torch.cat(
                        [bias(at + ".q", cfg.heads * hd), bias(at + ".k", cfg.kv_heads * hd), bias(at + ".v", cfg.kv_heads * hd)]
                    ),
                    "wo": folded(at + ".o"),
                    "wgu": torch.cat([folded(mlp + ".gate"), folded(mlp + ".up")], dim=1),
                    "wdown": folded(mlp + ".down"),
                    "ln1": p[f"layers.{i}.ln1.scale"].to(dtype),
                    "ln2": p[f"layers.{i}.ln2.scale"].to(dtype),
                }
            )
        return {
            "embed": p["embed.embedding"].to(dtype),
            "ln_f": p["ln_f.scale"].to(dtype),
            "lm_head": p["lm_head.kernel"].to(dtype),
            "layers": layers,
        }


def quantize_fused_decode_params(fp: dict, block: int = 64, mode: str = "int8b") -> dict:
    """Fused serving tree → int8 weight stream.

    Every streamed matmul weight (wqkv, wo, wgu, wdown per layer, plus
    lm_head) becomes ``{"codes": int8 [K, N], "scale": f32 [K/block, N]}``
    (``mode="int8b"``, blockwise — ``quant.matmul_int8_block``) or
    ``{"codes": int8 [K, N], "scale": f32 [N]}`` (``mode="int8"``, per output
    channel); embed, biases and norm scales stay float. Each weight is
    quantized on its device (``models.quant``'s torch path, byte-equal to the
    JAX package's host quantizers)."""
    from .quant import quantize_kernel_int8, quantize_kernel_int8_block

    if mode not in ("int8", "int8b"):
        raise ValueError(f"unknown mode {mode!r}")

    def q2(w):
        w = w.detach()
        q, s = quantize_kernel_int8(w) if mode == "int8" else quantize_kernel_int8_block(w, block)
        return {"codes": q, "scale": s}

    layers = [{**lw, "wqkv": q2(lw["wqkv"]), "wo": q2(lw["wo"]), "wgu": q2(lw["wgu"]), "wdown": q2(lw["wdown"])} for lw in fp["layers"]]
    return {**fp, "layers": layers, "lm_head": q2(fp["lm_head"])}


def _fused_mm(x, w):
    """x @ w for a fused-tree weight: a plain tensor, or the int8 dict from
    :func:`quantize_fused_decode_params` (per-channel scales multiply the
    product in float32; blockwise scales go through
    ``quant.matmul_int8_block``)."""
    if isinstance(w, dict):
        if w["scale"].dim() == 1:
            y = x @ w["codes"].to(x.dtype)
            return (y * w["scale"].float()).to(x.dtype)
        from .quant import matmul_int8_block

        block = w["codes"].shape[0] // w["scale"].shape[0]
        return matmul_int8_block(x, w["codes"], w["scale"], x.dtype, block)
    return x @ w


def _fused_rmsnorm(x, scale, eps=1e-6):
    # the rsqrt is rounded to x's dtype BEFORE the multiply (RMSNorm above
    # rounds after it): the two layouts differ here, as in the JAX package
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def init_kv_caches_fused(cfg: LLMConfig, batch: int, max_len: int, dtype: torch.dtype | None = None, device="cuda"):
    """KV caches PACKED as [B, S, kv_heads·hd] for the fused serving path:
    the layout ``ops.decode_attn`` reads, one contiguous row per position."""
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.kv_heads * cfg.head_dim)
    dtype = dtype or cfg.dtype
    return [(torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev)) for _ in range(cfg.layers)]


def _fused_forward(fp, cfg: LLMConfig, ids, positions, caches, cache_pos: int, last_only: bool = False):
    """One forward over [B, L] ids through the fused tree, with KV caches in
    the packed serving layout (updated in place). Returns (logits [B, L, V]
    float32, caches). With ``last_only`` the LM head runs on the final
    position only ([B, 1, V]).

    Decode steps (L == 1) run attention in ``ops.decode_attn`` (the CUDA
    kernel on the card); prefill keeps the masked einsum path over an
    unpacked view of the caches."""
    hd = cfg.head_dim
    nq, nkv = cfg.heads * hd, cfg.kv_heads * hd
    B, L = ids.shape
    x = fp["embed"][ids]
    kl = caches[0][0].shape[1]
    if L > 1:
        mask = torch.arange(kl, device=ids.device)[None, None, :] <= positions[:, :, None]
    # eager PyTorch pays a launch for every small op: the rotary tables are
    # made once for all layers, and q and k are rotated in one pass
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    for lw, (ck, cv) in zip(fp["layers"], caches):
        h = _fused_rmsnorm(x, lw["ln1"])
        qkv = _fused_mm(h, lw["wqkv"]) + lw["bqkv"]
        qk = apply_rope(qkv[..., : nq + nkv].reshape(B, L, cfg.heads + cfg.kv_heads, hd), cos, sin)
        q = qk[:, :, : cfg.heads]
        _write_cache(ck, qk[:, :, cfg.heads :].reshape(B, L, nkv), cache_pos)
        _write_cache(cv, qkv[..., nq + nkv :], cache_pos)
        if L == 1:
            out = decode_attn.decode_attention(q[:, 0].contiguous(), ck, cv, cache_pos, cfg.kv_heads).reshape(B, 1, nq)
        else:
            kk = ck.reshape(B, kl, cfg.kv_heads, hd)
            vv = cv.reshape(B, kl, cfg.kv_heads, hd)
            out = _masked_attention(q, kk, vv, mask, cfg.kv_heads)
        x = x + _fused_mm(out, lw["wo"])
        h = _fused_rmsnorm(x, lw["ln2"])
        gu = _fused_mm(h, lw["wgu"])
        g, u = gu[..., : cfg.ffn], gu[..., cfg.ffn :]
        x = x + _fused_mm(nn.functional.silu(g) * u, lw["wdown"])
    if last_only:
        x = x[:, -1:]
    x = _fused_rmsnorm(x, fp["ln_f"])
    logits = _fused_mm(x, fp["lm_head"]).float()
    return logits, caches


@torch.no_grad()
def greedy_generate_fused(fp: dict, cfg: LLMConfig, prompt_ids, max_new: int, eos_id: int | None = None, device="cuda") -> torch.Tensor:
    """Greedy decode over a :func:`fuse_decode_params` tree — the serving
    path. prompt_ids [B, P] → int32 tokens [B, P + max_new] on ``device``,
    where the tree must already be. One prefill (LM head on the last
    position only), then one ``_fused_forward`` per token; every decode step
    launches ``ops.decode_attn`` once per layer."""
    dev = resolve_device(device)
    require_on(fp["embed"], dev, "the fused tree")
    dsp_precision()
    prompt = torch.as_tensor(prompt_ids).to(dev, torch.int32)
    B, P = prompt.shape
    caches = init_kv_caches_fused(cfg, B, P + max_new, fp["embed"].dtype, dev)

    def step_fn(ids, pos):
        L = ids.shape[1]
        positions = (pos + torch.arange(L, device=dev)).expand(B, L)
        logits, _ = _fused_forward(fp, cfg, ids, positions, caches, pos, last_only=True)
        return logits[:, -1]

    return _greedy_loop(step_fn, prompt, max_new, eos_id)
