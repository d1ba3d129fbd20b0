"""LoRA (low-rank adaptation) for dense projections.

The reference trains Qwen2.5-7B with PEFT LoRA r=8 α=16 on the
q/k/v/o/gate/up/down projections. ``LoRALinear`` computes
``x·W + b + (α/r)·(x·A)·B`` with A ~ N(0, 1/r), B = 0. The base kernel is
stored ``[in, out]`` (so a checkpoint of the JAX package copies across
without a transpose) as float32, as bfloat16 once a training run has
frozen and downcast it (``models.training.init_train(frozen_dtype=...)``), or
weight-only quantized (``models.quant``); adapters are always float32.

A quantized base kernel is dequantized in every forward. Autograd would keep
that dequantized copy for the backward of ``x @ W`` (the whole 7B base in
bfloat16, about 13 GB a step); :class:`_FrozenKernelMatmul` keeps the codes
instead and dequantizes again in the backward.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .quant import NF4_BLOCK, dequant_int8, dequant_int8_block, dequant_nf4, matmul_int8_block

# standard deviation of a standard normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator | None = None) -> torch.Tensor:
    """Fill ``t`` from a normal truncated at ±2σ with variance ``1/fan_in``
    (inverse-CDF sampling on ``t``'s device)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    edge = math.erf(2.0 / math.sqrt(2.0))  # erfinv(±edge)·√2 = ±2
    with torch.no_grad():
        t.uniform_(-edge, edge, generator=generator)
        t.erfinv_().mul_(math.sqrt(2.0) * std).clamp_(-2.0 * std, 2.0 * std)
    return t


class _FrozenKernelMatmul(torch.autograd.Function):
    """``x @ kernel()`` for a frozen kernel that ``kernel`` makes from
    ``sources`` (the codes and scales): the backward makes it again rather
    than keeping the forward's. Only ``x`` gets a gradient, by the product
    autograd's own ``mm`` backward computes (the same call, the same bits)."""

    @staticmethod
    def forward(ctx, x, kernel, *sources):
        ctx.kernel = kernel
        ctx.save_for_backward(*sources)
        return x @ kernel()

    @staticmethod
    def backward(ctx, gy):
        w = ctx.kernel()
        gx = gy.reshape(-1, gy.shape[-1]).mm(w.t()).reshape(*gy.shape[:-1], w.shape[0])
        return (gx, None, *([None] * len(ctx.saved_tensors)))


class LoRALinear(nn.Module):
    """``quant`` selects weight-only storage for the BASE kernel: ``None``
    (float32 ``kernel``), ``"int8"`` (per channel), ``"int8b"`` (blockwise,
    the NF4 serving layout) or ``"nf4"`` (4-bit packed). Quantized kernels
    are buffers ``kernel_q`` + ``kernel_scale`` (never a gradient) and are
    dequantized to ``dtype`` in :meth:`forward` and again in the backward
    (module docstring); ``int8b`` runs
    ``quant.matmul_int8_block`` and never materialises the kernel.

    On a tensor-parallel model (``parallel.sharding.shard_params``) the base
    kernel holds this rank's block and ``split`` says which: ``"col"`` (output
    columns: the replicated bias and ``lora_b`` are read at the rank's
    columns) or ``"row"`` (input rows: ``lora_a`` is read at the rank's rows,
    and the partial products of the base and of ``x·lora_a`` are summed over
    "model" in one all-reduce before ``lora_b``)."""

    shards = None  # the model's parallel.sharding.ModelShards, when sharded
    split = None  # "col" | "row" on a sharded model

    def __init__(
        self,
        in_features: int,
        features: int,
        rank: int = 0,
        alpha: float = 16.0,
        use_bias: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        quant: str | None = None,
        device=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if quant not in (None, "int8", "int8b", "nf4"):
            raise ValueError(f"unknown quant mode {quant!r}")
        self.in_features, self.features = in_features, features
        self.rank, self.alpha, self.dtype, self.quant = rank, alpha, dtype, quant
        if quant is None:
            self.kernel = nn.Parameter(
                lecun_normal_(torch.empty((in_features, features), dtype=torch.float32, device=device), in_features, generator)
            )
        else:
            packed = quant == "nf4"
            q_shape = (in_features // 2, features) if packed else (in_features, features)
            s_shape = (features,) if quant == "int8" else (in_features // NF4_BLOCK, features)
            self.register_buffer("kernel_q", torch.zeros(q_shape, dtype=torch.uint8 if packed else torch.int8, device=device))
            self.register_buffer("kernel_scale", torch.ones(s_shape, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros((features,), dtype=torch.float32, device=device)) if use_bias else None
        if rank > 0:
            a = torch.empty((in_features, rank), dtype=torch.float32, device=device)
            with torch.no_grad():
                a.normal_(0.0, 1.0 / rank, generator=generator)
            self.lora_a = nn.Parameter(a)
            self.lora_b = nn.Parameter(torch.zeros((rank, features), dtype=torch.float32, device=device))
        else:
            self.lora_a = self.lora_b = None

    def surface(self):
        """The parameter surface ``(kernel, bias, lora_a, lora_b)`` for callers
        that fuse several projections into one matmul (``models.llm``
        ``fused_qkv``): the base kernel in the compute dtype, dequantized
        where quantized; bias and adapters as stored (None where absent)."""
        if self.quant == "int8b":
            kernel = dequant_int8_block(self.kernel_q, self.kernel_scale, self.dtype)
        elif self.quant is not None:
            kernel = self._dequantized()
        else:
            kernel = self.kernel.to(self.dtype)  # no copy when already stored in that dtype
        return (kernel, *self._adapters())

    def _adapters(self):
        """(bias, lora_a, lora_b) as this rank reads them: a column-parallel
        projection reads the bias and ``lora_b`` at its columns."""
        bias, lora_b = self.bias, self.lora_b
        if self.split == "col":
            cols = self.shards.block(self.features)
            bias = None if bias is None else bias[cols]
            lora_b = None if lora_b is None else lora_b[:, cols]
        return bias, self.lora_a, lora_b

    def _dequantized(self) -> torch.Tensor:
        dequant = dequant_int8 if self.quant == "int8" else dequant_nf4
        return dequant(self.kernel_q, self.kernel_scale, self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.quant == "int8b":
            y = matmul_int8_block(x, self.kernel_q, self.kernel_scale, dt)
        elif self.quant in ("int8", "nf4"):
            if x.requires_grad and torch.is_grad_enabled():
                y = _FrozenKernelMatmul.apply(x, self._dequantized, self.kernel_q, self.kernel_scale)
            else:
                y = x @ self._dequantized()
        else:
            y = x @ self.kernel.to(dt)
        if self.split == "row":
            return self._reduce_rows(x, y)
        bias, lora_a, lora_b = self._adapters()
        if bias is not None:
            y = y + bias.to(dt)
        if lora_a is not None:
            y = y + (self.alpha / self.rank) * ((x @ lora_a.to(dt)) @ lora_b.to(dt))
        return y

    def _reduce_rows(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Row-parallel tail: the partial products summed over "model" (one
        all-reduce of [y | x·lora_a]), then the adapter's second product."""
        dt = self.dtype
        if self.lora_a is None:
            return self.shards.reduce_from_model(y)
        a = self.lora_a[self.shards.block(self.in_features)]
        yt = self.shards.reduce_from_model(torch.cat([y, x @ a.to(dt)], dim=-1))
        y, t = yt[..., : y.shape[-1]], yt[..., y.shape[-1] :]
        return y + (self.alpha / self.rank) * (t @ self.lora_b.to(dt))


def lora_param_mask(params: dict) -> dict:
    """Mapping of bools over a ``state_dict``: True for the LoRA adapter
    leaves (``lora_a`` / ``lora_b``) — only adapters train, the PEFT
    contract."""
    return {k: k.rsplit(".", 1)[-1] in ("lora_a", "lora_b") for k in params}


def merge_lora(params: dict) -> dict:
    """Fold adapters into base kernels (deployment export) over a
    ``state_dict``: ``kernel += (α/r)·A·B`` with the reference's α = 16,
    adapters zeroed."""
    alpha = 16.0
    out = dict(params)
    for key in params:
        if not key.endswith(".lora_a"):
            continue
        stem = key[: -len("lora_a")]
        if stem + "lora_b" in params and stem + "kernel" in params:
            a, b = params[key], params[stem + "lora_b"]
            out[stem + "kernel"] = params[stem + "kernel"] + (alpha / a.shape[-1]) * (a @ b)
            out[key] = torch.zeros_like(a)
            out[stem + "lora_b"] = torch.zeros_like(b)
    return out
