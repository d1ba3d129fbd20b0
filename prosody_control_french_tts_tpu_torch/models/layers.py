"""Layers that round where the flax modules of the JAX package round.

The aligners' models are flax modules with ``dtype=bfloat16`` and float32
LayerNorms. What that means for the numbers, and what these layers do:

- ``Dense``: the input and the kernel are cast to bfloat16, the product
  (accumulated in float32) is rounded to bfloat16, and the bias is added in
  bfloat16.
- ``LayerNorm``: statistics in float32 with the variance as E[x²] − E[x]²
  (clipped at 0), then (x − mean) · (rsqrt(var + eps) · scale) + bias, the
  output float32 (flax's ``LayerNorm(dtype=float32)``, epsilon 1e-6).
- ``gelu_erf_bf16``: the exact gelu on a bfloat16 tensor, one rounding per
  operation as XLA evaluates ``0.5 · x · erfc(−x · sqrt(0.5))``;
  ``gelu_tanh_bf16`` (the tanh approximation) is the separator's.

One module serves inference and training. A layer computes in its
``dtype`` and casts its parameters to it in the forward; what the
parameters are stored in is the caller's choice. Inference stores them in
the computing type (bfloat16 where flax computes in bfloat16), so the cast
is a no-op and no copy runs per call, and the parameters are frozen.
Training calls :func:`master_weights`: float32 parameters with gradients,
cast inside every forward, as flax keeps float32 parameters and casts them
on each call (optax then updates the float32 leaves). A float32 weight cast
to bfloat16 is the same bfloat16 that loading it into a bfloat16 parameter
stores, so both give the same numbers.

The initialisers are flax's defaults, drawn from a ``torch.Generator``:
:func:`lecun_normal` (a normal truncated to ±2 standard deviations, scaled
to variance 1 / fan_in) for kernels, :func:`embed_normal` (a normal of
standard deviation 1 / sqrt(features)) for embeddings.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..audio.separate import gelu_tanh_bf16

__all__ = ["Dense", "LayerNorm", "gelu_erf_bf16", "gelu_tanh_bf16", "LN_EPS", "master_weights", "lecun_normal",
           "embed_normal"]

LN_EPS = 1e-6  # flax LayerNorm's default
_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def master_weights(module: nn.Module) -> nn.Module:
    """Float32 parameters with gradients (a module to train): every layer
    keeps computing in its own type and casts its parameters in the
    forward."""
    return module.float().requires_grad_(True)


def lecun_normal(fan_in: int, shape, g: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated to ±2 standard deviations
    (out-of-range draws drawn again), scaled to variance 1 / fan_in."""
    w = torch.randn(shape, generator=g)
    bad = w.abs() > 2.0
    while bad.any():
        w[bad] = torch.randn(int(bad.sum()), generator=g)
        bad = w.abs() > 2.0
    return w * (float(np.sqrt(1.0 / fan_in)) / _TRUNC_STD)


def embed_normal(shape, g: torch.Generator) -> torch.Tensor:
    """flax ``Embed``'s default: a normal of variance 1 / features."""
    return torch.randn(shape, generator=g) / float(np.sqrt(shape[-1]))


class Dense(nn.Module):
    """flax ``Dense`` / ``DenseGeneral`` with the kernel flattened to
    [in, out]: x [..., in] → [..., out] in ``dtype``."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out, dtype=dtype), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(d_out, dtype=dtype), requires_grad=False) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = LN_EPS):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(dim), requires_grad=False)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
        return (xf - mu) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


def gelu_erf_bf16(x: torch.Tensor) -> torch.Tensor:
    """Exact gelu of a bfloat16 tensor, rounded after each operation."""
    sqrt_half = torch.tensor(float(np.float32(np.sqrt(0.5))), dtype=torch.bfloat16, device=x.device)
    return (0.5 * x) * torch.erfc((-x) * sqrt_half)
