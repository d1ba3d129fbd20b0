"""Layers that round where the flax modules of the JAX package round.

The aligners' models are flax modules with ``dtype=bfloat16`` and float32
LayerNorms. What that means for the numbers, and what these layers do:

- ``Dense``: the input and the kernel are cast to bfloat16, the product
  (accumulated in float32) is rounded to bfloat16, and the bias is added in
  bfloat16. The kernel is kept in the computing type (bfloat16, or float32
  for a float32 layer), so no cast runs per call.
- ``LayerNorm``: statistics in float32 with the variance as E[x²] − E[x]²
  (clipped at 0), then (x − mean) · (rsqrt(var + eps) · scale) + bias, the
  output float32 (flax's ``LayerNorm(dtype=float32)``, epsilon 1e-6).
- ``gelu_erf_bf16``: the exact gelu on a bfloat16 tensor, one rounding per
  operation as XLA evaluates ``0.5 · x · erfc(−x · sqrt(0.5))``;
  ``gelu_tanh_bf16`` (the tanh approximation) is the separator's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..audio.separate import gelu_tanh_bf16

__all__ = ["Dense", "LayerNorm", "gelu_erf_bf16", "gelu_tanh_bf16", "LN_EPS"]

LN_EPS = 1e-6  # flax LayerNorm's default


class Dense(nn.Module):
    """flax ``Dense`` / ``DenseGeneral`` with the kernel flattened to
    [in, out]: x [..., in] → [..., out] in ``dtype``."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out, dtype=dtype), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(d_out, dtype=dtype), requires_grad=False) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.kernel.dtype), self.kernel)
        return y if self.bias is None else y + self.bias


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
