"""NF4 as the QLoRA paper and bitsandbytes define it, kept here so that the
reference quantizes its base itself: blocks of 64 along the contraction
axis, each scaled by its absolute maximum, every weight coded as the index of
the nearest of 16 normal quantiles (the first on a tie), the weight read
back as that quantile times its block's scale.
"""

from __future__ import annotations

import torch

BLOCK = 64
TABLE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453, -0.28444138169288635,
    -0.18477343022823334, -0.09105003625154495, 0.0, 0.07958029955625534, 0.16093020141124725,
    0.24611230194568634, 0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)
CHUNK_ELEMS = 1 << 22  # weights coded at once: [rows, cols, 16] float32 distances of 256 MB


def quantize(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w [in, out] (read as float32) → (codes uint8 [in, out], scale float32
    [in / 64, out]), on w's device, a column chunk at a time."""
    rows, cols = w.shape
    if rows % BLOCK:
        raise ValueError(f"{rows} rows are not a multiple of the block {BLOCK}")
    table = torch.tensor(TABLE, dtype=torch.float32, device=w.device)
    codes = torch.empty((rows, cols), dtype=torch.uint8, device=w.device)
    scale = torch.empty((rows // BLOCK, cols), dtype=torch.float32, device=w.device)
    step = max(1, CHUNK_ELEMS // rows)
    for c0 in range(0, cols, step):
        blocks = w[:, c0 : c0 + step].float().reshape(rows // BLOCK, BLOCK, -1)
        s = blocks.abs().amax(dim=1).clamp_min(1e-12)
        normed = (blocks / s[:, None, :]).reshape(rows, -1)
        codes[:, c0 : c0 + step] = (normed[..., None] - table).abs().argmin(dim=-1).to(torch.uint8)
        scale[:, c0 : c0 + step] = s
    return codes, scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """float32 [in, out]: each code's quantile times its block's scale."""
    table = torch.tensor(TABLE, dtype=torch.float32, device=codes.device)
    rows, cols = codes.shape
    w = table[codes.long()].reshape(rows // BLOCK, BLOCK, cols) * scale[:, None, :]
    return w.reshape(rows, cols)
