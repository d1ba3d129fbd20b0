"""Range-maximum queries over long signals (sparse table on chunks).

Gives the per-window absolute peaks of the reference's peak-normalise-
before-metering (every syntagme slice is divided by its own peak before
loudness gating). The structure is the JAX package's ``ops/rangemax.py``:

- chunk maxima (CHUNK = 1024 samples) and a log₂-level sparse table over
  them, M[k][i] = max of chunks [i, i+2^k);
- a window's interior chunk maximum is two lookups;
- the ≤CHUNK-sample partial edges split radix SUB = 32: SUB-sample maxima
  for whole sub-blocks, raw samples for the ragged ends.

A maximum is exact whatever the order, so the results equal the JAX
package's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

CHUNK = 1024
SUB = 32  # CHUNK == SUB * SUB


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [..., n] gathered at idx [..., *I] (leading dims = arr's batch dims)."""
    bd = arr.dim() - 1
    if bd == 0:
        return arr[idx]
    flat = idx.reshape(idx.shape[:bd] + (-1,))
    return arr.gather(-1, flat).reshape(idx.shape)


@dataclass
class RangeMax:
    levels: torch.Tensor  # [..., K, NC] sparse table over chunk maxima
    sub: torch.Tensor  # [..., NC*SUB] SUB-sample maxima
    signal: torch.Tensor  # [..., T] |x|
    length: int

    @classmethod
    def build(cls, x: torch.Tensor) -> "RangeMax":
        ax = x.to(torch.float32).abs()
        T = ax.shape[-1]
        nc = -(-T // CHUNK)
        xp = torch.nn.functional.pad(ax, (0, nc * CHUNK - T))
        sub_max = xp.reshape(ax.shape[:-1] + (nc * SUB, SUB)).amax(dim=-1)
        chunk_max = sub_max.reshape(ax.shape[:-1] + (nc, SUB)).amax(dim=-1)
        levels = [chunk_max]
        k = 1
        while (1 << k) <= nc:
            prev = levels[-1]
            span = 1 << (k - 1)
            levels.append(torch.maximum(prev, torch.roll(prev, -span, dims=-1)))
            k += 1
        return cls(levels=torch.stack(levels, dim=-2), sub=sub_max, signal=ax, length=T)

    def _chunk_range_max(self, ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
        """Max over chunks [ca, cb); 0 where empty."""
        n = cb - ca
        nlev, nc = self.levels.shape[-2], self.levels.shape[-1]
        # floor(log2(n)) exactly, for n ≥ 1
        k = torch.floor(torch.log2(n.clamp(min=1).to(torch.float64))).to(torch.int64).clamp(0, nlev - 1)
        span = torch.bitwise_left_shift(torch.ones_like(k), k)
        i2 = (cb - span).clamp(0, nc - 1)
        i1 = ca.clamp(0, nc - 1)
        flat = self.levels.reshape(self.levels.shape[:-2] + (-1,))
        m = torch.maximum(_take(flat, k * nc + i1), _take(flat, k * nc + i2))
        return torch.where(n > 0, m, torch.zeros((), dtype=m.dtype, device=m.device))

    @staticmethod
    def _masked_take(arr: torch.Tensor, base: torch.Tensor, stop: torch.Tensor) -> torch.Tensor:
        """max arr[base : stop] for stop − base ≤ SUB (0 where empty)."""
        n = arr.shape[-1]
        pos = base[..., None] + torch.arange(SUB, device=base.device)
        vals = _take(arr, pos.clamp(0, n - 1))
        vals = torch.where(pos < stop[..., None], vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
        return vals.amax(dim=-1)

    def _edge_max(self, start: torch.Tensor, stop: torch.Tensor) -> torch.Tensor:
        """Max over ≤CHUNK samples [start, stop): whole SUB-blocks from the
        sub maxima, ragged ends from the signal."""
        T = self.signal.shape[-1]
        start = start.clamp(0, T)
        stop = torch.maximum(stop.clamp(max=T), start)
        sa = -((-start) // SUB)  # first fully covered sub-block
        sb = stop // SUB  # end of the fully covered sub-blocks
        interior = self._masked_take(self.sub, torch.minimum(sa, sb), sb)
        left = self._masked_take(self.signal, start, torch.minimum(sa * SUB, stop))
        right = self._masked_take(self.signal, torch.maximum(sb * SUB, start), stop)
        return torch.maximum(interior, torch.maximum(left, right))

    def query(self, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
        """max |x[lo:hi]| for integer index tensors whose leading dims are
        the signal's batch dims; 0.0 for empty windows."""
        lo = lo.to(torch.int64).clamp(0, self.length)
        hi = torch.maximum(hi.to(torch.int64).clamp(max=self.length), lo)
        ca = -((-lo) // CHUNK)  # first fully covered chunk
        cb = hi // CHUNK
        interior = self._chunk_range_max(torch.minimum(ca, cb), cb)
        left = self._edge_max(lo, torch.minimum(ca * CHUNK, hi))
        right = self._edge_max(torch.maximum(cb * CHUNK, lo), hi)
        return torch.maximum(interior, torch.maximum(left, right))
