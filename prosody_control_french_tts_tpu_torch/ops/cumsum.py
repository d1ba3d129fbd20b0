"""Two-level (chunked) prefix sums over long signals.

The same scheme as the JAX package's ``ops/cumsum.py``: an in-chunk
cumulative sum over chunks of ``CHUNK = 2048`` samples plus exclusive
chunk-total offsets. A flat ``torch.cumsum`` over 10⁶ samples would round
differently; every windowed sum that must agree with the reference goes
through this structure (frame local means in ``ops.pitch``, the loudness
fallback in ``ops.loudness``, the silence scan in ``ops.energy``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

CHUNK = 2048


@dataclass
class ChunkedCumsum:
    """Exclusive prefix sums of a [..., T] signal, queryable at any index
    0 ≤ i ≤ T (``lookup(i)`` = sum(x[..., :i]); out-of-range clamps)."""

    within_ex: torch.Tensor  # [..., n_chunks, CHUNK] exclusive in-chunk sums
    block: torch.Tensor  # [..., n_chunks] exclusive chunk-total prefix
    chunk_tot: torch.Tensor  # [..., n_chunks] raw chunk totals (local magnitude)
    length: int  # original T

    @classmethod
    def build(cls, x: torch.Tensor) -> "ChunkedCumsum":
        T = x.shape[-1]
        nb = T // CHUNK + 1  # ≥ 1 padded slot → nb·CHUNK ≥ T+1, lookup(T) safe
        xp = torch.nn.functional.pad(x, (0, nb * CHUNK - T)).reshape(x.shape[:-1] + (nb, CHUNK))
        within = torch.cumsum(xp, dim=-1)
        chunk_tot = within[..., -1]
        block = torch.cumsum(chunk_tot, dim=-1) - chunk_tot  # exclusive
        return cls(within_ex=within - xp, block=block, chunk_tot=chunk_tot, length=T)

    def lookup(self, idx: torch.Tensor) -> torch.Tensor:
        """Prefix sums at integer indices idx [..., I], whose leading dims
        are the signal's batch dims."""
        idx = idx.to(torch.int64).clamp(0, self.length)
        q = idx // CHUNK
        flat_w = self.within_ex.reshape(self.within_ex.shape[:-2] + (-1,))
        bd = self.block.dim() - 1
        if bd == 0:
            return self.block[q] + flat_w[idx]
        qf = q.reshape(q.shape[:bd] + (-1,))
        wf = idx.reshape(idx.shape[:bd] + (-1,))
        b = self.block.gather(-1, qf).reshape(q.shape)
        w = flat_w.gather(-1, wf).reshape(q.shape)
        return b + w

    def range_sum(self, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
        return self.lookup(hi) - self.lookup(lo)

    def range_sum_local(self, lo: torch.Tensor, hi: torch.Tensor, max_span: int) -> torch.Tensor:
        """``range_sum`` for windows of bounded width (hi − lo ≤ max_span)
        without differencing the global chunk-total prefix: that float32
        prefix grows with the position in the file, and on hour-long signals
        its absolute rounding lands in window sums of order 1 (several dB in
        near-threshold windows). Here the between-chunk part is a masked sum
        of the ≤ ⌈max_span/CHUNK⌉ + 1 raw chunk totals inside the window, so
        the error stays relative to the window wherever it lies."""
        lo = lo.to(torch.int64).clamp(0, self.length)
        hi = hi.to(torch.int64).clamp(0, self.length)
        q1, q2 = lo // CHUNK, hi // CHUNK
        K = max_span // CHUNK + 1
        tot = self.chunk_tot
        nb = tot.shape[-1]
        cand = q1[..., None] + torch.arange(K, device=lo.device)  # [..., K]
        idx = cand.clamp(0, nb - 1)
        bd = tot.dim() - 1
        if bd == 0:
            g = tot[idx]
        else:
            g = tot.gather(-1, idx.reshape(idx.shape[:bd] + (-1,))).reshape(idx.shape)
        mid = torch.where(cand < q2[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device)).sum(-1)
        # sum over [lo, hi) = full chunks q1..q2-1, minus the [q1·C, lo) head,
        # plus the [q2·C, hi) tail
        return mid - self._within_at(lo) + self._within_at(hi)

    def _within_at(self, idx: torch.Tensor) -> torch.Tensor:
        flat_w = self.within_ex.reshape(self.within_ex.shape[:-2] + (-1,))
        bd = self.block.dim() - 1
        if bd == 0:
            return flat_w[idx]
        return flat_w.gather(-1, idx.reshape(idx.shape[:bd] + (-1,))).reshape(idx.shape)


def chunked_cumsum_sq(x: torch.Tensor) -> ChunkedCumsum:
    """ChunkedCumsum of x² — the common case (energy windows)."""
    x = x.to(torch.float32)
    return ChunkedCumsum.build(x * x)
