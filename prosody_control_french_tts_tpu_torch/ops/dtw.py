"""Dynamic time warping, and the token↔frame monotonic-partition DP of the
Whisper aligner's timestamps, in PyTorch.

Port of the JAX package's ``ops/dtw.py``. There these are XLA scans, not
Pallas kernels; here they are plain PyTorch on the tensor's device:

- ``dtw_distance`` / ``dtw_path``: the accumulated-cost matrix with steps
  {(1,0),(0,1),(1,1)} and |a_i − b_j| local cost. The JAX package scans
  the cells of a row one by one; here the cells of one anti-diagonal are
  computed together (each cell depends only on the two diagonals before
  it), every cell with the same one add of the same minimum, so D is the
  same bit for bit.
- ``monotonic_partition_costs`` (and its batched form): steps (1,1) and
  (0,1), every token owns a contiguous, non-empty frame span. A row is
  R = S + cummin(P[:-1] − S₋₁), S the row's prefix sum: the prefix sums of
  every row are taken at once (they do not depend on the DP), then the rows
  advance one by one with ``torch.cummin``.
- ``monotonic_partition_spans_batched``: the DP and its backtrack on the
  device, a loop over frames for the whole batch.

The prefix sums add in the order of the XLA CPU ``cumsum`` the JAX package
compiles to (a sequential sum within blocks of 16, then the blocks' totals
summed the same way, recursively, and added on): a ``torch.cumsum`` adds in
another order, and the DP's ``<=`` tie rule can then take another span. So
the DP matrices and spans equal the JAX package's bit for bit on the CPU,
and the card computes the same additions.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import resolve_device

_INF = 1e30
_BLOCK = 16  # the XLA CPU cumsum's block


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums along the last axis, added left to right from 0."""
    out = torch.empty_like(x)
    acc = x[..., 0] + 0.0
    out[..., 0] = acc
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
        out[..., k] = acc
    return out


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """float32 prefix sums along the last axis in the XLA CPU order."""
    F = x.shape[-1]
    if F <= _BLOCK:
        return _sequential_cumsum(x)
    nb = -(-F // _BLOCK)
    blk = torch.nn.functional.pad(x, (0, nb * _BLOCK - F)).reshape(*x.shape[:-1], nb, _BLOCK)
    inb = _sequential_cumsum(blk)
    tot = blocked_cumsum(inb[..., -1])
    excl = torch.cat([torch.zeros_like(tot[..., :1]), tot[..., :-1]], dim=-1)
    return (inb + excl[..., None]).reshape(*x.shape[:-1], nb * _BLOCK)[..., :F]


def _cost_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Accumulated-cost matrix D [N, M] with |a_i − b_j| local cost and steps
    {(1,0),(0,1),(1,1)}; row 0 is the prefix sum of its local costs."""
    local = (a[:, None] - b[None, :]).abs()
    N, M = local.shape
    D = torch.full((N, M), _INF, dtype=torch.float32, device=a.device)
    D[0] = blocked_cumsum(local[0])
    for d in range(1, N + M - 1):  # anti-diagonal i + j = d, rows i >= 1
        i = torch.arange(max(1, d - M + 1), min(N - 1, d) + 1, device=a.device)
        if i.numel() == 0:
            continue
        j = d - i
        up = D[i - 1, j]
        jm = (j - 1).clamp(min=0)
        left = torch.where(j > 0, D[i, jm], _INF)
        diag = torch.where(j > 0, D[i - 1, jm], _INF)
        D[i, j] = local[i, j] + torch.minimum(torch.minimum(left, up), diag)
    return D


def _pair(a, b, device) -> tuple[torch.Tensor, torch.Tensor]:
    dev = resolve_device(device)
    return (torch.as_tensor(np.asarray(a, np.float32), device=dev),
            torch.as_tensor(np.asarray(b, np.float32), device=dev))


def dtw_distance(a, b, device="cuda") -> float:
    """Total DTW distance between two 1-D sequences."""
    a, b = _pair(a, b, device)
    return float(_cost_matrix(a, b)[-1, -1])


def dtw_path(a, b, device="cuda") -> tuple[float, list[tuple[int, int]]]:
    """(distance, path) — path as (i, j) index pairs, fastdtw-style."""
    a, b = _pair(a, b, device)
    D = _cost_matrix(a, b).cpu().numpy()
    i, j = D.shape[0] - 1, D.shape[1] - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            moves = [(D[i - 1, j - 1], i - 1, j - 1), (D[i - 1, j], i - 1, j), (D[i, j - 1], i, j - 1)]
            _, i, j = min(moves)
        path.append((i, j))
    path.reverse()
    return float(D[-1, -1]), path


def monotonic_partition_costs(cost: torch.Tensor) -> torch.Tensor:
    """[..., L, F] local costs → D [..., L+1, F+1] float32 with D[0, :] = 0,
    D[i, 0] = INF (i ≥ 1), D[i, j] = cost[i-1, j-1] + min(D[i-1, j-1],
    D[i, j-1]). Rows are computed top-down, so D[:n+1] is exactly the DP of
    cost[:n]: callers may pad L to a bucket and slice the prefix they need."""
    cost = cost.float()
    *lead, L, F = cost.shape
    s = blocked_cumsum(cost)  # [..., L, F]: every row's prefix sums
    shifted = torch.cat([torch.zeros_like(s[..., :1]), s[..., :-1]], dim=-1)
    rows = [torch.zeros((*lead, F + 1), dtype=torch.float32, device=cost.device)]
    inf = torch.full((*lead, 1), _INF, dtype=torch.float32, device=cost.device)
    for i in range(L):
        best_entry = torch.cummin(rows[-1][..., :-1] - shifted[..., i, :], dim=-1).values
        rows.append(torch.cat([inf, s[..., i, :] + best_entry], dim=-1))
    return torch.stack(rows, dim=-2)


monotonic_partition_costs_batched = monotonic_partition_costs  # [B, L, F] → [B, L+1, F+1], the JAX package's name


def monotonic_partition_backtrack(D: np.ndarray) -> np.ndarray:
    """Host backtrack (O(L+F)) over a ``monotonic_partition_costs`` prefix:
    → [L, 2] frame spans (start, end). Tie rule: diagonal wins, matching
    the fill order (choice = D[i-1, j-1] <= D[i, j-1])."""
    n_tok = D.shape[0] - 1
    spans = np.zeros((n_tok, 2))
    i, j = n_tok, D.shape[1] - 1
    end_j = j
    while i > 0 and j > 0:
        if D[i - 1, j - 1] <= D[i, j - 1]:
            spans[i - 1] = (j - 1, end_j)
            i -= 1
            end_j = j - 1
        j -= 1
    return spans


def monotonic_partition_spans_batched(cost: torch.Tensor, n_tok: torch.Tensor, n_fr: torch.Tensor) -> torch.Tensor:
    """[B, L, F] local costs and the REAL sizes n_tok [B], n_fr [B] → spans
    [B, L, 2] float32 frame indices, rows ≥ n_tok[b] zero. The same as
    ``monotonic_partition_backtrack(D[b, :n_tok[b]+1, :n_fr[b]+1])`` per item
    (same ``<=`` tie rule); the walk starts at (n_tok[b], n_fr[b]) and each
    step lowers j by one, so pad rows and columns never reach a real span.
    The walk is a loop over frames, all items together, for as many frames
    as the longest item has."""
    D = monotonic_partition_costs(cost)  # [B, L+1, F+1]
    B, L, F = cost.shape
    dev = cost.device
    # take[b, i-1, j-1]: the path enters row i-1 at column j (the diagonal wins ties)
    take_all = D[:, :-1, :-1] <= D[:, 1:, :-1]  # [B, L, F]
    i = n_tok.to(device=dev, dtype=torch.int64).clone()
    nf = n_fr.to(device=dev, dtype=torch.int64)
    end_j = nf.clone()
    spans = torch.zeros((B, L + 1, 2), dtype=torch.float32, device=dev)  # row L: the dropped writes
    bidx = torch.arange(B, device=dev)
    steps = min(int(nf.max()) if B else 0, F)
    for t in range(steps):
        j = nf - t
        ok = (i > 0) & (j > 0)
        take = ok & take_all[bidx, (i - 1).clamp(min=0), (j - 1).clamp(min=0)]
        row = torch.where(take, i - 1, L)
        spans[bidx, row] = torch.stack([(j - 1).float(), end_j.float()], dim=-1)
        i = i - take.long()
        end_j = torch.where(take, j - 1, end_j)
    return spans[:, :L]
