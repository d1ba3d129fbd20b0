"""Sharded prosody measurement: the corpus batch axis over the mesh's
"data" dim.

The measure passes are independent row by row, so scaling them over ranks
is pure data parallelism: every rank takes the full host arrays, pads S to a
multiple of the "data" size, measures its own block of rows on its device
(``prosody.measure.measure_nat`` and ``measure_raw``, so kernels A and B run
on each rank's rows) and all-gathers the packed outputs over "data". Ranks
that differ only in their "model" coordinate compute the same rows.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.kernels import dsp_precision
from ..ops.pitch import PitchParams
from ..prosody.measure import _pack6, _unpack6, measure_nat, measure_raw


def pad_batch(arr: np.ndarray, multiple: int) -> np.ndarray:
    S = arr.shape[0]
    Sp = ((S + multiple - 1) // multiple) * multiple
    if Sp == S:
        return arr
    pad = [(0, Sp - S)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def measure_sharded(
    mesh: DeviceMesh,
    nat: np.ndarray,
    nat_len: np.ndarray,
    raw: np.ndarray,
    raw_len: np.ndarray,
    win_nat: np.ndarray,
    win_raw: np.ndarray,
    mask: np.ndarray,
    rate: float,
    pitch_params: PitchParams | None = None,
):
    """The six measure outputs (p_syn, p_seg, l_nat_syn, l_nat_seg,
    l_raw_syn, l_raw_seg) of every row, as host numpy trimmed back to S, on
    every rank. Padded rows are zero-length signals with masked-out windows
    and are never read."""
    pp = pitch_params or PitchParams()
    names = mesh.mesh_dim_names
    ndata = mesh.size(names.index("data"))
    me = mesh.get_local_rank("data")
    dev = torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda" else torch.device("cpu")
    dsp_precision()
    S = nat.shape[0]
    args = [pad_batch(np.asarray(a), ndata) for a in (nat, nat_len, raw, raw_len, win_nat, win_raw, mask)]
    per = args[0].shape[0] // ndata
    rows = slice(me * per, (me + 1) * per)

    def put(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a[rows])).to(device=dev, dtype=dtype)

    nat_t, nat_len_t, raw_t, raw_len_t = put(args[0]), put(args[1], torch.int64), put(args[2]), put(args[3], torch.int64)
    win_nat_t, win_raw_t, mask_t = put(args[4], torch.int64), put(args[5], torch.int64), put(args[6])
    nat_out = measure_nat(nat_t, nat_len_t, win_nat_t, mask_t, float(rate), int(args[0].shape[1]), pp)
    raw_out = measure_raw(raw_t, raw_len_t, win_raw_t, float(rate), int(args[2].shape[1]))
    local = _pack6((*nat_out, *raw_out)).contiguous()
    parts = [torch.empty_like(local) for _ in range(ndata)]
    dist.all_gather(parts, local, group=mesh.get_group("data"))
    out = _unpack6(torch.cat(parts).cpu().numpy())
    return tuple(o[:S] for o in out)
