"""Multi-process initialisation and hybrid meshes.

- :func:`initialize` starts the default process group from the same
  variables as a multi-host JAX run (``PCFT_NUM_PROCESSES``,
  ``PCFT_COORDINATOR``, ``PCFT_PROCESS_ID``), or from arguments;
- :func:`hybrid_mesh` builds a ("dcn", "data", "model") mesh: the model dim
  inside a host (NVLink), data within the host's slice, slices across hosts,
  so that only the data-parallel reductions cross the network;
- :func:`host_local_batch_slice` gives each host the rows it feeds.

One process drives one device, so a slice is a host: ranks are grouped by
``LOCAL_WORLD_SIZE`` (torchrun's variable), or form one slice when it is
unset. Single-process runs skip initialisation and get a dcn dim of size 1.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.kernels import resolve_device
from .mesh import backend_for, ensure_process_group

log = logging.getLogger(__name__)


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
    timeout_s: float = 600.0,
) -> bool:
    """Start the default process group over ``tcp://<coordinator>`` and
    return True when running multi-process; return False and do nothing for
    one process. The backend follows ``device``: ``nccl`` on CUDA (each rank
    on device ``LOCAL_RANK``, else its rank modulo the visible devices),
    ``gloo`` on the CPU."""
    num_processes = num_processes or int(os.environ.get("PCFT_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return False
    dev = resolve_device(device)
    rank = process_id if process_id is not None else int(os.environ.get("PCFT_PROCESS_ID", "0"))
    device_id = None
    if dev.type == "cuda":
        device_id = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
        torch.cuda.set_device(device_id)
    dist.init_process_group(
        backend_for(dev),
        init_method=f"tcp://{coordinator or os.environ.get('PCFT_COORDINATOR', 'localhost:1234')}",
        world_size=num_processes,
        rank=rank,
        timeout=timedelta(seconds=timeout_s),
        device_id=device_id,
    )
    log.info("torch.distributed: process %d/%d (%s)", dist.get_rank(), dist.get_world_size(), backend_for(dev))
    return True


def hybrid_mesh(model: int = 1, data: int | None = None, slices: int | None = None, device="cuda") -> DeviceMesh:
    """("dcn", "data", "model") mesh over every rank of the default group,
    rank = (slice·data + d)·model + m. Slice count: explicit ``slices``,
    else one slice per host of ``LOCAL_WORLD_SIZE`` ranks, else one."""
    dev = resolve_device(device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if slices is not None:
        n_slices = slices
        if n % n_slices:
            raise ValueError(f"{n} devices not divisible into {n_slices} slices")
    else:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        n_slices = n // local if local and n % local == 0 else 1
    per_slice = n // n_slices
    if data is None:
        data = per_slice // model
    if data * model != per_slice:
        raise ValueError(f"{per_slice} devices per slice ≠ data({data})×model({model})")
    ensure_process_group(dev)
    ranks = torch.arange(n_slices * data * model).reshape(n_slices, data, model)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=("dcn", "data", "model"))


def host_local_batch_slice(global_batch: int) -> slice:
    """The row range of the global batch this process's host feeds (each
    host materialises only its rows; the last host takes the remainder).
    Hosts are groups of ``LOCAL_WORLD_SIZE`` ranks (one host when it is
    unset or does not divide the world, as in :func:`hybrid_mesh`), so
    every rank of a host gets the same rows, as every device of one JAX
    process does."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if not local or world % local:
        local = world  # as hybrid_mesh: one host
    p, n = rank // local, world // local
    per = global_batch // n
    return slice(p * per, (p + 1) * per if p < n - 1 else global_batch)
