"""Mesh construction and basic placement helpers.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the dims
``("data", "model")`` over the ranks of the default process group: one rank
drives one device, ``nccl`` between CUDA devices and ``gloo`` for
``device="cpu"``. Placements (``Shard(d)``, ``Replicate()``) stand where a
``PartitionSpec`` would, one per mesh dim.

The production measure path is different: one process splits its corpus
batch over the devices it can see (:func:`production_data_mesh`), with no
process group at all.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..ops.kernels import resolve_device


def backend_for(device) -> str:
    """The process-group backend of a device: ``nccl`` on CUDA, ``gloo`` on
    the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def ensure_process_group(device="cuda") -> None:
    """Make a one-rank process group for this process when none exists (an
    in-process store: no address, no port), so that a single process gets a
    mesh as a single JAX process does."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    device_id = None
    if dev.type == "cuda":
        device_id = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(device_id)
    dist.init_process_group(backend_for(dev), store=dist.HashStore(), world_size=1, rank=0, device_id=device_id)


def make_mesh(data: int = 1, model: int = 1, device="cuda") -> DeviceMesh:
    """("data", "model") mesh over the first ``data·model`` ranks of the
    default group, the model dim fastest (rank = d·model + m). Without a
    process group, a 1 x 1 mesh makes a one-rank group itself."""
    dev = resolve_device(device)
    need = data * model
    if not dist.is_initialized() and need == 1:
        ensure_process_group(dev)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n < need:
        raise ValueError(f"need {need} devices, have {n}")
    ranks = torch.arange(need).reshape(data, model)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=("data", "model"))


def local_mesh(model_parallel: int | None = None, device="cuda") -> DeviceMesh:
    """Mesh over every rank of the default group: the model dim as given, or
    the largest of 4 and 2 that divides the world size (else 1); data the
    rest."""
    dev = resolve_device(device)
    ensure_process_group(dev)
    n = dist.get_world_size()
    if model_parallel is None:
        model_parallel = 1
        for cand in (4, 2):
            if n % cand == 0 and n >= cand:
                model_parallel = cand
                break
    return make_mesh(n // model_parallel, model_parallel, dev)


def data_sharding(mesh: DeviceMesh) -> tuple:
    """Placements of a batch-major tensor: rows over "data", whole on every
    other dim."""
    return tuple(Shard(0) if name == "data" else Replicate() for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> tuple:
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


_PRODUCTION_CACHE: dict = {}


def production_data_mesh(device="cuda") -> list[torch.device] | None:
    """The devices the PRODUCTION measure path splits its corpus batch over
    (``prosody.measure``: each slot measures a contiguous block of the
    segment rows on its device), or None when only one would take part.

    Off unless ``PCFT_DATA_MESH=N`` asks for the first N CUDA devices (or N
    slots on the one CPU device, the test fixture that stands for several
    devices; ``0`` and ``1`` are off). One thread drives the slots one after
    another and the pass is bound by its launches, so more cards make it
    slower: on H100s, 10 segments over four cards took 4.3 times one card's
    time. A process that belongs to a process group of more than one rank
    drives its own device only, and gets None."""
    dev = resolve_device(device)
    env = os.environ.get("PCFT_DATA_MESH")
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    world = dist.get_world_size() if dist.is_initialized() else 1
    key = (env, dev.type, count, world)
    if key in _PRODUCTION_CACHE:
        return _PRODUCTION_CACHE[key]
    n = 1
    if env is not None:
        try:
            n = int(env)
        except ValueError:
            raise ValueError(f"PCFT_DATA_MESH must be an integer device count (0 disables), got {env!r}") from None
        if dev.type == "cuda":
            n = min(count, n)
    if world > 1:
        n = 1
    slots = [torch.device("cuda", i) for i in range(n)] if dev.type == "cuda" else [torch.device("cpu")] * n
    mesh = slots if n > 1 else None
    _PRODUCTION_CACHE[key] = mesh
    return mesh
