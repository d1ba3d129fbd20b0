"""Parameter placements (megatron-style tensor parallelism) and the
collectives of the sharded forward.

Maps the ``DecoderLM`` state_dict onto a ("data", "model") mesh. Kernels are
stored ``[in, out]``, so "column parallel" shards dim 1:

- embed [V, D]                → Shard(1)   (D sharded; rows gathered once)
- attn q/k/v kernels [D, H·d] → Shard(1)   (column parallel)
- attn o kernel [H·d, D]      → Shard(0)   (row parallel → all-reduce)
- mlp gate/up [D, F]          → Shard(1)
- mlp down [F, D]             → Shard(0)
- lm_head [D, V]              → Shard(1)   (vocab-sharded logits)
- norms/bias/LoRA A/B         → replicated (adapters are tiny; replicating
  them keeps the optimizer's moments replicated too)

Quantized storage (``models.quant``) follows its kernel: ``kernel_q`` (int8
[in, out], NF4 packed [in/2, out] with rows 2i and 2i+1 in one byte) as the
kernel, an int8 per-output ``kernel_scale`` [out] on "model" for the column
kernels, a blockwise scale [in/block, out] as the kernel.

XLA inserted the collectives from such annotations; here the model's forward
calls them itself (:class:`ModelShards`), as autograd functions whose
backward is the adjoint for a computation replicated over "model": the
column-parallel input is copied forward and summed backward, the
row-parallel output summed forward and passed through backward.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

_COL = {"q", "k", "v", "gate", "up"}
_ROW = {"o", "down"}


def _model_placement(name: str, shape: tuple[int, ...]):
    parts = name.split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    if leaf in ("lora_a", "lora_b", "scale", "bias"):
        return Replicate()
    if leaf == "embedding":
        return Shard(1)
    if leaf in ("kernel", "kernel_q"):
        if parent in _COL or parent == "lm_head":
            return Shard(1)
        if parent in _ROW:
            return Shard(0)
        return Replicate()
    if leaf == "kernel_scale":
        if len(shape) == 1:  # int8 per-output-channel scale [out]
            return Shard(0) if parent in _COL else Replicate()
        return Shard(1) if parent in _COL else Shard(0) if parent in _ROW else Replicate()
    return Replicate()


def llm_param_spec(model_or_state_dict) -> dict:
    """name → placements on the ("data", "model") mesh, for every entry of
    the state_dict (parameters and the quantized buffers): everything is
    replicated over "data"; the second placement is the tensor-parallel
    policy. On a ("dcn", "data", "model") mesh the last placement applies
    to "model" and the others replicate."""
    sd = model_or_state_dict.state_dict() if isinstance(model_or_state_dict, nn.Module) else model_or_state_dict
    return {name: (Replicate(), _model_placement(name, tuple(t.shape))) for name, t in sd.items()}


def model_partial_grad(name: str) -> bool:
    """True for a replicated leaf whose gradient on one rank covers only that
    rank's share (summed over "model" to make it whole): the adapters and
    biases of the column-parallel projections, whose used columns are the
    rank's, and ``lora_a`` of the row-parallel ones, whose used rows are.
    Every other replicated leaf sees the replicated activations and gets the
    whole gradient on every rank."""
    parts = name.split(".")
    leaf, parent = parts[-1], parts[-2] if len(parts) >= 2 else ""
    if parent in _COL:
        return leaf in ("lora_a", "lora_b", "bias")
    return parent in _ROW and leaf == "lora_a"


# ---------------------------------------------------------------------------
# collectives of the sharded forward
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    """Identity forward; all-reduce (sum) of the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce (sum) forward, in place: every caller passes a fresh
    contiguous intermediate that no backward reads (autograd's version
    check raises if one ever does); the gradient passes through."""

    @staticmethod
    def forward(ctx, x, group):
        dist.all_reduce(x, group=group)
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along the last dim forward; the gradient's own block
    backward."""

    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.rank, ctx.width = rank, x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.width, ctx.width), None, None, None


@dataclass(frozen=True)
class ModelShards:
    """This rank's place on a ("data", "model") or ("dcn", "data", "model")
    mesh, as the sharded forward, loss and gradient reduction read it.
    ``batch_groups`` are the groups of the batch dims ("data", and "dcn"
    where the mesh has it) that hold more than one rank: a sum over each in
    turn is a sum over all of them. A collective over one rank is the
    identity, so none is called: on a 1 x 1 mesh the step calls none."""

    mesh: DeviceMesh
    model_size: int
    model_rank: int
    model_group: object
    batch_groups: tuple
    batch_size: int
    batch_rank: int

    @classmethod
    def of(cls, mesh: DeviceMesh) -> "ModelShards":
        names = mesh.mesh_dim_names or ()
        if "model" not in names or "data" not in names:
            raise ValueError(f"mesh dims {names}: expected ('data', 'model') or ('dcn', 'data', 'model')")
        if mesh.get_coordinate() is None:
            raise ValueError("this rank is not part of the mesh")
        batch_dims = [d for d in ("dcn", "data") if d in names]
        batch_rank = 0
        for d in batch_dims:
            batch_rank = batch_rank * mesh.size(names.index(d)) + mesh.get_local_rank(d)
        batch_size = 1
        for d in batch_dims:
            batch_size *= mesh.size(names.index(d))
        return cls(
            mesh=mesh,
            model_size=mesh.size(names.index("model")),
            model_rank=mesh.get_local_rank("model"),
            model_group=mesh.get_group("model"),
            batch_groups=tuple(mesh.get_group(d) for d in reversed(batch_dims) if mesh.size(names.index(d)) > 1),
            batch_size=batch_size,
            batch_rank=batch_rank,
        )

    def block(self, n: int) -> slice:
        """This rank's contiguous block of a dim of ``n`` split over "model"."""
        w = n // self.model_size
        return slice(self.model_rank * w, (self.model_rank + 1) * w)

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.model_size == 1 else _CopyToModel.apply(x, self.model_group)

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.model_size == 1 else _ReduceFromModel.apply(x, self.model_group)

    def gather_from_model(self, x: torch.Tensor) -> torch.Tensor:
        if self.model_size == 1:
            return x
        return _GatherFromModel.apply(x, self.model_group, self.model_size, self.model_rank)

    def max_over_model(self, x: torch.Tensor) -> torch.Tensor:
        """Element-wise maximum over "model" (no gradient)."""
        if self.model_size == 1:
            return x.detach()
        y = x.detach().contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.model_group)
        return y

    def sum_over_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the batch dims; the gradient passes through (every
        rank's loss is the same global loss)."""
        for g in self.batch_groups:
            x = _ReduceFromModel.apply(x, g)
        return x

    def reduce_grads(self, named_params) -> None:
        """Make the gradients of the trainable leaves whole, in place: the
        model-partial leaves summed over "model", then every leaf summed
        over the batch dims, each reduction over one flat buffer copied back
        by one multi-tensor copy. (Leaving the ``.grad``s as slices of the
        buffer would move their alignment, and the CPU's vectorised
        optimizer arithmetic rounds by alignment.)"""
        named = [(n, p) for n, p in named_params if p.grad is not None]
        partial = [p for n, p in named if model_partial_grad(n)]
        model_groups = (self.model_group,) if self.model_size > 1 else ()
        for params, groups in ((partial, model_groups), ([p for _, p in named], self.batch_groups)):
            if not params or not groups:
                continue
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            for g in groups:
                dist.all_reduce(flat, group=g)
            grads = [p.grad for p in params]
            torch._foreach_copy_(grads, [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads]), grads)])


def check_divisible(cfg, model_size: int) -> None:
    """Refuse a "model" size that does not split the heads, the KV heads,
    the MLP width, the model width (the embedding) and the vocabulary (the
    head) evenly."""
    sizes = {"heads": cfg.heads, "kv_heads": cfg.kv_heads, "ffn": cfg.ffn, "dim": cfg.dim, "vocab_size": cfg.vocab_size}
    bad = {k: v for k, v in sizes.items() if v % model_size}
    if bad:
        raise ValueError(f"a 'model' dim of {model_size} does not divide {bad}")


def shard_params(model, mesh: DeviceMesh) -> ModelShards:
    """Keep only this rank's shard of every sharded leaf of ``model`` (a
    ``DecoderLM``), in place, and tell its modules where they sit. The
    parameters stay the same objects, so an optimizer made over them keeps
    working; returns the model's :class:`ModelShards`."""
    if getattr(model, "shards", None) is not None:
        raise ValueError("shard_params: the model is sharded already")
    shards = ModelShards.of(mesh)
    check_divisible(model.cfg, shards.model_size)
    specs = llm_param_spec(model)
    if shards.model_size > 1:
        with torch.no_grad():
            for name, t in list(model.named_parameters()) + list(model.named_buffers()):
                pl = specs[name][-1]
                if isinstance(pl, Shard):
                    n = t.shape[pl.dim]
                    blk = shards.block(n)
                    t.data = t.data.narrow(pl.dim, blk.start, blk.stop - blk.start).clone()
    for name, module in model.named_modules():
        module.shards = shards
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _COL or leaf in _ROW:
            module.split = "col" if leaf in _COL else "row"
    return shards
