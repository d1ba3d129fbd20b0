"""Training loops: LoRA fine-tuning of the decoder LM.

Mirrors the reference's HF-Trainer setups (bf16 base, gradient accumulation,
lr 3e-4, adamw, LoRA-only updates) as explicit steps. PyTorch's idiom inside:
the model is the parameter store and is updated in place; ``requires_grad`` is
set only on the trainable leaves, so no weight gradient of a frozen kernel is
ever computed (about a third of the step's operations in the LoRA shape);
``torch.optim.AdamW`` runs over those leaves only, so the frozen base carries
no optimizer state. Integer leaves (quantized base kernels, ``models.quant``)
are buffers and ride along as constants: a LoRA step over an ``int8b`` or
``nf4`` base is the QLoRA shape.

On the card the step's attention (``cfg.attn_impl="vmem"`` up to L 512,
``"flash"`` at any L that is a multiple of 128) and loss (``loss_impl``
fused) are the hand-written CUDA kernels of ``ops.vmem_attn`` or
``ops.flash_attention`` and of ``ops.fused_ce``, forward and backward.

Data and tensor parallelism: :func:`shard_train_inputs` keeps this rank's
shard of the model (``parallel.sharding``: megatron-style over the mesh's
"model" dim) and its rows of the batch (over "data", or "dcn" and "data");
:func:`make_train_step` on such a model computes the global masked mean,
makes every trainable gradient whole before the update (summed over "model"
where a rank saw only its share, then over the batch dims) and so leaves the
replicated leaves bit-identical on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.profiling import span
from ..ops.fused_ce import linear_ce_supported
from ..ops.kernels import dsp_precision, resolve_device
from ..parallel.sharding import llm_param_spec, shard_params
from .llm import DecoderLM, LLMConfig, causal_lm_loss, causal_lm_loss_fused
from .lora import lora_param_mask


@dataclass
class TrainState:
    # the model's ``state_dict()``: live views, updated in place by the step
    params: dict
    # the optimizer (:class:`AccumAdamW`): moments of the trainable leaves only
    opt_state: object
    # name → bool over ``params`` marking the trainable leaves the optimizer
    # covers; pass it as make_train_step(trainable=state.mask)
    mask: dict | None = None


class AccumAdamW:
    """adamw (b1 0.9, b2 0.999, eps 1e-8) with gradient accumulation, as
    ``optax.MultiSteps`` takes it: parameters unchanged in between, one
    update every ``accum`` calls of :meth:`step` on the mean of the
    ``accum`` gradients. The mean is kept in float32 buffers beside the
    trainable leaves and updated as optax updates it, ``acc + (g - acc) / n``
    after the n-th gradient (a sum divided by ``accum`` at the end rounds
    otherwise); each micro-step's gradient lands in a cleared ``.grad``.
    With ``accum`` 1 the gradient goes to the update as it is."""

    def __init__(self, params, lr: float, weight_decay: float, accum: int):
        if accum < 1:
            raise ValueError(f"accum={accum} must be at least 1")
        self.params = list(params)
        self.accum = accum
        self.mini_step = 0
        self.acc = None  # the running means, made at the first accumulation
        self.inner = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)

    def _accumulate(self) -> None:
        """Fold each leaf's ``.grad`` into its running mean and clear it (no
        gradient counts as a zero one): three multi-tensor passes."""
        if self.acc is None:
            self.acc = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        grads = [p.grad if p.grad is not None else torch.zeros_like(acc) for p, acc in zip(self.params, self.acc)]
        # a tensor divisor: CUDA divides exactly by it (a host scalar becomes a reciprocal's product)
        n = torch.full((), float(self.mini_step), dtype=torch.float32, device=self.acc[0].device)
        with torch.no_grad():
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, n)
            torch._foreach_add_(self.acc, diff)
        for p in self.params:
            p.grad = None

    def step(self, before_update=None) -> None:
        """One micro-step (the span ``train.optimizer``). On the update call
        ``before_update()`` (if given) runs first, with the gradients to
        apply in the leaves' ``.grad``."""
        with span("train.optimizer"):
            self.mini_step += 1
            if self.accum > 1:
                self._accumulate()
                if self.mini_step < self.accum:
                    return
                for p, acc in zip(self.params, self.acc):
                    p.grad = acc
            if before_update is not None:
                before_update()
            self.inner.step()
            self.inner.zero_grad(set_to_none=True)
            if self.acc is not None:
                for acc in self.acc:
                    acc.zero_()
            self.mini_step = 0


def make_optimizer(params, lr: float = 3e-4, weight_decay: float = 0.0, accum: int = 1) -> AccumAdamW:
    """adamw over ``params`` (the trainable leaves: LoRA adapters only in the
    reference's setup), with gradient accumulation (batch 1 × accum 16/32 in
    the reference). Weight decay is 0 unless asked for."""
    return AccumAdamW(params, lr, weight_decay, accum)


def _trainable_parameters(model: DecoderLM, mask: dict | None):
    """(name, parameter) of the float parameters marked trainable (None →
    every float parameter). Buffers never train."""
    return [
        (name, p)
        for name, p in model.named_parameters()
        if p.is_floating_point() and (mask is None or mask.get(name, False))
    ]


def init_train(
    cfg: LLMConfig,
    seed: int = 0,
    lr: float = 3e-4,
    accum: int = 1,
    lora_only: bool = True,
    frozen_dtype: torch.dtype | None = None,
    device="cuda",
):
    """Build (model, tx, TrainState) on ``device`` from ``seed``. The
    optimizer covers ONLY the trainable float leaves (the LoRA adapters when
    ``lora_only`` and ``cfg.lora_rank > 0``, otherwise every float
    parameter), and only those have ``requires_grad``. ``frozen_dtype`` (e.g.
    ``torch.bfloat16``) downcasts the frozen float leaves — the reference
    loads its base in bf16 too — halving the per-step weight stream; each
    submodule is downcast as soon as it is built, so the float32 base never
    exists whole. The trainable mask ships in ``state.mask``; hand it to
    ``make_train_step(trainable=state.mask)``."""
    dev = resolve_device(device)
    adapters_only = lora_only and cfg.lora_rank > 0

    def is_trainable(name: str) -> bool:
        return name.rsplit(".", 1)[-1] in ("lora_a", "lora_b") if adapters_only else True

    def freeze(module) -> None:
        for name, p in module.named_parameters():
            if not (p.is_floating_point() and is_trainable(name)):
                p.requires_grad_(False)
                if frozen_dtype is not None and p.is_floating_point():
                    p.data = p.data.to(frozen_dtype)

    model = DecoderLM(cfg, device=dev, seed=seed, on_built=freeze)
    params = model.state_dict()
    if adapters_only:
        mask = lora_param_mask(params)
    else:
        names = {name for name, p in model.named_parameters() if p.is_floating_point()}
        mask = {k: k in names for k in params}
    tx = make_optimizer([p for _, p in _trainable_parameters(model, mask)], lr, accum=accum)
    return model, tx, TrainState(params=params, opt_state=tx, mask=mask)


def make_train_step(
    model: DecoderLM,
    tx: AccumAdamW,
    trainable: dict | None = None,
    loss_impl: str = "auto",
    scan_steps: int | None = None,
):
    """One forward + backward + update: ``step(ids [B, L], loss_mask [B, L])
    → loss`` (a 0-dim float32 tensor on the model's device, not synchronised).
    The model and the optimizer state are updated in place, so the JAX
    package's ``donate`` has no meaning here and is left out.

    ``scan_steps=N`` returns instead ``fn(ids [N, B, L], loss_mask) →
    losses [N]``: the same step over N pre-staged batches (a plain loop:
    PyTorch runs eagerly, there is no single-launch program to build).

    ``trainable`` (name → bool over the ``state_dict``, i.e. ``state.mask``
    from :func:`init_train`) restricts differentiation AND the optimizer to
    those leaves: ``requires_grad`` is set from it (None → every float
    parameter), and ``tx`` must have been made over the same leaves.

    ``loss_impl``: ``"fused"`` routes the LM head through ``ops.fused_ce`` —
    no [B, L, V] logits in device memory. ``"auto"`` picks it whenever the
    geometry tiles (dim % 128, vocab % 512) and the head is frozen; tiny test
    configs fall back to the dense loss. The fused kernel computes NO dW for
    the head, so it is only legal when the ``lm_head`` kernel is frozen — true
    for every LoRA mask; a full fine-tune (``trainable=None`` or the head
    marked True) must take ``"dense"``, and ``"fused"`` then raises."""
    if loss_impl not in ("auto", "fused", "dense"):
        raise ValueError(f"loss_impl={loss_impl!r}: expected 'auto', 'fused' or 'dense'")
    head_frozen = trainable is not None and not trainable.get("lm_head.kernel", True)
    if loss_impl == "fused" and not head_frozen:
        raise ValueError(
            "loss_impl='fused' requires a frozen lm_head (the fused CE "
            "computes no dW); pass the LoRA trainable mask or use 'dense'"
        )
    use_fused = loss_impl == "fused" or (
        loss_impl == "auto" and linear_ce_supported(model.cfg.dim, model.cfg.vocab_size) and head_frozen
    )
    named = _trainable_parameters(model, trainable)
    chosen = {id(p) for _, p in named}
    for p in model.parameters():
        p.requires_grad_(id(p) in chosen)
    if chosen != {id(p) for p in tx.params}:
        raise ValueError("make_train_step: the optimizer was not made over the trainable leaves")
    dev = model.embed.embedding.device
    shards = model.shards
    calls = 0  # micro-steps since the step was made: the args of its spans

    def step_fn(ids, loss_mask):
        nonlocal calls
        calls += 1
        with span("train.step", calls - 1):
            dsp_precision()
            ids = torch.as_tensor(ids).to(dev)
            loss_mask = torch.as_tensor(loss_mask).to(dev, torch.float32)
            if use_fused:
                hidden = model(ids, return_hidden=True)
                head = model.lm_head.kernel
                if shards is not None:
                    # kernel H's backward needs the whole vocabulary's lse, so it
                    # reads the whole (frozen) head: gathered over "model"
                    with torch.no_grad():
                        head = shards.gather_from_model(head)
                loss = causal_lm_loss_fused(hidden, head, ids, loss_mask, shards)
            else:
                loss = causal_lm_loss(model(ids), ids, loss_mask, shards)
            loss.backward()
            # on a sharded model, once per update: the accumulated local gradients made whole
            tx.step(None if shards is None else lambda: shards.reduce_grads(named))
            return loss.detach()

    step_fn.loss_impl = "fused" if use_fused else "dense"
    if scan_steps is None:
        return step_fn

    def multi_fn(ids_stacked, loss_mask):
        ids_stacked = torch.as_tensor(ids_stacked)
        if ids_stacked.shape[0] != scan_steps:
            raise ValueError(f"expected {scan_steps} stacked batches, got {ids_stacked.shape[0]}")
        return torch.stack([step_fn(ids, loss_mask) for ids in ids_stacked])

    multi_fn.loss_impl = step_fn.loss_impl
    return multi_fn


def shard_train_inputs(mesh, model: DecoderLM, tx: AccumAdamW, ids, loss_mask):
    """Place the training state on ``mesh`` (a ``DeviceMesh`` with dims
    ("data", "model") or ("dcn", "data", "model")): the model keeps this
    rank's shard of every leaf per ``parallel.sharding.llm_param_spec``, in
    place (a model sharded on this mesh already is left as it is); the
    optimizer's moments stay replicated with their LoRA leaves (the moments
    of a trainable leaf that the policy shards are cut the same way). Every
    rank passes the same global ``ids`` [B, L] and ``loss_mask``; returns this
    rank's rows of them over the batch dims, B split evenly."""
    if model.shards is None:
        specs = llm_param_spec(model)
        shards = shard_params(model, mesh)
        for name, p in model.named_parameters():
            pl = specs[name][-1]
            for st in tx.inner.state.get(p, {}).values():
                if pl.is_shard() and torch.is_tensor(st) and st.dim() == p.dim() and st.shape != p.shape:
                    blk = shards.block(st.shape[pl.dim])
                    st.data = st.data.narrow(pl.dim, blk.start, blk.stop - blk.start).clone()
    elif model.shards.mesh is not mesh:
        raise ValueError("shard_train_inputs: the model is sharded on another mesh")
    shards = model.shards
    ids, loss_mask = torch.as_tensor(ids), torch.as_tensor(loss_mask)
    B = ids.shape[0]
    if B % shards.batch_size:
        raise ValueError(f"batch {B} does not split evenly over {shards.batch_size} batch ranks")
    per = B // shards.batch_size
    rows = slice(shards.batch_rank * per, (shards.batch_rank + 1) * per)
    return ids[rows], loss_mask[rows]
