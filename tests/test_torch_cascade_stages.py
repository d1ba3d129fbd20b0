"""The paper's two cascade training stages, at the parity size, held to the
JAX package: stage A (``QwenA.py``: attention "flash", separate q/k/v,
remat with nothing saved, micro-batch 1, gradient accumulation) and stage B
(``QwenB.py``: the same with an NF4 base made by JAX's ``quantize_params``,
remat saving the matrix products), then stage B's trained tree recoded to
the int8b serving layout and decoded greedily.

Both sides run on the CPU in float32 from the same weights (the JAX
initialisers, carried by ``convert.llm_params_from_jax``) on the same
numpy-seeded batches, accumulation 4 over 8 calls (two updates). The JAX
side runs inside ``pltpu.force_tpu_interpret_mode()`` (the upstream flash
op runs only in interpret mode off the TPU), and without remat: ``nn.remat``
refuses the interpret-mode op's ordered IO callbacks ("Effects not supported
in partial-eval of `checkpoint`/`remat`"), and remat changes no value. The
port runs its kernels' plain versions with the stages' remat. Each
comparison states its tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from prosody_control_french_tts_tpu.models import llm as jllm, quant as jquant, training as jtraining
from prosody_control_french_tts_tpu_torch import convert
from prosody_control_french_tts_tpu_torch.models import llm as tllm, quant as tquant, training as ttraining
from prosody_control_french_tts_tpu_torch.ops import flash_attention as fa

# tests/test_torch_training.py's PARITY shape; L 128 is one tile of the flash op
PARITY = dict(vocab_size=1024, dim=128, layers=2, heads=4, kv_heads=2, ffn=256, max_len=128, lora_rank=4)
LR = 1e-3
ACCUM = 4
CALLS = 8
L = 128
PROMPT = 16  # loss-masked prompt positions (the instruction part of a pair)
STAGES = {
    "A": dict(attn_impl="flash", fused_qkv=False, remat=True, remat_policy=None),
    "B": dict(attn_impl="flash", fused_qkv=False, remat=True, remat_policy="dots", quant="nf4"),
}


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def batches():
    """Micro-batches [CALLS, 1, L], one a call, and the loss mask [1, L]."""
    ids = np.random.default_rng(11).integers(1, PARITY["vocab_size"], (CALLS, 1, L)).astype(np.int32)
    mask = np.ones((1, L), np.float32)
    mask[:, :PROMPT] = 0.0
    return ids, mask


def jax_stage(stage: str):
    """The JAX package's trainer for a stage: (initial tree, losses, final tree)."""
    kw = STAGES[stage]
    ids, mask = batches()
    with pltpu.force_tpu_interpret_mode():
        cfg = jllm.LLMConfig(**PARITY, dtype=jnp.float32, **{**kw, "remat": False})
        model, tx, state = jtraining.init_train(cfg, lr=LR, accum=ACCUM)
        params = state.params
        if kw.get("quant") == "nf4":
            floats = jllm.DecoderLM(dataclasses.replace(cfg, quant=None)).init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
            params = jquant.quantize_params(floats, "nf4")
            assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(state.params)
        step = jtraining.make_train_step(model, tx, donate=False, trainable=state.mask)
        p, o, losses = params, state.opt_state, []
        for i in range(CALLS):
            p, o, loss = step(p, o, jnp.asarray(ids[i]), jnp.asarray(mask))
            losses.append(float(loss))
    return params, losses, p


@pytest.fixture(scope="module")
def jax_runs():
    return {stage: jax_stage(stage) for stage in STAGES}


def port_trainer(stage: str, jinit, **overrides):
    cfg = tllm.LLMConfig(**PARITY, dtype=torch.float32, **{**STAGES[stage], **overrides})
    model, tx, state = ttraining.init_train(cfg, lr=LR, accum=ACCUM, device="cpu")
    model.load_state_dict(convert.llm_params_from_jax(to_numpy(jinit), cfg))
    step = ttraining.make_train_step(model, tx, trainable=state.mask)
    return model, state, step


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_stage_matches_jax(jax_runs, stage):
    """8 calls at accumulation 4: every loss within 2e-5 relative of the JAX
    trainer's (the bound of ``test_loss_curve_matches_jax``), the fused loss
    taken on both sides; the parameters unchanged but after calls 4 and 8;
    the flash op called twice a layer a call (the recompute calls it again);
    the adapters after the two updates within 0.25·lr·updates in every
    element and 2 % of lr·updates on average of JAX's (Adam moves every
    element by about lr an update whatever its gradient's size); every
    adapter moved; frozen leaves, the NF4 codes and scales among them,
    bit-equal to JAX's and to where they started, and no gradient on them."""
    jinit, jlosses, jfinal = jax_runs[stage]
    model, state, step = port_trainer(stage, jinit)
    assert step.loss_impl == "fused"
    if stage == "B":
        assert model.layers[0].mlp.gate.kernel_q.dtype == torch.uint8 and not state.mask["layers.0.mlp.gate.kernel_q"]
    start = {k: v.clone() for k, v in model.state_dict().items()}
    ids, mask = batches()
    losses = []
    for i in range(CALLS):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        n = fa.calls
        losses.append(float(step(ids[i], mask)))
        assert fa.calls - n == 2 * PARITY["layers"]
        changed = any(not torch.equal(v, before[k]) for k, v in model.state_dict().items())
        assert changed == ((i + 1) % ACCUM == 0), i
    for got, want in zip(losses, jlosses):
        assert abs(got - want) <= 2e-5 * abs(want), (losses, jlosses)
    updates = CALLS // ACCUM
    want = convert.llm_params_from_jax(to_numpy(jfinal), model.cfg)
    for name, t in model.state_dict().items():
        if state.mask[name]:
            diff = (t - want[name]).abs()
            assert float(diff.max()) <= 0.25 * LR * updates, name
            assert float(diff.mean()) <= 0.02 * LR * updates, name
            assert not torch.equal(t, start[name]), name
        else:
            assert torch.equal(t, start[name]) and torch.equal(t, want[name]), name
    assert all(b.grad is None for b in model.buffers())


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_one_update_without_remat_is_bit_equal(jax_runs, stage):
    """One update (4 calls) with remat and without it from the same weights
    and batches: the same losses and adapters bit for bit. Without remat a
    quantized kernel's backward dequantizes it again (``models.lora``); with
    remat the checkpoint recomputes it."""
    jinit = jax_runs[stage][0]
    ids, mask = batches()
    runs = []
    for remat in (True, False):
        model, state, step = port_trainer(stage, jinit, remat=remat)
        losses = [float(step(ids[i], mask)) for i in range(ACCUM)]
        runs.append((losses, {k: v for k, v in model.state_dict().items() if state.mask[k]}))
    assert runs[0][0] == runs[1][0]
    for name, t in runs[0][1].items():
        assert torch.equal(t, runs[1][1][name]), name


def test_stage_b_served_as_int8b_equals_jax(jax_runs):
    """Stage B's tree trained by the JAX package, recoded to the int8b
    serving layout by each package (byte-equal trees) and decoded greedily
    (2 prompts of 16 tokens, 12 new): the port's tokens equal JAX's."""
    jfinal = jax_runs["B"][2]
    jrec = jquant.recode_params_nf4_serving(jfinal)
    qcfg = tllm.LLMConfig(**PARITY, dtype=torch.float32, quant="nf4")
    rec = tquant.recode_params_nf4_serving(convert.llm_params_from_jax(to_numpy(jfinal), qcfg))
    scfg = dataclasses.replace(qcfg, quant="int8b")
    want_tree = convert.llm_params_from_jax(to_numpy(jrec), scfg)
    assert sorted(rec) == sorted(want_tree)
    for name, t in rec.items():
        assert t.dtype == want_tree[name].dtype and torch.equal(t, want_tree[name]), name
    model = tllm.DecoderLM(scfg, device="cpu")
    model.load_state_dict(rec)
    prompt = np.random.default_rng(12).integers(1, PARITY["vocab_size"], (2, 16)).astype(np.int32)
    jmodel = jllm.DecoderLM(jllm.LLMConfig(**PARITY, dtype=jnp.float32, quant="int8b"))
    want = np.asarray(jllm.greedy_generate(jmodel, jrec, jnp.asarray(prompt), 12))
    got = tllm.greedy_generate(model, prompt, 12, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
