"""The plain reference against the port's CPU path, both in float32, at
``LLMConfig.tiny()``'s widths (the dense loss) and at a width that takes
the fused loss; and the reference's NF4 copy against the port's quantizer."""

import dataclasses

import pytest
import torch

from benchmark import compare, weights as wt
from benchmark.drivers import train
from benchmark.reference import nf4, train_lm
from tiny_cell import tiny


def port_float32(cell, seed):
    """The port's trainer in float32 with the benchmark's weights."""
    from prosody_control_french_tts_tpu_torch.models import training

    cfg = dataclasses.replace(train.llm_config(cell["config"], cell["traffic"]), dtype=torch.float32)
    model, tx, state = training.init_train(cfg, seed=seed, lr=cell["config"]["stage"]["lr"], accum=cell["traffic"]["accum"],
                                           device="cpu")
    train.load_weights(model, wt.make(train.dims_of(cell["config"]), seed, "cpu", torch.float32), None)
    step = training.make_train_step(model, tx, trainable=state.mask, loss_impl="auto")
    by_id = {id(p): n for n, p in model.named_parameters()}
    return step, tx, [(by_id[id(p)], p) for p in tx.params]


def test_tiny_is_llmconfig_tiny():
    from prosody_control_french_tts_tpu_torch.models import llm

    cell = tiny(hidden=64, loss_impl="dense")
    cfg, t = train.llm_config(cell["config"], cell["traffic"]), llm.LLMConfig.tiny()
    assert (cfg.dim, cfg.layers, cfg.ffn, cfg.vocab_size) == (t.dim, t.layers, 256, t.vocab_size)


@pytest.mark.parametrize("hidden, loss_impl", [(64, "dense"), (128, "fused")])
def test_reference_follows_the_port_in_float32(hidden, loss_impl):
    cell = tiny(hidden=hidden, loss_impl=loss_impl)
    seed, t = 5, cell["traffic"]
    step, tx, leaves = port_float32(cell, seed)
    assert step.loss_impl == loss_impl
    batches = train.ring(cell, seed, "cpu")
    mask = torch.ones((t["micro_batch"], t["seq_len"]))
    mine = train.to_host(train.first_updates(step, tx, leaves, batches, mask, t["check_updates"], t["accum"]))
    dims = train.dims_of(cell["config"])
    ref = train_lm.follow(dims, train.reference_stage(cell["config"]), wt.make(dims, seed, "cpu", torch.float32), batches, mask,
                          t["check_updates"], t["accum"])
    got = compare.readings(mine, ref)
    assert got["loss"] < 1e-6 and got["grad1"] < 1e-4 and got["change"] < 1e-3, got
    # the first update's lora_a gradients are nought (every lora_b starts at zero) and are left out by the rule
    assert all(k.endswith("lora_b") for k in compare.counted(ref["grads"][0]))


def test_nf4_copy_codes_as_the_port_does():
    from prosody_control_french_tts_tpu_torch.models import quant

    w = torch.randn((256, 96), generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    packed, scale = quant.quantize_kernel_nf4(w)
    codes, s = nf4.quantize(w)
    assert torch.equal(scale, s)
    assert torch.equal(packed, codes[0::2] | (codes[1::2] << 4))
    assert torch.equal(quant.dequant_nf4(packed, scale, torch.float32), nf4.dequantize(codes, s))
