"""The port's parallel layer in one process: the tensor-parallel placements
against the JAX package's ``llm_param_spec`` leaf by leaf, ``pad_batch``, the
mesh helpers and their refusals, ``initialize`` without the environment,
the ``PCFT_DATA_MESH`` guard, ``host_local_batch_slice`` at world size 1, and
a train step on a one-rank ``gloo`` mesh against the unsharded step. The
four-rank behaviour is tests/test_torch_distributed.py's."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from prosody_control_french_tts_tpu.models import llm as jllm, quant as jquant
from prosody_control_french_tts_tpu.parallel.measure_sharded import pad_batch as jpad_batch
from prosody_control_french_tts_tpu.parallel.sharding import llm_param_spec as jspec
from prosody_control_french_tts_tpu_torch import convert
from prosody_control_french_tts_tpu_torch.models import llm, training
from prosody_control_french_tts_tpu_torch.parallel import distributed, make_mesh, mesh as pmesh, sharding
from prosody_control_french_tts_tpu_torch.parallel.measure_sharded import pad_batch

PARITY = dict(vocab_size=1024, dim=128, layers=2, heads=4, kv_heads=2, ffn=256, max_len=128, lora_rank=4)
GEOMETRIES = {"tiny": dict(vocab_size=512, dim=64, layers=2, heads=4, kv_heads=2, ffn=128, max_len=128), "parity": PARITY}


def placement_of(spec: P):
    """A JAX PartitionSpec's "model" entry as a torch placement."""
    names = list(spec)
    return Shard(names.index("model")) if "model" in names else Replicate()


@pytest.mark.parametrize("quant", [None, "int8", "int8b", "nf4"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_llm_param_spec_matches_jax(geometry, quant):
    """Every leaf of the state_dict, float and quantized (int8b: NF4
    recoded for serving), gets the placement of its JAX leaf, names mapped
    by convert.llm_params_from_jax; "data" always replicates."""
    kw = GEOMETRIES[geometry]
    jcfg = jllm.LLMConfig(**kw, dtype=jnp.float32)
    params = jllm.DecoderLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    if quant == "int8":
        params = jquant.quantize_params(params, "int8")
    elif quant in ("nf4", "int8b"):
        params = jquant.quantize_params(params, "nf4")
        if quant == "int8b":
            params = jquant.recode_params_nf4_serving(params)
    specs = jax.tree_util.tree_leaves(jspec(params), is_leaf=lambda x: isinstance(x, P))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    assert len(specs) == len(leaves)
    index_tree = jax.tree_util.tree_unflatten(treedef, [np.array(i) for i in range(len(leaves))])
    tcfg = llm.LLMConfig(**kw, dtype=torch.float32, quant=quant)
    named = {name: int(t) for name, t in convert.llm_params_from_jax(index_tree, tcfg).items()}
    got = sharding.llm_param_spec(llm.DecoderLM(tcfg, device="cpu"))
    assert sorted(got) == sorted(named)
    for name, i in named.items():
        assert got[name] == (Replicate(), placement_of(specs[i])), name
    assert sharding.llm_param_spec(llm.DecoderLM(tcfg, device="cpu").state_dict()) == got


def test_pad_batch_equals_jax():
    rng = np.random.default_rng(0)
    for shape, multiple in (((3, 5), 4), ((4, 2, 2), 2), ((5,), 8), ((2, 3), 1)):
        a = rng.standard_normal(shape).astype(np.float32)
        got, want = pad_batch(a, multiple), jpad_batch(a, multiple)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group made by make_mesh(1, 1, device="cpu"),
    destroyed afterwards."""
    assert not dist.is_initialized()
    yield make_mesh(1, 1, device="cpu")
    dist.destroy_process_group()


def test_make_mesh_refusals_and_the_one_rank_gloo_mesh(one_rank_group):
    mesh = one_rank_group
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.mesh.shape) == (1, 1)
    assert pmesh.data_sharding(mesh) == (Shard(0), Replicate())
    assert pmesh.replicated(mesh) == (Replicate(), Replicate())
    assert tuple(pmesh.local_mesh(device="cpu").mesh.shape) == (1, 1)
    assert tuple(distributed.hybrid_mesh(device="cpu").mesh.shape) == (1, 1, 1)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        make_mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match="devices per slice"):
        distributed.hybrid_mesh(model=2, device="cpu")
    with pytest.raises(ValueError, match="not divisible into 2 slices"):
        distributed.hybrid_mesh(slices=2, device="cpu")


def test_make_mesh_refuses_without_a_group_or_a_card():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(2, 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            pmesh.production_data_mesh()
    assert not dist.is_initialized()


def test_initialize_is_false_without_the_environment(monkeypatch):
    for var in ("PCFT_NUM_PROCESSES", "PCFT_COORDINATOR", "PCFT_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert distributed.initialize(num_processes=1, device="cpu") is False
    assert not dist.is_initialized()


def test_host_local_batch_slice_at_world_size_one():
    assert not dist.is_initialized()
    assert distributed.host_local_batch_slice(8) == slice(0, 8)
    assert distributed.host_local_batch_slice(1) == slice(0, 1)


def test_data_mesh_env_guard(monkeypatch):
    """tests/test_review_regressions.py's guard: a malformed value raises a
    ValueError naming the variable; unset is None on the CPU, 0 disables,
    N gives N slots on the CPU device."""
    monkeypatch.setenv("PCFT_DATA_MESH", "all")
    with pytest.raises(ValueError, match="PCFT_DATA_MESH"):
        pmesh.production_data_mesh("cpu")
    monkeypatch.delenv("PCFT_DATA_MESH")
    assert pmesh.production_data_mesh("cpu") is None
    monkeypatch.setenv("PCFT_DATA_MESH", "0")
    assert pmesh.production_data_mesh("cpu") is None
    monkeypatch.setenv("PCFT_DATA_MESH", "3")
    assert pmesh.production_data_mesh("cpu") == [torch.device("cpu")] * 3


def test_divisibility_is_refused_with_the_numbers():
    cfg = llm.LLMConfig(**PARITY)
    sharding.check_divisible(cfg, 2)
    with pytest.raises(ValueError, match=r"'model' dim of 3 does not divide .*'heads': 4"):
        sharding.check_divisible(cfg, 3)
    with pytest.raises(ValueError, match=r"'kv_heads': 2"):
        sharding.check_divisible(cfg, 4)


def test_model_partial_gradient_rule():
    """The leaves that one rank sees only a share of: the column-parallel
    adapters and biases, and lora_a of the row-parallel projections."""
    cfg = llm.LLMConfig(**PARITY, dtype=torch.float32)
    names = [n for n, _ in llm.DecoderLM(cfg, device="cpu").named_parameters()]
    partial = {n.split(".", 2)[2] for n in names if sharding.model_partial_grad(n)}
    want = {f"attn.{p}.{leaf}" for p in "qkv" for leaf in ("lora_a", "lora_b", "bias")}
    want |= {f"mlp.{p}.{leaf}" for p in ("gate", "up") for leaf in ("lora_a", "lora_b")}
    want |= {"attn.o.lora_a", "mlp.down.lora_a"}
    assert partial == want


@contextlib.contextmanager
def one_thread():
    """Two runs compared bit for bit go on one thread: on a loaded host
    MKL's products may split their work otherwise from one run to the
    next."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def one_rank_run(loss_impl: str, sharded: bool):
    cfg = llm.LLMConfig(**PARITY, dtype=torch.float32, attn_impl="vmem", fused_qkv=True)
    model, tx, state = training.init_train(cfg, lr=1e-3, device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("lora_b"):
                p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
    ids = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 128)).astype(np.int32)
    mask = np.ones((2, 128), np.float32)
    mask[1, :50] = 0
    if sharded:
        ids, mask = training.shard_train_inputs(make_mesh(1, 1, device="cpu"), model, tx, ids, mask)
        assert model.shards is not None and model.layers[0].attn.q.split == "col" and model.layers[0].mlp.down.split == "row"
    step = training.make_train_step(model, tx, trainable=state.mask, loss_impl=loss_impl)
    losses = [float(step(ids, mask)) for _ in range(3)]
    return model, losses, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("loss_impl", ["fused", "dense"])
def test_one_rank_mesh_step_equals_the_unsharded_step(one_rank_group, loss_impl, monkeypatch):
    """On a 1 x 1 mesh the sharded step calls no collective (over one rank
    each is the identity): with the fused loss its losses and leaves are
    the unsharded step's bits;
    the dense loss takes the vocabulary-parallel logsumexp (the max and the
    sum of exponentials reduced apart), whose backward rounds otherwise than
    torch.logsumexp's; Adam moves an element by about lr a step whatever its
    gradient's size, so its leaves are held within 1e-3 of lr·steps (1.7e-7
    measured, 0.06 of the bound)."""
    with one_thread():
        _, want_losses, want = one_rank_run(loss_impl, False)
        called = []
        for name in ("all_reduce", "all_gather"):
            monkeypatch.setattr(dist, name, lambda *a, _name=name, **k: called.append(_name))
        model, losses, got = one_rank_run(loss_impl, True)
    assert called == []
    if loss_impl == "fused":
        assert losses == want_losses
        assert all(torch.equal(got[k], want[k]) for k in want)
    else:
        assert max(abs(a - b) / b for a, b in zip(losses, want_losses)) <= 1e-6
        assert max(float((got[k] - want[k]).abs().max()) for k in want) <= 1e-3 * 1e-3 * 3
    with pytest.raises(ValueError, match="serving"):
        llm.greedy_generate(model, np.ones((1, 4), np.int32), 2, device="cpu")
    with pytest.raises(ValueError, match="serving"):
        llm.fuse_decode_params(model, model.cfg)
    with pytest.raises(ValueError, match="sharded already"):
        sharding.shard_params(model, model.shards.mesh)


def test_sharded_model_refuses_a_mesh_it_was_not_sharded_on(one_rank_group):
    cfg = dataclasses.replace(llm.LLMConfig.tiny(), dtype=torch.float32)
    model, tx, _ = training.init_train(cfg, device="cpu")
    ids = np.ones((2, 8), np.int32)
    training.shard_train_inputs(one_rank_group, model, tx, ids, ids)
    got_ids, _ = training.shard_train_inputs(one_rank_group, model, tx, ids, ids)
    assert got_ids.shape == (2, 8)
    with pytest.raises(ValueError, match="another mesh"):
        training.shard_train_inputs(make_mesh(1, 1, device="cpu"), model, tx, ids, ids)


def test_chip_smoke_phase_24_rehearses_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 24 end to end at a small size on the CPU (a
    one-rank gloo group, the kernels' plain versions): measure_sharded equal
    to run_measure_device, the sharded step bit-equal to the unsharded one
    from the same adapters and optimizer state, the group destroyed."""
    import chip_smoke

    from prosody_control_french_tts_tpu_torch.prosody.adjust import ProsodySettings
    from prosody_control_french_tts_tpu_torch.prosody.measure import prepare_voice
    from prosody_control_french_tts_tpu_torch.utils.synth import synth_voice

    assert not dist.is_initialized()
    prep = prepare_voice(*synth_voice(tmp_path / "v", seed=0, n_segments=2, seconds=(1.0, 1.5)), ProsodySettings())
    cfg = llm.LLMConfig(**PARITY, dtype=torch.float32, attn_impl="vmem", fused_qkv=True)
    model, tx, state = training.init_train(cfg, lr=1e-3, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 128)).astype(np.int32))
    mask = torch.ones((2, 128))
    training.make_train_step(model, tx, trainable=state.mask)(ids, mask)  # the optimizer has moments
    try:
        with one_thread():
            out = chip_smoke.parallel_phase("cpu", prep, (model, tx, state, ids, mask), device="cpu")
        assert not dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert out["bit_equal"] and model.shards is not None
