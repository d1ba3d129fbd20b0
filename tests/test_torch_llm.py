"""The PyTorch port's LLM serving slice against the JAX package: quantizers,
LoRA projection, the decoder LM in both layouts, greedy decoding, the
tokenizer, the cascade's host half and the evaluation metrics.

Weights and inputs are made with numpy / the JAX initialisers once, carried
to the port as numpy arrays by ``convert.py``, and both sides run on the CPU
in float32 unless a test says otherwise. Each comparison states its
tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prosody_control_french_tts_tpu.models import cascade as jcascade, llm as jllm, llm_eval as jeval, quant as jquant
from prosody_control_french_tts_tpu.models.lora import LoRADense, lora_param_mask as j_lora_mask, merge_lora as j_merge
from prosody_control_french_tts_tpu.models.tokenizer import WordPieceTokenizer as JTokenizer
from prosody_control_french_tts_tpu_torch import convert
from prosody_control_french_tts_tpu_torch.models import cascade as tcascade, llm as tllm, llm_eval as teval, quant as tquant
from prosody_control_french_tts_tpu_torch.models.lora import LoRALinear, lora_param_mask, merge_lora
from prosody_control_french_tts_tpu_torch.models.tokenizer import WordPieceTokenizer as TTokenizer
from tests.test_torch_kernels import quant_edge_kernel

SENTENCES = [
    "Le portrait du compositeur est accroché au mur du salon.",
    "Elle marche lentement, puis elle s'arrête devant la porte.",
    "Bonjour, comment allez-vous aujourd'hui ?",
    "Le train de nuit arrive à Paris vers six heures du matin.",
    "Nous avons mangé du pain, du fromage et des pommes.",
    "Il pleut depuis ce matin, mais le soleil reviendra demain.",
]


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def perturb_lora_b(params, seed=7):
    """lora_b is zero at init; give it values so the adapters do work."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        if any(getattr(k, "key", None) == "lora_b" for k in path):
            return jnp.asarray(rng.normal(0.0, 0.05, x.shape).astype(np.float32))
        return x

    return jax.tree_util.tree_map_with_path(f, params)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kernel():
    return np.random.default_rng(0).normal(0.0, 0.1, (128, 48)).astype(np.float32)


QUANTIZERS = ["quantize_kernel_int8", "quantize_kernel_int8_block", "quantize_kernel_nf4", "recode_nf4_to_int8_block"]


def quantizer_input(name, inputs, kernel):
    """The arguments of ``name`` for JAX's function: the fixture's kernel, or
    tests/test_torch_kernels.py's edge kernel (odd out, NF4 midpoints, zero
    blocks, ±max); the recoder takes JAX's NF4 quantization of it."""
    w = kernel if inputs == "seeded" else quant_edge_kernel()
    return jquant.quantize_kernel_nf4(w) if name == "recode_nf4_to_int8_block" else (w,)


# the numpy cases keep their ids; the torch cases run the tensor path on CPU
# tensors, once with column chunks of a few columns
QUANT_CASES = [pytest.param(n, "numpy", "seeded", id=n) for n in QUANTIZERS[:3]] + [
    pytest.param(n, kind, inputs, id=f"{n}-{kind}-{inputs}")
    for n in QUANTIZERS
    for kind, inputs in (("numpy", "edges"), ("torch", "seeded"), ("torch", "edges"), ("torch-chunked", "edges"))
    if (n, kind) != ("recode_nf4_to_int8_block", "numpy") or inputs == "edges"
]


@pytest.mark.parametrize("name,kind,inputs", QUANT_CASES)
def test_quantizers_equal_jax_bit_for_bit(kernel, name, kind, inputs, monkeypatch):
    """Codes and scales byte-equal to the JAX package's, from numpy arrays
    (the host path) and from torch tensors (the path a card takes: the
    division by a tensor, the first of equal distances, rint half to even)."""
    args = quantizer_input(name, inputs, kernel)
    want = getattr(jquant, name)(*args)
    if kind == "numpy":
        got = getattr(tquant, name)(*args)
    else:
        if kind == "torch-chunked":
            monkeypatch.setattr(tquant, "QUANT_CHUNK_BYTES", 1 << 12)  # a few columns a chunk, a short last one
        got = getattr(tquant, name)(*map(torch.from_numpy, args))
        assert all(isinstance(g, torch.Tensor) for g in got)
        got = [g.numpy() for g in got]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_params_nf4_and_recode_equal_jax(dtype):
    """``quantize_params(..., "nf4")`` and ``recode_params_nf4_serving`` over a
    whole tree of CPU tensors (the torch path), byte-equal to the JAX
    package's on the JAX initialiser's tree: float32, and the same tree
    rounded to bfloat16 (a frozen base as ``init_train(frozen_dtype=...)``
    leaves it) against JAX on the rounded values in float32."""
    cfg = jllm.LLMConfig(vocab_size=512, dim=128, layers=2, heads=4, kv_heads=2, ffn=192, max_len=64, dtype=jnp.float32)
    jparams = jllm.DecoderLM(cfg).init(jax.random.PRNGKey(2), jnp.zeros((1, 8), jnp.int32))
    if dtype == torch.bfloat16:
        jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16).astype(jnp.float32), jparams)
    tcfg = tllm.LLMConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}, dtype=torch.float32)
    tree = {k: v.to(dtype) for k, v in convert.llm_params_from_jax(to_numpy(jparams), tcfg).items()}
    jq = jquant.quantize_params(jparams, "nf4")
    for got_tree, want_tree, quant in (
        (tquant.quantize_params(tree, "nf4"), jq, "nf4"),
        (tquant.recode_params_nf4_serving(tquant.quantize_params(tree, "nf4")), jquant.recode_params_nf4_serving(jq), "int8b"),
    ):
        want = convert.llm_params_from_jax(to_numpy(want_tree), dataclasses.replace(tcfg, quant=quant))
        assert sorted(got_tree) == sorted(want)
        for name, w in want.items():
            g = got_tree[name].to(w.dtype) if name.rsplit(".", 1)[-1] not in ("kernel_q", "kernel_scale") else got_tree[name]
            assert g.dtype == w.dtype and torch.equal(g, w), name


def test_nf4_tables_equal():
    np.testing.assert_array_equal(tquant.NF4_TABLE, jquant.NF4_TABLE)
    np.testing.assert_array_equal(tquant.NF4_INT8_TABLE, jquant.NF4_INT8_TABLE)
    assert tquant.NF4_BLOCK == jquant.NF4_BLOCK


@pytest.mark.parametrize("mode", ["int8", "int8_block", "nf4"])
def test_dequantizers_match_jax(kernel, mode):
    """Within 1e-6: the same float32 multiply per weight."""
    q, s = getattr(jquant, f"quantize_kernel_{mode}")(kernel)
    want = np.asarray(getattr(jquant, f"dequant_{mode}")(jnp.asarray(q), jnp.asarray(s), jnp.float32))
    got = getattr(tquant, f"dequant_{mode}")(torch.from_numpy(q), torch.from_numpy(s), torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_nf4_dequant_copies_its_table_to_a_device_once(kernel, monkeypatch):
    """``dequant_nf4`` runs in every quantized forward and backward: after
    its first call on a device it takes the NF4 table from there, with no
    copy from host memory (which waits for the card on CUDA)."""
    packed, scale = tquant.quantize_kernel_nf4(torch.from_numpy(kernel))
    first = tquant.dequant_nf4(packed, scale, torch.float32)
    copies, from_numpy = [], torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy", lambda a: copies.append(a.shape) or from_numpy(a))
    again = tquant.dequant_nf4(packed, scale, torch.float32)
    assert copies == [] and torch.equal(again, first)


def test_recode_nf4_to_int8_block_equals_jax(kernel):
    packed, scale = jquant.quantize_kernel_nf4(kernel)
    for g, w in zip(tquant.recode_nf4_to_int8_block(packed, scale), jquant.recode_nf4_to_int8_block(packed, scale)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("rows,branch", [(6, "partial"), (300, "dense")])
def test_matmul_int8_block_matches_jax(kernel, rows, branch):
    """Both branches (block partial sums up to 256 rows, dense dequant
    above) within 1e-4 of the JAX function at float32."""
    q, s = jquant.quantize_kernel_int8_block(kernel)
    x = np.random.default_rng(1).normal(size=(rows, 128)).astype(np.float32)
    want = np.asarray(jquant.matmul_int8_block(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.float32))
    got = tquant.matmul_int8_block(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s), torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert (rows <= 256) == (branch == "partial")


def test_matmul_int8_block_bf16_partials_are_float32():
    """In bfloat16 the partial path must not round the per-block sums: it
    stays within bfloat16 rounding of the float32 product of the dequantized
    kernel, and matches the JAX function (which accumulates in float32)."""
    w = np.random.default_rng(2).normal(0.0, 0.1, (256, 32)).astype(np.float32)
    q, s = jquant.quantize_kernel_int8_block(w)
    x = np.random.default_rng(3).normal(size=(4, 256)).astype(np.float32)
    want = np.asarray(
        jquant.matmul_int8_block(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q), jnp.asarray(s), jnp.bfloat16), np.float32
    )
    got = tquant.matmul_int8_block(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(q), torch.from_numpy(s), torch.bfloat16
    ).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)  # one bfloat16 rounding of the result


# ---------------------------------------------------------------------------
# LoRA projection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", [None, "int8", "int8b", "nf4"])
def test_lora_linear_matches_lora_dense(quant):
    """float32, within 1e-5, for every base-kernel storage."""
    rng = np.random.default_rng(4)
    in_f, out_f, rank = 128, 40, 4
    mod = LoRADense(out_f, rank, 16.0, use_bias=True, dtype=jnp.float32, quant=quant)
    x = rng.normal(size=(3, 5, in_f)).astype(np.float32)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = dict(params)
    w = rng.normal(0.0, 0.1, (in_f, out_f)).astype(np.float32)
    if quant == "int8":
        params["kernel_q"], params["kernel_scale"] = map(jnp.asarray, jquant.quantize_kernel_int8(w))
    elif quant == "int8b":
        params["kernel_q"], params["kernel_scale"] = map(jnp.asarray, jquant.quantize_kernel_int8_block(w))
    elif quant == "nf4":
        params["kernel_q"], params["kernel_scale"] = map(jnp.asarray, jquant.quantize_kernel_nf4(w))
    params["bias"] = jnp.asarray(rng.normal(size=(out_f,)).astype(np.float32))
    params["lora_b"] = jnp.asarray(rng.normal(0.0, 0.1, (rank, out_f)).astype(np.float32))
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))

    lin = LoRALinear(in_f, out_f, rank, 16.0, use_bias=True, dtype=torch.float32, quant=quant, device="cpu")
    assert sorted(lin.state_dict()) == sorted(params)
    lin.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    got = lin(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lora_linear_init_statistics():
    """Fresh weights: truncated-normal kernel of variance 1/fan_in inside
    ±2σ', N(0, 1/r) lora_a, zero lora_b and bias."""
    lin = LoRALinear(512, 256, 8, use_bias=True, device="cpu", generator=torch.Generator().manual_seed(0))
    k = lin.kernel.detach()
    assert abs(float(k.std()) - (1 / 512) ** 0.5) < 2e-3
    assert float(k.abs().max()) <= 2 * (1 / 512) ** 0.5 / 0.87962566 + 1e-6
    assert abs(float(lin.lora_a.detach().std()) - 1 / 8) < 1e-2
    assert not lin.lora_b.any() and not lin.bias.any()


# ---------------------------------------------------------------------------
# the decoder LM, both layouts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """A tiny float32 model on both sides with the same weights."""
    jcfg = dataclasses.replace(jllm.LLMConfig.tiny(), dtype=jnp.float32)
    jmodel = jllm.DecoderLM(jcfg)
    ids = np.random.default_rng(0).integers(1, jcfg.vocab_size, size=(3, 8)).astype(np.int32)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids[:, :1]), positions=jnp.zeros((3, 1), jnp.int32))
    jparams = perturb_lora_b(jparams)
    tcfg = dataclasses.replace(tllm.LLMConfig.tiny(), dtype=torch.float32)
    tmodel = tllm.DecoderLM(tcfg, device="cpu")
    state = convert.llm_params_from_jax(to_numpy(jparams), tcfg)
    assert sorted(state) == sorted(tmodel.state_dict())
    tmodel.load_state_dict(state)
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, tcfg=tcfg, tmodel=tmodel, ids=ids)


def test_config_presets_equal():
    for preset in ("tiny", "qwen25_7b"):
        j = dataclasses.asdict(getattr(jllm.LLMConfig, preset)())
        t = dataclasses.asdict(getattr(tllm.LLMConfig, preset)())
        j.pop("dtype"), t.pop("dtype")
        assert j == t
    assert tllm.LLMConfig.qwen25_7b().head_dim == 128


@pytest.mark.parametrize("field,value", [("attn_impl", "vmem"), ("attn_impl", "flash"), ("fused_qkv", True), ("remat", True), ("remat_policy", "dots")])
def test_config_refuses_training_knobs(field, value):
    """Every training knob of the JAX config is ported and constructs with its
    value kept, the upstream flash op's counterpart included; values that no
    side knows are refused."""
    assert getattr(tllm.LLMConfig(**{field: value}), field) == value
    with pytest.raises(ValueError):
        tllm.LLMConfig(attn_impl="sdpa")
    with pytest.raises(ValueError):
        tllm.LLMConfig(remat_policy="everything")


def test_rope_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 120, size=(2, 6))
    want = np.asarray(jllm.rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    got = tllm.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_logits_without_caches_match_jax(tiny):
    """Training-shape forward (causal mask, with and without a key mask),
    float32, within 1e-5."""
    ids = tiny["ids"]
    want = np.asarray(tiny["jmodel"].apply(tiny["jparams"], jnp.asarray(ids)))
    got = tiny["tmodel"](torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    keep = np.ones(ids.shape, bool)
    keep[:, -2:] = False
    want = np.asarray(tiny["jmodel"].apply(tiny["jparams"], jnp.asarray(ids), attn_mask=jnp.asarray(keep)))
    got = tiny["tmodel"](torch.from_numpy(ids), attn_mask=torch.from_numpy(keep)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_logits_with_caches_match_jax(tiny):
    """Prefill then one decode step through the KV caches, float32, 1e-5;
    the caches hold the same rows."""
    ids = tiny["ids"]
    B, P = ids.shape
    jc = jllm.init_kv_caches(tiny["jcfg"], B, 16)
    tc = tllm.init_kv_caches(tiny["tcfg"], B, 16, device="cpu")
    pos = np.broadcast_to(np.arange(P), (B, P))
    want, jc = tiny["jmodel"].apply(tiny["jparams"], jnp.asarray(ids), positions=jnp.asarray(pos), kv_caches=jc, cache_pos=0)
    got, tc = tiny["tmodel"](torch.from_numpy(ids), positions=torch.from_numpy(pos.copy()), kv_caches=tc, cache_pos=0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    nxt = np.asarray(want)[:, -1].argmax(-1).astype(np.int32)[:, None]
    step = np.full((B, 1), P)
    want, jc = tiny["jmodel"].apply(tiny["jparams"], jnp.asarray(nxt), positions=jnp.asarray(step), kv_caches=jc, cache_pos=P)
    got, tc = tiny["tmodel"](torch.from_numpy(nxt), positions=torch.from_numpy(step), kv_caches=tc, cache_pos=P)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc[1][0].detach().numpy(), np.asarray(jc[1][0]), rtol=1e-5, atol=1e-5)


def test_return_hidden_matches_jax(tiny):
    ids = tiny["ids"]
    want = np.asarray(tiny["jmodel"].apply(tiny["jparams"], jnp.asarray(ids), return_hidden=True))
    got = tiny["tmodel"](torch.from_numpy(ids), return_hidden=True).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_causal_lm_loss_matches_jax(tiny):
    ids = tiny["ids"]
    logits = np.asarray(tiny["jmodel"].apply(tiny["jparams"], jnp.asarray(ids)))
    mask = np.zeros(ids.shape, np.float32)
    mask[:, 3:] = 1.0
    want = float(jllm.causal_lm_loss(jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(mask)))
    got = float(tllm.causal_lm_loss(torch.from_numpy(logits.copy()), torch.from_numpy(ids), torch.from_numpy(mask)))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_cache_write_past_the_end_raises(tiny):
    """Where the JAX update clamps its start, the port raises."""
    ids = torch.from_numpy(tiny["ids"])
    caches = tllm.init_kv_caches(tiny["tcfg"], 3, 8, device="cpu")
    with pytest.raises(ValueError, match="runs past"):
        tiny["tmodel"](ids, kv_caches=caches, cache_pos=1)


@pytest.fixture(scope="module")
def greedy_ref(tiny):
    """JAX greedy tokens without an eos, and an eos id that this run emits
    late enough for the early stop and the zero tail to show."""
    ref = np.asarray(jllm.greedy_generate(tiny["jmodel"], tiny["jparams"], jnp.asarray(tiny["ids"]), max_new=12))
    P = tiny["ids"].shape[1]
    gen = ref[:, P + 1 :]  # the prefill token is never tested against eos
    # the step at which each candidate id has appeared in every row
    best = None
    for tok in np.unique(gen):
        first = [np.flatnonzero(row == tok) for row in gen]
        if all(len(f) for f in first):
            stop = max(int(f[0]) for f in first)
            if stop < gen.shape[1] - 2 and (best is None or stop < best[1]):
                best = (int(tok), stop)
    return ref, best


def test_greedy_generate_tokens_equal_jax(tiny, greedy_ref):
    ref, _ = greedy_ref
    got = tllm.greedy_generate(tiny["tmodel"], tiny["ids"], max_new=12, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), ref)


def test_greedy_generate_with_eos_equal_jax(tiny, greedy_ref):
    """With an eos id: finished rows keep writing it, the loop stops when
    all rows are done, and the tail stays 0 — as the JAX loop leaves it."""
    ref, best = greedy_ref
    P = tiny["ids"].shape[1]
    eos = best[0] if best is not None else int(ref[0, P + 2])
    want = np.asarray(jllm.greedy_generate(tiny["jmodel"], tiny["jparams"], jnp.asarray(tiny["ids"]), max_new=12, eos_id=eos))
    got = tllm.greedy_generate(tiny["tmodel"], tiny["ids"], max_new=12, eos_id=eos, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert (want[0] == eos).any()
    fp = tllm.fuse_decode_params(tiny["tmodel"], tiny["tcfg"], dtype=torch.float32)
    fused = tllm.greedy_generate_fused(fp, tiny["tcfg"], tiny["ids"], max_new=12, eos_id=eos, device="cpu").numpy()
    np.testing.assert_array_equal(fused, want)


def test_greedy_early_stop_leaves_a_zero_tail(tiny):
    """One row, eos = its second generated token: the loop stops there and
    every later position is 0 on both sides."""
    ids = tiny["ids"][:1]
    P = ids.shape[1]
    free = np.asarray(jllm.greedy_generate(tiny["jmodel"], tiny["jparams"], jnp.asarray(ids), max_new=10))
    eos = int(free[0, P + 1])
    want = np.asarray(jllm.greedy_generate(tiny["jmodel"], tiny["jparams"], jnp.asarray(ids), max_new=10, eos_id=eos))
    got = tllm.greedy_generate(tiny["tmodel"], ids, max_new=10, eos_id=eos, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, P + 2 :] == 0).all() and got[0, P + 1] == eos


def test_fused_tree_equals_jax(tiny):
    """fuse_decode_params of the carried tree against the JAX fused tree
    (LoRA folded, lora_b non-zero), float32 within 1e-6 and bfloat16 equal
    up to one rounding of the fold's last bit."""
    want = to_numpy(jllm.fuse_decode_params(tiny["jparams"], tiny["jcfg"], dtype=jnp.float32))
    got = tllm.fuse_decode_params(tiny["tmodel"], tiny["tcfg"], dtype=torch.float32)
    assert sorted(got) == sorted(want) and len(got["layers"]) == len(want["layers"])
    for name in ("embed", "ln_f", "lm_head"):
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=0, atol=1e-6)
    for gl, wl in zip(got["layers"], want["layers"]):
        assert sorted(gl) == sorted(wl)
        for name in wl:
            assert gl[name].shape == wl[name].shape
            np.testing.assert_allclose(gl[name].numpy(), wl[name], rtol=0, atol=1e-6)
    bf = tllm.fuse_decode_params(tiny["tmodel"].state_dict(), tiny["tcfg"])
    assert bf["layers"][0]["wqkv"].dtype == torch.bfloat16 and bf["embed"].dtype == torch.bfloat16
    hd = tiny["tcfg"].head_dim
    assert bf["layers"][0]["wqkv"].shape == (tiny["tcfg"].dim, (tiny["tcfg"].heads + 2 * tiny["tcfg"].kv_heads) * hd)
    assert bf["layers"][0]["wgu"].shape == (tiny["tcfg"].dim, 2 * tiny["tcfg"].ffn)


def test_fused_forward_logits_match_jax(tiny):
    """_fused_forward: prefill (masked einsum path) and a decode step
    (kernel F's plain version) within 1e-5 of the JAX fused forward; and
    within 1e-5 of the training layout, as the JAX package's own test asks."""
    ids = tiny["ids"]
    B, P = ids.shape
    jfp = jllm.fuse_decode_params(tiny["jparams"], tiny["jcfg"], dtype=jnp.float32)
    tfp = convert.fused_params_from_jax(to_numpy(jfp))
    pos = np.broadcast_to(np.arange(P), (B, P)).copy()
    jc = [(k.astype(jnp.float32), v.astype(jnp.float32)) for k, v in jllm.init_kv_caches_fused(tiny["jcfg"], B, 16)]
    tc = tllm.init_kv_caches_fused(tiny["tcfg"], B, 16, device="cpu")
    want, jc = jllm._fused_forward(jfp, tiny["jcfg"], jnp.asarray(ids), jnp.asarray(pos), jc, 0)
    got, tc = tllm._fused_forward(tfp, tiny["tcfg"], torch.from_numpy(ids), torch.from_numpy(pos), tc, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    train = tiny["tmodel"](torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got.numpy(), train, rtol=1e-5, atol=1e-5)
    last, _ = tllm._fused_forward(
        tfp, tiny["tcfg"], torch.from_numpy(ids), torch.from_numpy(pos), tllm.init_kv_caches_fused(tiny["tcfg"], B, 16, device="cpu"), 0, last_only=True
    )
    assert last.shape == (B, 1, tiny["tcfg"].vocab_size)
    np.testing.assert_allclose(last.numpy()[:, 0], got.numpy()[:, -1], rtol=1e-6, atol=1e-6)
    nxt = np.asarray(want)[:, -1].argmax(-1).astype(np.int32)[:, None]
    step = np.full((B, 1), P)
    want, _ = jllm._fused_forward(jfp, tiny["jcfg"], jnp.asarray(nxt), jnp.asarray(step), jc, P)
    got, _ = tllm._fused_forward(tfp, tiny["tcfg"], torch.from_numpy(nxt), torch.from_numpy(step), tc, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_greedy_generate_fused_tokens_equal_jax_and_training_layout(tiny, greedy_ref):
    ref, _ = greedy_ref
    jfp = jllm.fuse_decode_params(tiny["jparams"], tiny["jcfg"], dtype=jnp.float32)
    want = np.asarray(jllm.greedy_generate_fused(jfp, tiny["jcfg"], jnp.asarray(tiny["ids"]), max_new=12))
    fp = tllm.fuse_decode_params(tiny["tmodel"], tiny["tcfg"], dtype=torch.float32)
    got = tllm.greedy_generate_fused(fp, tiny["tcfg"], tiny["ids"], max_new=12, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", ["int8b", "int8"])
def test_quantized_fused_tree_equals_jax_and_decodes_like_its_dequantized_tree(tiny, mode):
    """quantize_fused_decode_params: codes and scales equal the JAX ones bit
    for bit; the quantized tree's greedy tokens equal those of the same tree
    dequantized (the JAX package's own contract) and JAX's tokens."""
    jfp = jllm.fuse_decode_params(tiny["jparams"], tiny["jcfg"], dtype=jnp.float32)
    jfq = jllm.quantize_fused_decode_params(jfp, block=32, mode=mode)
    fp = convert.fused_params_from_jax(to_numpy(jfp))
    fq = tllm.quantize_fused_decode_params(fp, block=32, mode=mode)
    for name in ("wqkv", "wo", "wgu", "wdown"):
        for leaf in ("codes", "scale"):
            np.testing.assert_array_equal(fq["layers"][1][name][leaf].numpy(), np.asarray(jfq["layers"][1][name][leaf]))
    assert fq["lm_head"]["codes"].dtype == torch.int8

    def deq(w):
        if not isinstance(w, dict):
            return w
        if mode == "int8":
            return tquant.dequant_int8(w["codes"], w["scale"], torch.float32)
        return tquant.dequant_int8_block(w["codes"], w["scale"], torch.float32, 32)

    fdq = {**fq, "lm_head": deq(fq["lm_head"]), "layers": [{k: deq(v) for k, v in lw.items()} for lw in fq["layers"]]}
    got = tllm.greedy_generate_fused(fq, tiny["tcfg"], tiny["ids"], max_new=10, device="cpu").numpy()
    ref = tllm.greedy_generate_fused(fdq, tiny["tcfg"], tiny["ids"], max_new=10, device="cpu").numpy()
    np.testing.assert_array_equal(got, ref)
    want = np.asarray(jllm.greedy_generate_fused(jfq, tiny["jcfg"], jnp.asarray(tiny["ids"]), max_new=10))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_quantized_training_tree(tiny, mode):
    """quantize_params equals the JAX tree leaf for leaf; the quantized model
    gives the logits of the float model on the dequantized tree (1e-5) and of
    the JAX quantized model (1e-5); fuse_decode_params refuses it."""
    state = tiny["tmodel"].state_dict()
    qstate = tquant.quantize_params(state, mode)
    jq = jquant.quantize_params(tiny["jparams"], mode)
    carried = convert.llm_params_from_jax(to_numpy(jq), tiny["tcfg"])
    assert sorted(carried) == sorted(qstate)
    for k in carried:
        np.testing.assert_array_equal(qstate[k].numpy(), carried[k].numpy())
    qcfg = dataclasses.replace(tiny["tcfg"], quant=mode)
    qmodel = tllm.DecoderLM(qcfg, device="cpu")
    qmodel.load_state_dict(qstate)
    ids = torch.from_numpy(tiny["ids"])
    got = qmodel(ids).detach().numpy()
    fmodel = tllm.DecoderLM(tiny["tcfg"], device="cpu")
    fmodel.load_state_dict(tquant.dequantize_params(qstate))
    np.testing.assert_allclose(got, fmodel(ids).detach().numpy(), rtol=1e-5, atol=1e-5)
    jqmodel = jllm.DecoderLM(dataclasses.replace(tiny["jcfg"], quant=mode))
    np.testing.assert_allclose(got, np.asarray(jqmodel.apply(jq, jnp.asarray(tiny["ids"]))), rtol=1e-5, atol=1e-5)
    assert tquant.quantized_bytes(qstate) < tquant.quantized_bytes(state)
    with pytest.raises(ValueError, match="quantized"):
        tllm.fuse_decode_params(qmodel, qcfg)


def test_nf4_tree_recoded_for_serving(tiny):
    """recode_params_nf4_serving: the int8b tree equals the JAX recode and
    runs under quant="int8b" within 1e-5 of the JAX int8b model."""
    jq = jquant.quantize_params(tiny["jparams"], "nf4")
    jr = jquant.recode_params_nf4_serving(jq)
    qstate = tquant.quantize_params(tiny["tmodel"].state_dict(), "nf4")
    rstate = tquant.recode_params_nf4_serving(qstate)
    carried = convert.llm_params_from_jax(to_numpy(jr), tiny["tcfg"])
    for k in carried:
        np.testing.assert_array_equal(rstate[k].numpy(), carried[k].numpy())
    model = tllm.DecoderLM(dataclasses.replace(tiny["tcfg"], quant="int8b"), device="cpu")
    model.load_state_dict(rstate)
    jmodel = jllm.DecoderLM(dataclasses.replace(tiny["jcfg"], quant="int8b"))
    want = np.asarray(jmodel.apply(jr, jnp.asarray(tiny["ids"])))
    np.testing.assert_allclose(model(torch.from_numpy(tiny["ids"])).detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_merge_lora_and_mask_match_jax(tiny):
    state = tiny["tmodel"].state_dict()
    merged = merge_lora(state)
    want = convert.llm_params_from_jax(to_numpy(j_merge(tiny["jparams"])), tiny["tcfg"])
    for k in want:
        np.testing.assert_allclose(merged[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6)
    jmask = convert._flatten(to_numpy(j_lora_mask(tiny["jparams"]))["params"])
    mask = lora_param_mask(state)
    assert sum(mask.values()) == sum(bool(v) for v in jmask.values()) > 0
    assert all(k.endswith(("lora_a", "lora_b")) for k, v in mask.items() if v)


def test_convert_refuses_unknown_leaves(tiny):
    tree = to_numpy(tiny["jparams"])
    bad = {"params": {**tree["params"], "extra": {"kernel": np.zeros(2, np.float32)}}}
    with pytest.raises(ValueError, match="unknown leaf"):
        convert.llm_params_from_jax(bad, tiny["tcfg"])
    deep = {"params": {**tree["params"], "layer_9": tree["params"]["layer_0"]}}
    with pytest.raises(ValueError, match="beyond"):
        convert.llm_params_from_jax(deep, tiny["tcfg"])
    jfp = to_numpy(jllm.fuse_decode_params(tiny["jparams"], tiny["jcfg"], dtype=jnp.float32))
    with pytest.raises(ValueError, match="unknown leaf"):
        convert.fused_params_from_jax({**jfp, "rope": np.zeros(2)})
    with pytest.raises(ValueError, match="unknown leaf"):
        convert.fused_params_from_jax({**jfp, "layers": [{**jfp["layers"][0], "wq": np.zeros(2)}]})


def test_convert_carries_bfloat16_leaves(tiny):
    jfp = to_numpy(jllm.fuse_decode_params(tiny["jparams"], tiny["jcfg"]))
    fp = convert.fused_params_from_jax(jfp)
    assert fp["layers"][0]["wo"].dtype == torch.bfloat16
    np.testing.assert_array_equal(fp["layers"][0]["wo"].float().numpy(), jfp["layers"][0]["wo"].astype(np.float32))


def test_bf16_fused_decode_step_close_to_jax(tiny):
    """The serving dtype: one bfloat16 prefill through both fused forwards
    on the same bfloat16 tree; logits within 5 % of their range (bfloat16
    rounds at other places in the two frameworks)."""
    ids = tiny["ids"]
    B, P = ids.shape
    jfp = jllm.fuse_decode_params(tiny["jparams"], tiny["jcfg"])
    tfp = convert.fused_params_from_jax(to_numpy(jfp))
    pos = np.broadcast_to(np.arange(P), (B, P)).copy()
    jcfg = dataclasses.replace(tiny["jcfg"], dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tiny["tcfg"], dtype=torch.bfloat16)
    want, _ = jllm._fused_forward(jfp, jcfg, jnp.asarray(ids), jnp.asarray(pos), jllm.init_kv_caches_fused(jcfg, B, 16), 0)
    got, _ = tllm._fused_forward(tfp, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), tllm.init_kv_caches_fused(tcfg, B, 16, device="cpu"), 0)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 0.05


# ---------------------------------------------------------------------------
# tokenizer, cascade, evaluation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tokenizers():
    texts = SENTENCES + [jcascade.format_example(jcascade.TASK_A, s, s + " <break/>") for s in SENTENCES]
    return JTokenizer.train(texts, vocab_size=300, min_freq=1), TTokenizer.train(texts, vocab_size=300, min_freq=1)


def test_tokenizer_equals_jax(tokenizers, tmp_path):
    jt, tt = tokenizers
    assert jt.vocab == tt.vocab
    for s in SENTENCES + ["mot inconnu xyzzyq <break/> ### !"]:
        ids = tt.encode(s)
        assert ids == jt.encode(s)
        assert tt.decode(ids) == jt.decode(ids)
        assert tt.pieces_with_boundaries(ids) == jt.pieces_with_boundaries(ids)
        assert tt.encode_words(s.split()) == jt.encode_words(s.split())
    tt.save(tmp_path / "vocab.json")
    assert TTokenizer.load(tmp_path / "vocab.json").vocab == jt.vocab
    assert (tt.pad_id, tt.unk_id, tt.cls_id, tt.sep_id, len(tt)) == (jt.pad_id, jt.unk_id, jt.cls_id, jt.sep_id, len(jt))


def test_cascade_host_half_equals_jax(tokenizers):
    jt, tt = tokenizers
    assert (tcascade.TASK_A, tcascade.TASK_B) == (jcascade.TASK_A, jcascade.TASK_B)
    assert tcascade.format_example(tcascade.TASK_A, "a b", None) == jcascade.format_example(jcascade.TASK_A, "a b", None)
    assert tcascade.format_example(tcascade.TASK_B, "a b", "c") == jcascade.format_example(jcascade.TASK_B, "a b", "c")
    pairs = [{"x": s, "y": s.replace(",", " <break/>")} for s in SENTENCES]
    for max_len in (24, 64):
        want = jcascade.build_batches(pairs, jt, jcascade.TASK_A, max_len)
        got = tcascade.build_batches(pairs, tt, tcascade.TASK_A, max_len)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.loss_mask, want.loss_mask)


@pytest.fixture(scope="module")
def cascade_models(tokenizers):
    """Two tiny float32 stage models on both sides, same weights."""
    jt, _ = tokenizers
    jcfg = dataclasses.replace(jllm.LLMConfig.tiny(len(jt)), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllm.LLMConfig.tiny(len(jt)), dtype=torch.float32)
    jmodel = jllm.DecoderLM(jcfg)
    out = []
    for seed in (1, 2):
        jparams = perturb_lora_b(jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32)), seed)
        tmodel = tllm.DecoderLM(tcfg, device="cpu")
        tmodel.load_state_dict(convert.llm_params_from_jax(to_numpy(jparams), tcfg))
        out.append((jparams, tmodel))
    return jmodel, out


def test_cascade_generate_and_run_equal_jax(tokenizers, cascade_models):
    """generate (one stage, max_new 12) and run_cascade (two stages at the
    default 128 new tokens would recompile the JAX loop for minutes, so the
    stages are chained by hand at max_new 12): equal strings."""
    jt, tt = tokenizers
    jmodel, ((pa, ta), (pb, tb)) = cascade_models
    text = SENTENCES[0]
    want_a = jcascade.generate(jmodel, pa, jt, jcascade.TASK_A, text, max_new=12)
    got_a = tcascade.generate(ta, tt, tcascade.TASK_A, text, max_new=12, device="cpu")
    assert isinstance(got_a, str) and got_a == want_a
    want_b = jcascade.generate(jmodel, pb, jt, jcascade.TASK_B, want_a, max_new=12)
    assert tcascade.generate(tb, tt, tcascade.TASK_B, got_a, max_new=12, device="cpu") == want_b


def test_run_cascade_chains_both_stages(tokenizers, cascade_models, monkeypatch):
    """run_cascade feeds stage A's text to stage B with the two task
    strings, on the device asked for."""
    _, tt = tokenizers
    _, ((_, ta), (_, tb)) = cascade_models
    calls = []

    def fake(model, tokenizer, task, x, max_new=128, device="cuda"):
        calls.append((model, task, x, device))
        return x + " +"

    monkeypatch.setattr(tcascade, "generate", fake)
    assert tcascade.run_cascade(ta, tb, tt, "texte", device="cpu") == "texte + +"
    assert calls == [(ta, tcascade.TASK_A, "texte", "cpu"), (tb, tcascade.TASK_B, "texte +", "cpu")]


def test_teacher_forced_perplexity_matches_jax(tokenizers, cascade_models):
    """Within 1e-4 relative."""
    jt, tt = tokenizers
    jmodel, ((pa, ta), _) = cascade_models
    prompt = jt.encode(jcascade.format_example(jcascade.TASK_A, SENTENCES[1], None))[:-1]
    target = jt.encode(SENTENCES[1] + " <break/>")[1:]
    want = jeval.teacher_forced_perplexity(jmodel, pa, jnp.asarray(prompt), jnp.asarray(target))
    got = teval.teacher_forced_perplexity(ta, np.asarray(prompt), np.asarray(target), device="cpu")
    assert abs(got - want) <= 1e-4 * want


def test_stage_metrics_equal_jax():
    preds = ["le chat <break/> dort ici", "il pleut", "<break/> oui non <break/> si"]
    refs = ["le chat <break/> dort <break/> ici", "il pleut", "oui <break/> non si"]
    assert teval.break_positions(preds[2]) == jeval.break_positions(preds[2])
    got = teval.evaluate_stage_a(preds, refs, [2.0, 4.0])
    want = jeval.evaluate_stage_a(preds, refs, [2.0, 4.0])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    sp = ['<prosody pitch="+5%" rate="-3.5%" volume="+2%">a</prosody><break time="300ms"/>', '<prosody pitch="-1%" rate="+1%">b</prosody>']
    sr = ['<prosody pitch="+4%" rate="-2%" volume="+1%">a</prosody><break time="250ms"/>', '<prosody pitch="-2%" rate="+2%" volume="0%">b</prosody>']
    assert teval.extract_ssml_parameters(sp[0]) == jeval.extract_ssml_parameters(sp[0])
    assert dataclasses.asdict(teval.evaluate_stage_b(sp, sr)) == dataclasses.asdict(jeval.evaluate_stage_b(sp, sr))
