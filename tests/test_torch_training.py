"""The PyTorch port's LoRA training path against the JAX package:
``fused_qkv``, ``remat``, ``models.training`` (``init_train``,
``make_train_step``) and ``cascade.train_stage``.

Weights are made by the JAX initialisers, carried to the port as numpy arrays
by ``convert.llm_params_from_jax``; ids come from numpy seeds; the optimizer
state starts fresh on both sides. Both sides run on the CPU in float32: the
JAX side runs its Pallas kernels in interpret mode (the model and the train
step pick that themselves off the TPU), the port its kernels' plain versions.
Each comparison states its tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prosody_control_french_tts_tpu.models import cascade as jcascade, llm as jllm, quant as jquant, training as jtraining
from prosody_control_french_tts_tpu.models.tokenizer import WordPieceTokenizer as JTokenizer
from prosody_control_french_tts_tpu_torch import convert
from prosody_control_french_tts_tpu_torch.models import cascade as tcascade, llm as tllm, quant as tquant, training as ttraining
from prosody_control_french_tts_tpu_torch.models.tokenizer import WordPieceTokenizer as TTokenizer

# tests/test_fused_kernels.py::TestTrainStepParity's shape
PARITY = dict(vocab_size=1024, dim=128, layers=2, heads=4, kv_heads=2, ffn=256, max_len=128, lora_rank=4)
LR = 1e-3
STEPS = 4


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def randomize_lora_b(params, seed=0, std=0.1):
    """lora_b is zero at init, which would hide adapter-path faults."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        if any(getattr(k, "key", None) == "lora_b" for k in path):
            return jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * std)
        return x

    return jax.tree_util.tree_map_with_path(f, params)


def carried(jparams, tmodel, tcfg):
    state = convert.llm_params_from_jax(to_numpy(jparams), tcfg)
    assert sorted(state) == sorted(tmodel.state_dict())
    tmodel.load_state_dict(state)
    return tmodel


def batch(vocab, shape, seed=0):
    ids = np.random.default_rng(seed).integers(1, vocab, shape).astype(np.int32)
    return ids, np.ones(shape[-2:], np.float32)


def lora_grads_jax(model, params, ids):
    g = jax.grad(lambda p: jnp.mean(model.apply(p, jnp.asarray(ids)).astype(jnp.float32) ** 2))(params)
    flat = convert._flatten(to_numpy(g)["params"])
    return {k: v for k, v in flat.items() if "lora" in k}


def lora_grads_torch(model, ids):
    model.zero_grad()
    model(torch.from_numpy(ids)).float().square().mean().backward()
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters() if "lora" in n}


# ---------------------------------------------------------------------------
# fused_qkv, remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [0, 4])
def test_fused_qkv_matches_jax_and_the_unfused_model(rank):
    """fused_qkv=True: the state_dict's keys are those of the unfused model;
    float32 logits within 1e-4 of the JAX model with the same flag and of the
    port's unfused model (with lora_b at std 0.1 the logits reach several units
    and the float32 sums run in another order); LoRA gradients (lora_b randomised) within 1e-4 of
    their largest element of both."""
    kw = dict(vocab_size=512, dim=128, layers=2, heads=4, kv_heads=2, ffn=256, max_len=64, lora_rank=rank)
    jcfg = jllm.LLMConfig(**kw, dtype=jnp.float32, fused_qkv=True)
    tcfg = tllm.LLMConfig(**kw, dtype=torch.float32)
    ids, _ = batch(512, (2, 48), seed=1)
    jmodel = jllm.DecoderLM(jcfg)
    jparams = randomize_lora_b(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids)))
    plain = carried(jparams, tllm.DecoderLM(tcfg, device="cpu"), tcfg)
    fused = tllm.DecoderLM(dataclasses.replace(tcfg, fused_qkv=True), device="cpu", seed=3)
    assert list(fused.state_dict()) == list(plain.state_dict())
    fused.load_state_dict(plain.state_dict())
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(ids)))
    got = fused(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, plain(torch.from_numpy(ids)).detach().numpy(), rtol=1e-4, atol=1e-4)
    if rank:
        gj = lora_grads_jax(jmodel, jparams, ids)
        gf, gp = lora_grads_torch(fused, ids), lora_grads_torch(plain, ids)
        names = convert.llm_params_from_jax({k: v for k, v in convert._flatten(to_numpy(jparams)["params"]).items()}, tcfg)
        assert len(gf) == len(gj) == 2 * 7 * kw["layers"] and set(gf) <= set(names)
        for jkey, ref in gj.items():
            name = "layers." + jkey[len("layer_") :].replace("/", ".")
            for other in (ref, gp[name]):
                assert np.abs(gf[name] - other).max() <= 1e-4 * np.abs(other).max(), name


@pytest.mark.parametrize("policy", [None, "dots"])
@pytest.mark.parametrize("attn_impl", ["dot", "vmem"])
def test_remat_gives_the_same_loss_and_gradients(policy, attn_impl):
    """remat=True (full recompute, and the "dots" policy that saves matrix
    products): loss equal and LoRA gradients within 1e-6 of their largest
    element of the model without it."""
    cfg = tllm.LLMConfig(**PARITY, dtype=torch.float32, attn_impl=attn_impl, fused_qkv=True)
    ids, mask = batch(cfg.vocab_size, (2, 128), seed=2)
    base = tllm.DecoderLM(cfg, device="cpu", seed=5)
    with torch.no_grad():
        for n, p in base.named_parameters():
            if n.endswith("lora_b"):
                p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
    re = tllm.DecoderLM(dataclasses.replace(cfg, remat=True, remat_policy=policy), device="cpu", seed=6)
    re.load_state_dict(base.state_dict())
    out = []
    for m in (base, re):
        loss = tllm.causal_lm_loss(m(torch.from_numpy(ids)), torch.from_numpy(ids), torch.from_numpy(mask))
        loss.backward()
        out.append((float(loss.detach()), {n: p.grad for n, p in m.named_parameters() if "lora" in n}))
    assert abs(out[0][0] - out[1][0]) <= 1e-6 * abs(out[0][0])
    for n, g in out[0][1].items():
        assert float((g - out[1][1][n]).abs().max()) <= 1e-6 * float(g.abs().max()), n


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

PAIRS = [("dot", "dense"), ("dot", "fused"), ("vmem", "dense"), ("vmem", "fused")]


def jax_run(attn_impl, loss_impl, steps=STEPS, accum=1, quant=None):
    """The JAX package's train step from its own init: (initial params,
    losses, final params)."""
    cfg = jllm.LLMConfig(**PARITY, dtype=jnp.float32, attn_impl=attn_impl, quant=quant)
    model, tx, state = jtraining.init_train(cfg, lr=LR, accum=accum)
    step = jtraining.make_train_step(model, tx, donate=False, trainable=state.mask, loss_impl=loss_impl)
    ids, mask = batch(cfg.vocab_size, (steps, 2, 128))
    p, o = state.params, state.opt_state
    losses = []
    for i in range(steps):
        p, o, loss = step(p, o, jnp.asarray(ids[i if accum > 1 else 0]), jnp.asarray(mask))
        losses.append(float(loss))
    return state.params, losses, p


def torch_trainer(jparams, attn_impl, loss_impl, accum=1, scan_steps=None, quant=None, **kw):
    cfg = tllm.LLMConfig(**PARITY, dtype=torch.float32, attn_impl=attn_impl, quant=quant)
    model, tx, state = ttraining.init_train(cfg, lr=LR, accum=accum, device="cpu", **kw)
    carried(jparams, model, cfg)
    step = ttraining.make_train_step(model, tx, trainable=state.mask, loss_impl=loss_impl, scan_steps=scan_steps)
    return model, state, step


@pytest.fixture(scope="module")
def jax_curves():
    return {pair: jax_run(*pair) for pair in PAIRS}


@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_loss_curve_matches_jax(jax_curves, pair):
    """4 steps on a repeated batch, float32, from the same carried weights:
    the port's loss curve within 2e-5 relative of the JAX package's for the
    same (attn_impl, loss_impl) pair, 5e-4 where "vmem" is on (the JAX
    suite's own bounds), and falling. Adapters after the steps: Adam divides
    by √v ≈ |g| in its first steps, so every element moves by about lr per
    step whatever its gradient's size and the smallest gradients amplify
    rounding; they are held within 0.25·lr·steps in every element and within
    2 % of lr·steps on average. Frozen leaves are bit-identical."""
    jinit, jlosses, jfinal = jax_curves[pair]
    model, state, step = torch_trainer(jinit, *pair)
    assert step.loss_impl == pair[1]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ids, mask = batch(PARITY["vocab_size"], (STEPS, 2, 128))
    losses = [float(step(ids[0], mask)) for _ in range(STEPS)]
    tol = 5e-4 if pair[0] == "vmem" else 2e-5
    for got, want in zip(losses, jlosses):
        assert abs(got - want) <= tol * abs(want), (losses, jlosses)
    assert losses[-1] < losses[0]
    want = convert.llm_params_from_jax(to_numpy(jfinal), model.cfg)
    moved = 0
    for name, t in model.state_dict().items():
        if state.mask[name]:
            diff = (t - want[name]).abs()
            assert float(diff.max()) <= 0.25 * LR * STEPS, name
            assert float(diff.mean()) <= 0.02 * LR * STEPS, name
            moved += int(not torch.equal(t, before[name]))
        else:
            assert torch.equal(t, before[name]), name
            assert torch.equal(t, want[name]), name
    assert moved == sum(state.mask.values()) > 0


def test_accum_matches_jax_multisteps():
    """accum=2 over 4 calls with 4 different batches: two updates; the losses
    within 2e-5 relative of optax.MultiSteps, parameters unchanged after the
    odd calls."""
    jinit, jlosses, _ = jax_run("dot", "dense", steps=4, accum=2)
    model, state, step = torch_trainer(jinit, "dot", "dense", accum=2)
    ids, mask = batch(PARITY["vocab_size"], (4, 2, 128))
    losses = []
    for i in range(4):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        losses.append(float(step(ids[i], mask)))
        changed = any(not torch.equal(v, before[k]) for k, v in model.state_dict().items())
        assert changed == (i % 2 == 1)
    for got, want in zip(losses, jlosses):
        assert abs(got - want) <= 2e-5 * abs(want), (losses, jlosses)


def test_scan_steps_equals_single_steps(jax_curves):
    jinit = jax_curves[("dot", "dense")][0]
    ids, mask = batch(PARITY["vocab_size"], (3, 2, 128), seed=4)
    m1, _, single = torch_trainer(jinit, "dot", "dense")
    m2, _, multi = torch_trainer(jinit, "dot", "dense", scan_steps=3)
    want = torch.stack([single(ids[i], mask) for i in range(3)])
    got = multi(ids, mask)
    assert got.shape == (3,) and torch.equal(got, want)
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="stacked"):
        multi(ids[:2], mask)


def test_loss_impl_rules():
    """"fused" needs a frozen head; "auto" is fused only when the geometry
    tiles and the head is frozen; an optimizer over other leaves raises."""
    cfg = tllm.LLMConfig(**PARITY, dtype=torch.float32)
    model, tx, state = ttraining.init_train(cfg, device="cpu")
    assert ttraining.make_train_step(model, tx, trainable=state.mask).loss_impl == "fused"
    assert ttraining.make_train_step(model, tx, trainable=state.mask, loss_impl="dense").loss_impl == "dense"
    with pytest.raises(ValueError, match="loss_impl"):
        ttraining.make_train_step(model, tx, trainable=state.mask, loss_impl="sparse")
    with pytest.raises(ValueError, match="optimizer"):
        ttraining.make_train_step(model, tx, trainable=None, loss_impl="dense")
    full, ftx, fstate = ttraining.init_train(cfg, device="cpu", lora_only=False)
    assert fstate.mask["lm_head.kernel"] and full.lm_head.kernel.requires_grad
    with pytest.raises(ValueError, match="frozen lm_head"):
        ttraining.make_train_step(full, ftx, trainable=fstate.mask, loss_impl="fused")
    with pytest.raises(ValueError, match="frozen lm_head"):
        ttraining.make_train_step(full, ftx, trainable=None, loss_impl="fused")
    assert ttraining.make_train_step(full, ftx, trainable=fstate.mask).loss_impl == "dense"
    tiny = tllm.LLMConfig.tiny()
    tm, ttx, tstate = ttraining.init_train(tiny, device="cpu")
    assert ttraining.make_train_step(tm, ttx, trainable=tstate.mask).loss_impl == "dense"  # dim 64: does not tile
    no_lora, ntx, nstate = ttraining.init_train(dataclasses.replace(cfg, lora_rank=0), device="cpu")
    assert all(nstate.mask[n] for n, _ in no_lora.named_parameters())  # rank 0: every float leaf trains


def test_optimizer_defaults_equal_optax_adamw():
    p = torch.nn.Parameter(torch.zeros(3))
    tx = ttraining.make_optimizer([p])
    group = tx.inner.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (3e-4, (0.9, 0.999), 1e-8, 0.0)
    with pytest.raises(ValueError):
        ttraining.make_optimizer([p], accum=0)


def test_frozen_dtype_downcasts_the_frozen_leaves_only():
    """frozen_dtype=bfloat16: base kernels, biases, norms, embedding and head
    become bfloat16, adapters stay float32 and train; the dense loss still
    computes float32 logits from the bfloat16 head; frozen leaves are
    bit-identical after the steps."""
    cfg = tllm.LLMConfig(**PARITY)
    model, tx, state = ttraining.init_train(cfg, lr=LR, frozen_dtype=torch.bfloat16, device="cpu")
    for name, t in state.params.items():
        assert t.dtype == (torch.float32 if state.mask[name] else torch.bfloat16), name
    assert [n for n, p in model.named_parameters() if p.requires_grad] == [n for n, m in state.mask.items() if m]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ids, mask = batch(cfg.vocab_size, (2, 128))
    for loss_impl in ("dense", "fused"):
        step = ttraining.make_train_step(model, tx, trainable=state.mask, loss_impl=loss_impl)
        loss = step(ids, mask)
        assert loss.dtype == torch.float32 and torch.isfinite(loss)
    for name, t in model.state_dict().items():
        assert torch.equal(t, before[name]) != state.mask[name], name
    assert model(torch.from_numpy(ids)).dtype == torch.float32


def test_qlora_step_over_an_int8b_base():
    """A LoRA step over a blockwise-int8 base (the QLoRA shape): runs, the
    loss falls, only the adapters move, the integer codes ride along; the
    first loss within 1e-5 relative of the JAX step on the same tree."""
    cfg = tllm.LLMConfig(**PARITY, dtype=torch.float32)
    jcfg = jllm.LLMConfig(**PARITY, dtype=jnp.float32)
    jparams = jllm.DecoderLM(jcfg).init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
    jq = jquant.recode_params_nf4_serving(jquant.quantize_params(jparams, "nf4"))
    qcfg = dataclasses.replace(cfg, quant="int8b")
    model, tx, state = ttraining.init_train(qcfg, lr=LR, device="cpu")
    model.load_state_dict(convert.llm_params_from_jax(to_numpy(jq), qcfg))
    assert model.layers[0].attn.q.kernel_q.dtype == torch.int8 and not state.mask["layers.0.attn.q.kernel_q"]
    step = ttraining.make_train_step(model, tx, trainable=state.mask)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ids, mask = batch(cfg.vocab_size, (2, 128), seed=3)
    losses = [float(step(ids, mask)) for _ in range(3)]
    assert losses[-1] < losses[0]
    for name, t in model.state_dict().items():
        assert torch.equal(t, before[name]) != state.mask[name], name
    jmodel = jllm.DecoderLM(dataclasses.replace(jcfg, quant="int8b"))
    want = float(jllm.causal_lm_loss(jmodel.apply(jq, jnp.asarray(ids)), jnp.asarray(ids), jnp.asarray(mask)))
    assert abs(losses[0] - want) <= 1e-5 * abs(want)
    assert tquant.quantized_bytes(model.state_dict()) < tquant.quantized_bytes(tllm.DecoderLM(cfg, device="cpu").state_dict())


def test_training_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttraining.init_train(tllm.LLMConfig.tiny())
    tok = TTokenizer.train(["le chat dort"], vocab_size=40, min_freq=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcascade.train_stage([{"x": "le chat", "y": "le <break/> chat"}], tok, epochs=1)


# ---------------------------------------------------------------------------
# the cascade's trainer
# ---------------------------------------------------------------------------

SENTENCES = [
    "Le portrait du compositeur est accroché au mur du salon.",
    "Elle marche lentement, puis elle s'arrête devant la porte.",
    "Bonjour, comment allez-vous aujourd'hui ?",
    "Le train de nuit arrive à Paris vers six heures du matin.",
    "Nous avons mangé du pain, du fromage et des pommes.",
    "Il pleut depuis ce matin, mais le soleil reviendra demain.",
]
STAGE_PAIRS = [{"x": s, "y": s.replace(",", " <break/>").replace(" du ", " <break/> du ")} for s in SENTENCES]


@pytest.fixture(scope="module")
def tokenizers():
    texts = SENTENCES + [jcascade.format_example(jcascade.TASK_A, p["x"], p["y"]) for p in STAGE_PAIRS]
    return JTokenizer.train(texts, vocab_size=300, min_freq=1), TTokenizer.train(texts, vocab_size=300, min_freq=1)


@pytest.mark.parametrize("max_len", [32, 96])
def test_build_batches_equal_jax(tokenizers, max_len):
    jt, tt = tokenizers
    want = jcascade.build_batches(STAGE_PAIRS, jt, jcascade.TASK_A, max_len)
    got = tcascade.build_batches(STAGE_PAIRS, tt, tcascade.TASK_A, max_len)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.loss_mask, want.loss_mask)
    assert (got.loss_mask.sum() > 0) == (max_len == 96)  # at 32 the prompt alone fills the row


def test_train_stage_matches_jax(tokenizers, monkeypatch):
    """train_stage on six pairs, 2 epochs, batches of 4 (so a short last
    batch and a fresh permutation per epoch), float32, from the same carried
    initial weights (the JAX initialiser at the same seed): every step's loss
    within 1e-4 relative of the JAX train_stage's, which shows the same
    permutation and batching; the adapters trained, the base did not."""
    jt, tt = tokenizers
    kw = dict(vocab_size=len(jt), dim=128, layers=2, heads=4, kv_heads=2, ffn=256, max_len=96)
    jcfg = jllm.LLMConfig(**kw, dtype=jnp.float32)
    tcfg = tllm.LLMConfig(**kw, dtype=torch.float32)
    _, _, jlosses = jcascade.train_stage(STAGE_PAIRS, jt, jcascade.TASK_A, jcfg, epochs=2, batch_size=4, lr=1e-3, seed=3)
    jinit = jllm.DecoderLM(jcfg).init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))
    real_init = ttraining.init_train
    seen = {}

    def init_from_carried(cfg, **kwargs):
        model, tx, state = real_init(cfg, **kwargs)
        carried(jinit, model, cfg)
        seen.update(kwargs, before={k: v.clone() for k, v in model.state_dict().items()})
        return model, tx, state

    monkeypatch.setattr(tcascade, "init_train", init_from_carried)
    model, params, losses = tcascade.train_stage(STAGE_PAIRS, tt, tcascade.TASK_A, tcfg, epochs=2, batch_size=4, lr=1e-3, seed=3, device="cpu")
    assert (seen["seed"], seen["lr"], seen["accum"], seen["device"]) == (3, 1e-3, 1, "cpu")
    assert len(losses) == len(jlosses) == 4
    for got, want in zip(losses, jlosses):
        assert abs(got - want) <= 1e-4 * abs(want), (losses, jlosses)
    assert sorted(params) == sorted(model.state_dict())
    for name, t in params.items():
        is_adapter = name.endswith(("lora_a", "lora_b"))
        assert torch.equal(t, seen["before"][name]) != is_adapter, name


def test_train_stage_refuses_checkpoints(tokenizers, tmp_path):
    """Per-epoch checkpoints are ported (``core.checkpoint``): train_stage
    with ``ckpt_dir`` no longer refuses and writes one step an epoch, as
    the JAX package's does (``tests/test_torch_checkpoint.py`` holds them
    to the trained weights)."""
    _, tt = tokenizers
    cfg = tllm.LLMConfig(vocab_size=len(tt), dim=32, layers=1, heads=2, kv_heads=1, ffn=64, max_len=96, dtype=torch.float32)
    tcascade.train_stage(STAGE_PAIRS, tt, cfg=cfg, epochs=1, ckpt_dir=tmp_path, device="cpu")
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000001"]
