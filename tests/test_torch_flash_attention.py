"""The port's flash attention (``ops.flash_attention``, the long-sequence
training attention behind ``attn_impl="flash"``) against the upstream Pallas
TPU flash-attention op that the JAX package's model calls.

The JAX side runs wholly inside ``pltpu.force_tpu_interpret_mode()``: off the
TPU the upstream op runs only in interpret mode, and every jitted function
that reaches it (its own jit, the JAX package's train step) is traced inside
the context. The port runs its plain version on the CPU. The same numpy-seeded
inputs go to both; float32 unless a test says otherwise; each comparison
states its tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as upstream

from prosody_control_french_tts_tpu.models import llm as jllm, training as jtraining
from prosody_control_french_tts_tpu_torch import convert
from prosody_control_french_tts_tpu_torch.models import llm as tllm, training as ttraining
from prosody_control_french_tts_tpu_torch.ops import flash_attention as fa

# tests/test_torch_training.py's PARITY shape at L 256: two 128-key tiles
PARITY = dict(vocab_size=1024, dim=128, layers=2, heads=4, kv_heads=2, ffn=256, max_len=256, lora_rank=4)
L_TRAIN = 256
LR = 1e-3
STEPS = 4


def inputs(B, H, L, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, L, hd)).astype(np.float32) for _ in range(4)]


def upstream_fwd_bwd(q, k, v, do, scale):
    """The upstream op's output and dq, dk, dv for the cotangent ``do``."""
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda a, b, c: upstream.flash_attention(a, b, c, causal=True, sm_scale=scale),
                           *map(jnp.asarray, (q, k, v)))
        grads = vjp(jnp.asarray(do))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("L,hd", [(128, 64), (384, 64), (640, 64), (256, 128)])
def test_forward_and_gradients_match_upstream(L, hd):
    """B 1, H 2, float32. L 128 is the upstream single-step body, 384 and 640
    the tiled one (640 is past kernel G's MAX_L of 512). Forward within 1e-5
    absolute and dq, dk, dv within 1e-5 of the largest element of the
    upstream gradient: the same rounding points, float32 sums in another
    order (about 5e-7 seen)."""
    q, k, v, do = inputs(1, 2, L, hd, seed=L + hd)
    scale = float(1.0 / np.sqrt(hd))
    want, want_grads = upstream_fwd_bwd(q, k, v, do, scale)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=True, sm_scale=scale)
    out.backward(torch.from_numpy(do))
    assert out.shape == (1, 2, L, hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-5)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want_grads):
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("L", [128, 256])
def test_bfloat16_forward_matches_upstream(L):
    """bfloat16 in and out: every output within one bfloat16 rounding of the
    upstream op's (2^-7 of its magnitude; the plain version takes the same
    rounding points, so most outputs are bit-equal). L 128 normalises p before
    its cast to bfloat16, L 256 rounds the unnormalised p of each tile."""
    q, k, v, _ = inputs(1, 2, L, 64, seed=7)
    with pltpu.force_tpu_interpret_mode():
        want = upstream.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True, sm_scale=0.125)
        want = np.asarray(want.astype(jnp.float32))
    got = fa.flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), sm_scale=0.125)
    assert got.dtype == torch.bfloat16
    assert (np.abs(got.float().numpy() - want) <= 2.0**-7 * np.abs(want) + 1e-6).all()


def test_causality():
    """Changing the keys and values of the last 128 positions leaves every
    earlier output row bit-equal and moves the last rows."""
    q, k, v, _ = inputs(2, 2, 384, 64, seed=5)
    out0 = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), sm_scale=0.125)
    k2, v2 = k.copy(), v.copy()
    k2[:, :, -128:] += 3.0
    v2[:, :, -128:] -= 2.0
    out1 = fa.flash_attention(*map(torch.from_numpy, (q, k2, v2)), sm_scale=0.125)
    assert torch.equal(out0[:, :, :256], out1[:, :, :256])
    assert float((out0[:, :, -1] - out1[:, :, -1]).abs().max()) > 1e-2


def test_wrapper_checks_shapes_and_devices():
    """L must be a positive multiple of 128; q, k, v one shape and one dtype;
    only the causal form; a device other than the CPU or a card raises. No
    kernel runs here."""
    q = torch.zeros((1, 2, 256, 64))
    for bad in (q[:, :, :100], q[:, :, :64]):
        with pytest.raises(ValueError, match="multiple of 128"):
            fa.flash_attention(bad, bad, bad)
    with pytest.raises(ValueError, match="must all be"):
        fa.flash_attention(q, q[:, :1], q[:, :1])
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(NotImplementedError, match="causal"):
        fa.flash_attention(q, q, q, causal=False)
    meta = torch.empty((1, 2, 128, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(meta, meta, meta)
    assert fa.launches == 0 and fa.launches_bwd == 0  # no card here: the kernel never ran


def test_repeat_kv_is_jnp_repeat_with_a_deterministic_group_sum():
    """repeat_kv equals jnp.repeat(x, group, axis=2) (each KV head repeated in
    place) with heads moved before L, and its backward is the sum over each
    group of heads: equal to that sum taken explicitly, and the same bits on a
    second run."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    g = rng.standard_normal((2, 12, 5, 8)).astype(np.float32)
    want = np.asarray(jnp.repeat(jnp.asarray(x), 4, axis=2)).transpose(0, 2, 1, 3)
    assert np.array_equal(fa.repeat_kv(torch.from_numpy(x), 4).numpy(), want)
    grads = []
    for _ in range(2):
        t = torch.from_numpy(x).requires_grad_(True)
        fa.repeat_kv(t, 4).backward(torch.from_numpy(g))
        grads.append(t.grad)
    assert torch.equal(grads[0], grads[1])
    np.testing.assert_allclose(grads[0].numpy(), g.reshape(2, 3, 4, 5, 8).sum(axis=2).transpose(0, 2, 1, 3), rtol=1e-6, atol=1e-6)


def upstream_gqa_fwd_bwd(q, k, v, do, scale):
    """The JAX model's composition on [B, L, heads, hd]: ``jnp.repeat`` of K/V
    over the group, the transposes, the upstream op; output and dq, dk, dv
    (dk, dv of the unrepeated K/V)."""
    group = q.shape[2] // k.shape[2]

    def f(a, b, c):
        b, c = (jnp.repeat(x, group, axis=2) for x in (b, c))
        out = upstream.flash_attention(*(x.transpose(0, 2, 1, 3) for x in (a, b, c)), causal=True, sm_scale=scale)
        return out.transpose(0, 2, 1, 3)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
        grads = vjp(jnp.asarray(do))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("group,L,hd", [(7, 128, 64), (7, 256, 128), (2, 256, 64), (2, 128, 128)])
def test_gqa_entry_matches_jax_repeat_and_upstream(group, L, hd):
    """flash_attention_gqa on the model's layout (q [B, L, H, hd], k, v
    [B, L, KVH, hd]) against the JAX model's jnp.repeat + transposes +
    upstream op, float32: group 7 (Qwen's 28 / 4) and 2, B 1, KVH 1 and 2.
    Forward within 1e-5 absolute; dq and the unrepeated dk, dv within 1e-5
    of the largest element of the JAX gradient, the file's tolerance (the
    group's sum in another order on top of the float32 sums)."""
    kvh = 1 if group == 7 else 2
    rng = np.random.default_rng(group * 1000 + L + hd)
    q, do = (rng.standard_normal((1, L, group * kvh, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, L, kvh, hd)).astype(np.float32) for _ in range(2))
    scale = float(1.0 / np.sqrt(hd))
    want, want_grads = upstream_gqa_fwd_bwd(q, k, v, do, scale)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fa.flash_attention_gqa(tq, tk, tv, scale)
    out.backward(torch.from_numpy(do))
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-5)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want_grads):
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_gqa_wrapper_checks_shapes_and_devices():
    """The model's entry refuses what the kernels do not take, on any device:
    H not a multiple of KVH, L not a positive multiple of 128, mismatched
    shapes or dtypes, a device other than the CPU or a card. No kernel runs
    here."""
    q = torch.zeros((1, 256, 6, 64))
    kv = torch.zeros((1, 256, 4, 64))
    with pytest.raises(ValueError, match="multiple of 4 KV heads"):
        fa.flash_attention_gqa(q, kv, kv)
    for bad in (q[:, :100], q[:, :64]):
        with pytest.raises(ValueError, match="multiple of 128"):
            fa.flash_attention_gqa(bad, kv[:, : bad.shape[1], :2], kv[:, : bad.shape[1], :2])
    with pytest.raises(ValueError, match="must be"):
        fa.flash_attention_gqa(q, kv[:, :128, :2], kv[:, :128, :2])
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention_gqa(q, kv[..., :2, :].bfloat16(), kv[..., :2, :])
    meta = torch.empty((1, 128, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_gqa(meta, meta[:, :, :2], meta[:, :, :2])


def test_model_flash_branch_reaches_the_gqa_entry(monkeypatch):
    """attn_impl="flash" sends each layer's q and grouped K/V to
    flash_attention_gqa in the model's layout, once a layer, and never to the
    upstream-layout entry (which would need the K/V repeat and transposes
    around it): both are counted by wrappers here."""
    seen, upstream_calls = [], []
    gqa = fa.flash_attention_gqa

    def recorder(q, k, v, sm_scale=1.0):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
        return gqa(q, k, v, sm_scale)

    monkeypatch.setattr(fa, "flash_attention_gqa", recorder)
    monkeypatch.setattr(fa, "flash_attention", lambda *a, **k: upstream_calls.append(1))
    cfg = tllm.LLMConfig(vocab_size=256, dim=128, layers=2, heads=4, kv_heads=2, ffn=128, max_len=128, lora_rank=0,
                         dtype=torch.float32, attn_impl="flash")
    model = tllm.DecoderLM(cfg, device="cpu", seed=3)
    n = fa.calls
    with torch.no_grad():
        out = model(torch.ones((2, 128), dtype=torch.int32))
    assert seen == [((2, 128, 4, 32), (2, 128, 2, 32), (2, 128, 2, 32))] * cfg.layers
    assert fa.calls - n == cfg.layers and not upstream_calls
    assert bool(torch.isfinite(out).all())


def jax_flash_calls(cfg, L, masked, decode, monkeypatch):
    """How many times the JAX package's model reaches the upstream op in one
    forward: traced by jax.eval_shape with the op replaced by a recorder, so
    nothing is computed."""
    seen = []

    def recorder(q, k, v, causal=False, sm_scale=1.0):
        seen.append(q.shape)
        return q

    monkeypatch.setattr(upstream, "flash_attention", recorder)
    model = jllm.DecoderLM(cfg)
    ids = jax.ShapeDtypeStruct((2, L), jnp.int32)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), ids)
    seen.clear()  # the init trace runs the forward too
    if decode:
        caches = jllm.init_kv_caches(cfg, 2, L)
        pos = jnp.broadcast_to(jnp.arange(L), (2, L))
        jax.eval_shape(lambda p, i: model.apply(p, i, positions=pos, kv_caches=caches, cache_pos=0), params, ids)
    else:
        mask = jnp.ones((2, L), bool) if masked else None
        jax.eval_shape(lambda p, i: model.apply(p, i, attn_mask=mask), params, ids)
    return len(seen)


@pytest.mark.parametrize("L", [64, 128, 200, 512, 640, 1024])
@pytest.mark.parametrize("masked", [False, True])
def test_model_dispatch_rule_equals_jax(L, masked, monkeypatch):
    """attn_impl="flash" reaches ops.flash_attention once per layer exactly
    where the JAX model reaches the upstream op: no attn_mask, no cache, L a
    positive multiple of 128 with no upper bound; else the dot path. The
    logits equal attn_impl="dot"'s within 2e-5."""
    jcfg = jllm.LLMConfig(vocab_size=256, dim=64, layers=2, heads=4, kv_heads=2, ffn=128, max_len=L, lora_rank=0,
                          dtype=jnp.float32, attn_impl="flash")
    n_jax = jax_flash_calls(jcfg, L, masked, False, monkeypatch)
    cfg = tllm.LLMConfig(vocab_size=256, dim=64, layers=2, heads=4, kv_heads=2, ffn=128, max_len=L, lora_rank=0,
                         dtype=torch.float32)
    dot = tllm.DecoderLM(cfg, device="cpu", seed=1)
    flash = tllm.DecoderLM(dataclasses.replace(cfg, attn_impl="flash"), device="cpu", seed=2)
    flash.load_state_dict(dot.state_dict())
    ids = torch.from_numpy(np.random.default_rng(L).integers(1, 256, size=(2, L)).astype(np.int32))
    keep = None
    if masked:
        keep = torch.ones((2, L), dtype=torch.bool)
        keep[:, -5:] = False
    n = fa.calls
    with torch.no_grad():
        got = flash(ids, attn_mask=keep)
        n_port = fa.calls - n
        want = dot(ids, attn_mask=keep)
    assert n_port == n_jax == (cfg.layers if L % 128 == 0 and not masked else 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


def test_decode_with_caches_takes_the_dot_path(monkeypatch):
    jcfg = jllm.LLMConfig(vocab_size=256, dim=64, layers=1, heads=4, kv_heads=2, ffn=128, max_len=128, lora_rank=0,
                          dtype=jnp.float32, attn_impl="flash")
    assert jax_flash_calls(jcfg, 128, False, True, monkeypatch) == 0
    cfg = tllm.LLMConfig(vocab_size=256, dim=64, layers=1, heads=4, kv_heads=2, ffn=128, max_len=128, lora_rank=0,
                         dtype=torch.float32, attn_impl="flash")
    model = tllm.DecoderLM(cfg, device="cpu")
    caches = tllm.init_kv_caches(cfg, 1, 128, device="cpu")
    n = fa.calls
    with torch.no_grad():
        model(torch.ones((1, 128), dtype=torch.int32), kv_caches=caches, cache_pos=0)
    assert fa.calls == n


def batch(seed=0):
    ids = np.random.default_rng(seed).integers(1, PARITY["vocab_size"], (2, L_TRAIN)).astype(np.int32)
    return ids, np.ones((2, L_TRAIN), np.float32)


@pytest.mark.parametrize("loss_impl", ["dense", "fused"])
def test_loss_curve_matches_jax_train_step(loss_impl):
    """The JAX package's jitted train step with attn_impl="flash" (traced and
    run inside the interpret-mode context) and the port's, 4 steps on a
    repeated batch of L 256 from the same initial weights, float32: losses
    within 2e-5 relative (the bound of tests/test_torch_training.py for paths
    with the same rounding points; about 6e-7 seen), and falling. Adapters
    after the steps within 0.25·lr·steps in every element and 2 % of
    lr·steps on average (Adam moves every element by about lr a step whatever
    its gradient's size); frozen leaves bit-identical."""
    ids, mask = batch()
    with pltpu.force_tpu_interpret_mode():
        jcfg = jllm.LLMConfig(**PARITY, dtype=jnp.float32, attn_impl="flash")
        model, tx, state = jtraining.init_train(jcfg, lr=LR)
        step = jtraining.make_train_step(model, tx, donate=False, trainable=state.mask, loss_impl=loss_impl)
        p, o = state.params, state.opt_state
        jlosses = []
        for _ in range(STEPS):
            p, o, loss = step(p, o, jnp.asarray(ids), jnp.asarray(mask))
            jlosses.append(float(loss))
    cfg = tllm.LLMConfig(**PARITY, dtype=torch.float32, attn_impl="flash")
    tmodel, ttx, tstate = ttraining.init_train(cfg, lr=LR, device="cpu")
    tmodel.load_state_dict(convert.llm_params_from_jax(jax.tree.map(np.asarray, state.params), cfg))
    tstep = ttraining.make_train_step(tmodel, ttx, trainable=tstate.mask, loss_impl=loss_impl)
    assert tstep.loss_impl == loss_impl
    before = {k: t.clone() for k, t in tmodel.state_dict().items()}
    n = fa.calls
    losses = [float(tstep(ids, mask)) for _ in range(STEPS)]
    assert fa.calls - n == cfg.layers * STEPS
    for got, want in zip(losses, jlosses):
        assert abs(got - want) <= 2e-5 * abs(want), (losses, jlosses)
    assert losses[-1] < losses[0]
    want = convert.llm_params_from_jax(jax.tree.map(np.asarray, p), cfg)
    for name, t in tmodel.state_dict().items():
        if tstate.mask[name]:
            diff = (t - want[name]).abs()
            assert float(diff.max()) <= 0.25 * LR * STEPS, name
            assert float(diff.mean()) <= 0.02 * LR * STEPS, name
        else:
            assert torch.equal(t, before[name]), name


@pytest.mark.parametrize("policy", [None, "dots"])
def test_remat_gives_the_same_loss_and_gradients(policy):
    """remat=True with attn_impl="flash" at L 256 (full recompute, and the
    "dots" policy): loss equal and LoRA gradients within 1e-6 of their
    largest element of the model without remat; the recompute calls the op
    again (twice per layer)."""
    cfg = tllm.LLMConfig(**PARITY, dtype=torch.float32, attn_impl="flash", fused_qkv=True)
    ids, mask = batch(seed=2)
    base = tllm.DecoderLM(cfg, device="cpu", seed=5)
    with torch.no_grad():
        for n, p in base.named_parameters():
            if n.endswith("lora_b"):
                p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
    re = tllm.DecoderLM(dataclasses.replace(cfg, remat=True, remat_policy=policy), device="cpu", seed=6)
    re.load_state_dict(base.state_dict())
    out = []
    for m, calls in ((base, cfg.layers), (re, 2 * cfg.layers)):
        n = fa.calls
        loss = tllm.causal_lm_loss(m(torch.from_numpy(ids)), torch.from_numpy(ids), torch.from_numpy(mask))
        loss.backward()
        assert fa.calls - n == calls
        out.append((float(loss.detach()), {n: p.grad for n, p in m.named_parameters() if "lora" in n}))
    assert abs(out[0][0] - out[1][0]) <= 1e-6 * abs(out[0][0])
    for n, g in out[0][1].items():
        assert float((g - out[1][1][n]).abs().max()) <= 1e-6 * float(g.abs().max()), n
