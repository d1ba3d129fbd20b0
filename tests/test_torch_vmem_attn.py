"""Kernel G of the PyTorch port (causal attention for short training
sequences) against the JAX package's Pallas kernel.

The same numpy-seeded inputs go through ``causal_attention_vmem`` of the JAX
package in interpret mode (as ``tests/test_fused_kernels.py`` runs it off the
TPU) and through the port's wrapper, which on CPU tensors runs its plain
version. Float32 unless a test says otherwise; each comparison states its
tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prosody_control_french_tts_tpu.ops.vmem_attn import MAX_L as J_MAX_L, causal_attention_vmem as j_vmem
from prosody_control_french_tts_tpu_torch.models import llm as tllm
from prosody_control_french_tts_tpu_torch.ops import vmem_attn

B, H, KVH, HD = 2, 4, 2, 64


def inputs(L, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, L, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, L, KVH, HD)).astype(np.float32)
    v = rng.standard_normal((B, L, KVH, HD)).astype(np.float32)
    return q, k, v, float(1.0 / np.sqrt(HD))


def test_max_l_equals_jax():
    assert vmem_attn.MAX_L == J_MAX_L == 512


@pytest.mark.parametrize("L", [256, 128])
def test_forward_matches_jax_kernel(L):
    """Within 2e-5, the JAX suite's own bound against dense math."""
    q, k, v, scale = inputs(L)
    want = np.asarray(j_vmem(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, True))
    got = vmem_attn.causal_attention_vmem(*map(torch.from_numpy, (q, k, v)), scale)
    assert got.shape == (B, L, H, HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("L", [256, 128])
def test_gradients_match_jax_kernel(L):
    """dq, dk, dv through the same scalar loss, sum(sin(0.3·out)): within 1e-5
    of the largest element of the JAX kernel's gradient (its backward kernel,
    with dk/dv summed over the group of 2 heads)."""
    q, k, v, scale = inputs(L, seed=3)
    want = jax.grad(lambda a, b, c: jnp.sum(jnp.sin(j_vmem(a, b, c, scale, True) * 0.3)), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    torch.sin(vmem_attn.causal_attention_vmem(tq, tk, tv, scale) * 0.3).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_bfloat16_forward_matches_jax_kernel():
    """bfloat16 in and out, within 5e-2 of the JAX kernel on the same bits
    (the outputs reach ~3, one bfloat16 rounding there is 8e-3)."""
    q, k, v, scale = inputs(256, seed=7)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(j_vmem(jq, jk, jv, scale, True).astype(jnp.float32))
    got = vmem_attn.causal_attention_vmem(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), scale)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() < 5e-2


def test_causality():
    """Perturbing the last key/value row moves only the last query row."""
    q, k, v, scale = inputs(128, seed=5)
    out0 = vmem_attn.causal_attention_vmem(*map(torch.from_numpy, (q, k, v)), scale).numpy()
    k2, v2 = k.copy(), v.copy()
    k2[:, -1] += 3.0
    v2[:, -1] += 3.0
    out1 = vmem_attn.causal_attention_vmem(*map(torch.from_numpy, (q, k2, v2)), scale).numpy()
    np.testing.assert_allclose(out0[:, :-1], out1[:, :-1], atol=1e-6)
    assert np.abs(out0[:, -1] - out1[:, -1]).max() > 1e-3


def test_wrapper_checks_shapes_and_devices():
    q, k, v, scale = map(lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a, inputs(128))
    with pytest.raises(ValueError, match="MAX_L"):
        big = torch.zeros((1, 640, 4, 64))
        vmem_attn.causal_attention_vmem(big, big[:, :, :2], big[:, :, :2], scale)
    with pytest.raises(ValueError, match="do not fit"):
        vmem_attn.causal_attention_vmem(q, k[:, :, :1].expand(-1, -1, 3, -1), v[:, :, :1].expand(-1, -1, 3, -1), scale)
    meta = torch.empty((1, 128, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        vmem_attn.causal_attention_vmem(meta, meta[:, :, :2], meta[:, :, :2], scale)
    assert vmem_attn.launches == 0 and vmem_attn.launches_bwd == 0  # no card here: the kernel never ran


@pytest.mark.parametrize(
    "L,masked,reaches_kernel",
    [(128, False, True), (256, False, True), (96, False, False), (128, True, False)],
)
def test_model_dispatch_rule(L, masked, reaches_kernel):
    """attn_impl="vmem" reaches ops.vmem_attn once per layer only without a
    cache, without an attn_mask and with L a multiple of 128 up to MAX_L;
    L = 96 and a padded mask take the dot path; and the logits are those of
    attn_impl="dot" within 2e-5."""
    cfg = tllm.LLMConfig(vocab_size=256, dim=256, layers=2, heads=4, kv_heads=2, ffn=128, max_len=256, lora_rank=0, dtype=torch.float32)
    dot = tllm.DecoderLM(cfg, device="cpu", seed=1)
    vm = tllm.DecoderLM(dataclasses.replace(cfg, attn_impl="vmem"), device="cpu", seed=2)
    vm.load_state_dict(dot.state_dict())
    ids = torch.from_numpy(np.random.default_rng(L).integers(1, 256, size=(2, L)).astype(np.int32))
    keep = None
    if masked:
        keep = torch.ones((2, L), dtype=torch.bool)
        keep[:, -5:] = False
    n = vmem_attn.calls
    with torch.no_grad():
        got = vm(ids, attn_mask=keep)
        assert vmem_attn.calls - n == (cfg.layers if reaches_kernel else 0)
        want = dot(ids, attn_mask=keep)
    assert vmem_attn.calls - n == (cfg.layers if reaches_kernel else 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


def test_decode_with_caches_takes_the_dot_path():
    cfg = tllm.LLMConfig(vocab_size=256, dim=256, layers=1, heads=4, kv_heads=2, ffn=128, max_len=256, lora_rank=0, dtype=torch.float32, attn_impl="vmem")
    model = tllm.DecoderLM(cfg, device="cpu")
    caches = tllm.init_kv_caches(cfg, 1, 128, device="cpu")
    n = vmem_attn.calls
    with torch.no_grad():
        model(torch.ones((1, 128), dtype=torch.int32), kv_caches=caches, cache_pos=0)
    assert vmem_attn.calls == n
