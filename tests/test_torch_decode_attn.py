"""Kernel F's plain version (the port's ops/decode_attn.py) against the JAX
package's Pallas decode-attention kernel in interpret mode and its XLA
reference, on the same numpy inputs.

The CUDA kernel itself is held against this plain version on the card
(test_torch_kernels.py, gpu-marked; chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prosody_control_french_tts_tpu.ops.decode_attn import _pallas_call, decode_attention_reference
from prosody_control_french_tts_tpu_torch.ops import decode_attn as tda


def make_inputs(B=4, H=14, KV=2, hd=64, S=96, seed=0):
    """q [B, H, hd] and packed caches [B, S, KV*hd], float32 numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, KV * hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, KV * hd)).astype(np.float32)
    return q, kc, vc


def _plain(q, kc, vc, pos, kv, dtype=torch.float32):
    args = [torch.from_numpy(a).to(dtype) for a in (q, kc, vc)]
    return tda.decode_attention(*args, pos, kv).float().numpy()


def _jax(fn, q, kc, vc, pos, kv, dtype=jnp.float32):
    args = [jnp.asarray(a, dtype) for a in (q, kc, vc)]
    if fn == "pallas_interpret":
        return np.asarray(_pallas_call(*args, pos, kv, True), np.float32)
    return np.asarray(decode_attention_reference(*args, pos, kv), np.float32)


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla_reference"])
@pytest.mark.parametrize("pos", [0, 1, 50, 95])
def test_plain_matches_jax_f32(pos, reference):
    """float32, rtol = atol = 2e-5: the tolerance the JAX package holds its
    kernel to against its reference (sum order differs)."""
    q, kc, vc = make_inputs()
    np.testing.assert_allclose(_plain(q, kc, vc, pos, 2), _jax(reference, q, kc, vc, pos, 2), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla_reference"])
def test_plain_matches_jax_single_kv_head(reference):
    q, kc, vc = make_inputs(H=4, KV=1, hd=64, S=48)
    np.testing.assert_allclose(_plain(q, kc, vc, 30, 1), _jax(reference, q, kc, vc, 30, 1), rtol=2e-5, atol=2e-5)


def test_plain_matches_jax_head_dim_128_group_7():
    """The 7B geometry's head: hd 128, 7 query heads per KV head."""
    q, kc, vc = make_inputs(B=2, H=28, KV=4, hd=128, S=40, seed=3)
    np.testing.assert_allclose(
        _plain(q, kc, vc, 33, 4), _jax("pallas_interpret", q, kc, vc, 33, 4), rtol=2e-5, atol=2e-5
    )


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla_reference"])
def test_plain_matches_jax_bf16(reference):
    """bfloat16, rtol = atol = 2e-2: the XLA reference rounds the scores to
    bfloat16 before the softmax, the kernels do not."""
    q, kc, vc = make_inputs()
    got = _plain(q, kc, vc, 70, 2, torch.bfloat16)
    np.testing.assert_allclose(got, _jax(reference, q, kc, vc, 70, 2, jnp.bfloat16), rtol=0.02, atol=0.02)


def test_future_rows_change_nothing():
    """Rows past pos must not influence the output at all."""
    q, kc, vc = make_inputs(S=32)
    pos = 10
    base = _plain(q, kc, vc, pos, 2)
    kc2, vc2 = kc.copy(), vc.copy()
    kc2[:, pos + 1 :] = 1e4
    vc2[:, pos + 1 :] = -1e4
    np.testing.assert_array_equal(base, _plain(q, kc2, vc2, pos, 2))


def test_pos_zero_returns_first_value_row():
    """pos = 0 attends to exactly one row: out == v[0] per KV head."""
    q, kc, vc = make_inputs(B=2, S=16)
    got = _plain(q, kc, vc, 0, 2)
    want = np.repeat(vc[:, 0, :].reshape(2, 2, 64), 7, axis=1)  # kv-major grouping of q heads
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    q, kc, vc = (torch.from_numpy(a) for a in make_inputs(B=2, S=16))
    n = tda.launches
    got = tda.decode_attention(q, kc, vc, 7, 2)
    assert torch.equal(got, tda.decode_attention_plain(q, kc, vc, 7, 2))
    assert tda.launches == n
    assert got.dtype == q.dtype and got.shape == q.shape


@pytest.mark.parametrize(
    "bad",
    [
        dict(pos=16),  # beyond the cache
        dict(pos=-1),
        dict(kv=3),  # 14 heads do not split over 3 KV heads
        dict(vc_cols=64),  # cache width that does not fit kv_heads * hd
    ],
)
def test_wrapper_refuses_what_does_not_fit(bad):
    q, kc, vc = (torch.from_numpy(a) for a in make_inputs(B=2, S=16))
    if "vc_cols" in bad:
        vc = vc[..., : bad["vc_cols"]].contiguous()
    with pytest.raises(ValueError):
        tda.decode_attention(q, kc, vc, bad.get("pos", 3), bad.get("kv", 2))
