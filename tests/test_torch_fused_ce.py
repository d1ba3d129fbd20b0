"""Kernel H of the PyTorch port (fused LM-head + cross-entropy) against the
JAX package's Pallas kernel.

The same numpy-seeded inputs go through ``linear_ce_rows`` of the JAX package
in interpret mode (as ``tests/test_fused_kernels.py`` runs it off the TPU) and
through the port's wrapper, which on CPU tensors runs its plain version.
Float32; each comparison states its tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prosody_control_french_tts_tpu.ops.fused_ce import linear_ce_rows as j_rows, linear_ce_supported as j_supported
from prosody_control_french_tts_tpu_torch.ops import fused_ce

N, D, V = 300, 256, 1024


def inputs(seed=1, spread=1.0):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((N, D)) * 0.3 * spread).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.05 * spread).astype(np.float32)
    tgt = rng.integers(0, V, N).astype(np.int32)
    return h, w, tgt


@pytest.mark.parametrize("d,v", [(256, 1024), (64, 1024), (256, 1000), (3584, 152064), (896, 32768), (128, 512), (128, 640)])
def test_supported_gate_equals_jax(d, v):
    assert fused_ce.linear_ce_supported(d, v) == j_supported(d, v)


def test_rows_match_jax_kernel():
    """Within 1e-5."""
    h, w, tgt = inputs()
    want = np.asarray(j_rows(jnp.asarray(h), jnp.asarray(w), jnp.asarray(tgt), True))
    got = fused_ce.linear_ce_rows(*map(torch.from_numpy, (h, w, tgt)))
    assert got.shape == (N,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_extreme_logits_match_jax_kernel():
    """Logits scaled ×12 (magnitudes of hundreds): finite, within 1e-4."""
    h, w, tgt = inputs(seed=2, spread=12.0)
    want = np.asarray(j_rows(jnp.asarray(h), jnp.asarray(w), jnp.asarray(tgt), True))
    got = fused_ce.linear_ce_rows(*map(torch.from_numpy, (h, w, tgt))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_dh_matches_jax_kernel_under_a_row_mask():
    """dh of the masked mean, within 1e-5 of the largest element of the JAX
    backward kernel's; masked rows get exactly zero."""
    h, w, tgt = inputs(seed=4)
    mask = (np.random.default_rng(9).random(N) > 0.3).astype(np.float32)

    def loss(hh):
        r = j_rows(hh, jnp.asarray(w), jnp.asarray(tgt), True)
        return jnp.sum(r * mask) / jnp.sum(mask)

    want = np.asarray(jax.grad(jax.jit(loss))(jnp.asarray(h)))
    th = torch.from_numpy(h).requires_grad_(True)
    m = torch.from_numpy(mask)
    ((fused_ce.linear_ce_rows(th, torch.from_numpy(w), torch.from_numpy(tgt)) * m).sum() / m.sum()).backward()
    got = th.grad.numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert not got[mask == 0].any()


@pytest.mark.parametrize("n", [8, 100, 256])
def test_row_counts_that_fill_no_tile(n):
    """N = 8, 100, 256 (the JAX kernel pads them internally): shape [n], rows
    within 1e-5."""
    h, w, tgt = inputs(seed=6)
    want = np.asarray(j_rows(jnp.asarray(h[:n]), jnp.asarray(w), jnp.asarray(tgt[:n]), True))
    got = fused_ce.linear_ce_rows(torch.from_numpy(h[:n]), torch.from_numpy(w), torch.from_numpy(tgt[:n]))
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_what_it_does_not_take():
    h, w, tgt = map(torch.from_numpy, inputs())
    with pytest.raises(ValueError, match="frozen"):
        fused_ce.linear_ce_rows(h, w.clone().requires_grad_(True), tgt)
    with pytest.raises(ValueError, match="multiple"):
        fused_ce.linear_ce_rows(h, w[:, :1000], tgt)
    with pytest.raises(ValueError, match="do not fit"):
        fused_ce.linear_ce_rows(h, w, tgt[:-1])
    with pytest.raises(ValueError, match="no rows"):
        fused_ce.linear_ce_rows(h[:0], w, tgt[:0])
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ce.linear_ce_rows(torch.empty((8, 128), device="meta"), torch.empty((128, 512), device="meta"), torch.empty((8,), device="meta", dtype=torch.int32))
    assert fused_ce.launches == 0 and fused_ce.launches_bwd == 0  # no card here: the kernel never ran
