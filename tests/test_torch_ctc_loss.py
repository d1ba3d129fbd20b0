"""The port's CTC loss (``ops/ctc_loss.py``, plain version) against the JAX
package's ``align/ctc.py:ctc_loss`` and ``jax.grad`` of it, on the same
numpy inputs.

Tolerances: the two evaluate the same float32 recursion (``logaddexp`` as
``max + log1p(exp(-|d|))``, the same where-masks) with exp and log1p from
different libraries and the gradient's column sums in another order, so the
loss is held to 1e-5 relative. The gradient's entries are at most 1 in size
on feasible inputs, but each is a product of weights exp(α − lae) whose
arguments carry the rounding of α, which grows with |α| (about the loss):
it is held to 1e-5 · max(1, loss / 100) absolute (1.6e-5 measured at a loss
of 1,300). On an infeasible alignment the loss is about 1e30 on both sides
and the gradient (path counts through the NEG sentinel) is held to 1e-5 of
its largest entry. ``F.ctc_loss`` (the α·β form, its own float32 sums) is
held to 1e-4 on the logits' gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from prosody_control_french_tts_tpu.align.ctc import ctc_loss as jax_ctc_loss
from prosody_control_french_tts_tpu_torch.align.ctc import ctc_loss as port_align_ctc_loss
from prosody_control_french_tts_tpu_torch.ops.ctc_loss import ctc_loss, ctc_loss_plain


def _inputs(T, V, L, seed, labels=None, scale=3.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, V)).astype(np.float32) * scale
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    lab = np.asarray(labels, np.int32) if labels is not None else rng.integers(1, V, L).astype(np.int32)
    return lp, lab


def _jax(lp, labels, input_len, label_len):
    loss, grad = jax.value_and_grad(jax_ctc_loss)(jnp.asarray(lp), jnp.asarray(labels), jnp.int32(input_len),
                                                  jnp.int32(label_len))
    return float(loss), np.asarray(grad)


def _port(lp, labels, input_len, label_len):
    t = torch.from_numpy(lp).requires_grad_(True)
    loss = ctc_loss(t, torch.from_numpy(labels), input_len, label_len)
    loss.backward()
    return float(loss.detach()), t.grad.numpy()


def _check(lp, labels, input_len, label_len):
    jl, jg = _jax(lp, labels, input_len, label_len)
    tl, tg = _port(lp, labels, input_len, label_len)
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    tol = 1e-5 * max(1.0, np.abs(jg).max()) if jl > 1e29 else 1e-5 * max(1.0, abs(jl) / 100.0)
    assert np.abs(tg - jg).max() <= tol
    return jl, jg, tg


@pytest.mark.parametrize("T,V,L,seed", [(20, 6, 4, 0), (50, 10, 8, 1), (120, 47, 30, 2), (300, 47, 90, 3)])
def test_random_feasible_inputs(T, V, L, seed):
    lp, labels = _inputs(T, V, L, seed)
    _, jg, _ = _check(lp, labels, T, L)
    # -gamma: each frame's row sums to -1
    assert np.allclose(jg.sum(-1), -1.0, atol=1e-3)


@pytest.mark.parametrize("input_len,label_len", [(40, 8), (31, 5), (1, 1), (2, 1)])
def test_padded_lengths(input_len, label_len):
    lp, labels = _inputs(50, 10, 8, 7)
    _, jg, tg = _check(lp, labels, input_len, label_len)
    # frames from input_len on are frozen: no gradient there
    assert np.all(tg[max(input_len, 1):] == 0.0) and np.all(jg[max(input_len, 1):] == 0.0)


@pytest.mark.parametrize("labels", [[1, 1, 2, 2, 1, 1], [3, 3, 3, 3], [1, 2, 1, 2, 1]])
def test_repeated_labels(labels):
    lp, lab = _inputs(30, 5, len(labels), 11, labels=labels)
    _check(lp, lab, 30, len(labels))


def test_label_len_zero_adds_log2():
    lp, labels = _inputs(30, 6, 4, 12)
    jl, _, _ = _check(lp, labels, 30, 0)
    # the one end state is added to itself: -(sum of blank log-probs) - log 2
    assert jl == pytest.approx(-float(lp[:, 0].sum()) - np.log(2.0), rel=1e-5)


@pytest.mark.parametrize("T,L,labels", [(10, 15, None), (12, 8, [1] * 8), (4, 3, [2, 2, 2])])
def test_infeasible_alignment(T, L, labels):
    lp, lab = _inputs(T, 10, L, 13, labels=labels)
    jl, jg, tg = _check(lp, lab, T, L)
    assert jl > 1e29
    assert np.abs(jg).max() > 1.0  # the sentinel's path counts, not -gamma


def test_loss_decreases_on_matching():
    """The JAX suite's case: frames that emit the labels give a lower loss
    than frames that emit the blank."""
    T, V = 20, 5
    labels = np.array([1, 2, 3], np.int32)
    good = np.full((T, V), -10.0, np.float32)
    for t in range(T):
        good[t, [1, 2, 3][min(t * 3 // T, 2)]] = 0.0
    bad = np.full((T, V), -10.0, np.float32)
    bad[:, 0] = 0.0
    lg, _, _ = _check(good, labels, T, 3)
    lb, _, _ = _check(bad, labels, T, 3)
    assert lg < lb


def test_align_module_exports_the_loss():
    assert port_align_ctc_loss is ctc_loss


@pytest.mark.parametrize("T,V,L,input_len,seed", [(60, 12, 10, 60, 20), (80, 47, 25, 70, 21)])
def test_logits_gradient_agrees_with_torch_ctc_loss(T, V, L, input_len, seed):
    """F.ctc_loss's own gradient with respect to log_probs is exp(lp) − γ
    (rows sum to 0); through the log-softmax both give the same logits
    gradient on feasible inputs."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, V)).astype(np.float32) * 2.0
    labels = rng.integers(1, V, L)
    a = torch.from_numpy(logits).requires_grad_(True)
    ctc_loss(torch.log_softmax(a, -1), torch.from_numpy(labels), input_len, L).backward()
    b = torch.from_numpy(logits).requires_grad_(True)
    lp = torch.log_softmax(b, -1)[:, None, :]
    ref = F.ctc_loss(lp, torch.from_numpy(labels)[None], torch.tensor([input_len]), torch.tensor([L]), blank=0,
                     reduction="sum")
    ref.backward()
    assert float((a.grad - b.grad).abs().max()) <= 1e-4
    lp_plain = torch.log_softmax(torch.from_numpy(logits), -1)
    assert float(ctc_loss_plain(lp_plain, torch.from_numpy(labels), input_len, L)) == pytest.approx(float(ref), rel=1e-5)


def test_refusals():
    lp, labels = _inputs(10, 5, 3, 0)
    with pytest.raises(ValueError, match="outside"):
        ctc_loss(torch.from_numpy(lp), torch.from_numpy(labels), 10, 4)
    with pytest.raises(ValueError, match="at least one"):
        ctc_loss(torch.from_numpy(lp), torch.zeros(0, dtype=torch.int64), 10, 0)
    with pytest.raises(TypeError):
        ctc_loss(torch.from_numpy(lp).double(), torch.from_numpy(labels), 10, 3)
