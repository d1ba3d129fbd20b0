"""Faults planted in the program underneath an otherwise whole run, to show
that the comparison which decides ``correct`` catches them, and the control
that stands for the nearest lower precision. Used by ``calibrate.py`` on the
card and by the tests on the CPU; no benchmark run plants them.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def unchanged_state():
    """The optimizer's step returns the state as it found it: the gradients
    are dropped and no leaf moves."""
    from prosody_control_french_tts_tpu_torch.models import training

    def step(self, before_update=None):
        for p in self.params:
            p.grad = None

    kept, training.AccumAdamW.step = training.AccumAdamW.step, step
    try:
        yield
    finally:
        training.AccumAdamW.step = kept


@contextlib.contextmanager
def half_batch():
    """The loss leaves out the second half of the batch's rows, and the mean
    is taken over the rest."""
    from prosody_control_french_tts_tpu_torch.models import training

    fused, dense = training.causal_lm_loss_fused, training.causal_lm_loss
    training.causal_lm_loss_fused = lambda hidden, head, ids, mask, shards=None: fused(hidden, head, ids, _halve(mask), shards)
    training.causal_lm_loss = lambda logits, ids, mask, shards=None: dense(logits, ids, _halve(mask), shards)
    try:
        yield
    finally:
        training.causal_lm_loss_fused, training.causal_lm_loss = fused, dense


def _halve(mask: torch.Tensor) -> torch.Tensor:
    out = mask.clone()
    out[out.shape[0] // 2 :] = 0
    return out
