"""Exact int16 ↔ float32 PCM conversion — the one scale convention.

int16 PCM decodes to float32 as ``x / 32768`` (``utils.wavio``). A corpus
that is an exact int16 image travels as int16 and is cast back on the
device; both directions must use exactly this pair, or results drift.
"""

from __future__ import annotations

import numpy as np
import torch

I16_SCALE = 32768.0


def i16_to_f32(a):
    """Unscale an int16 PCM image to float32 (numpy array or tensor — exact:
    every int16 value times 2⁻¹⁵ is representable in float32)."""
    if isinstance(a, np.ndarray):
        return a.astype(np.float32) * np.float32(1.0 / I16_SCALE)
    return a.to(torch.float32) * (1.0 / I16_SCALE)


def f32_to_i16_exact(x: np.ndarray) -> np.ndarray | None:
    """The int16 image of float32 ``x`` when the round trip through
    :func:`i16_to_f32` is bit-exact (wav-sourced audio decoded from int16
    PCM always is), else None. Full-scale negative samples (−32768 ↔ −1.0)
    are accepted. A strided probe fails fast on float audio."""
    if x.dtype != np.float32:
        return None
    probe = x.reshape(-1)[:: max(1, x.size // 4096)]
    if _quantise(probe) is None:
        return None
    return _quantise(x)


def _quantise(x: np.ndarray) -> np.ndarray | None:
    q = np.rint(x * I16_SCALE)
    if q.max(initial=0.0) > 32767.0 or q.min(initial=0.0) < -32768.0:
        return None
    qi = q.astype(np.int16)
    if np.array_equal(i16_to_f32(qi), x):
        return qi
    return None
