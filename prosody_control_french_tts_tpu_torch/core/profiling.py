"""Phase timing inside a pipeline step: which part of a step is slow (host
prepare, device work, post-processing). Always on: one perf_counter pair per
phase, accumulated in ``PHASES``."""

from __future__ import annotations

import contextlib
import time

PHASES: dict[str, float] = {}


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASES[name] = PHASES.get(name, 0.0) + time.perf_counter() - t0


def reset_phases() -> None:
    PHASES.clear()
