"""Step and phase timing of the pipeline.

- ``StepTimer``: wall-clock seconds per pipeline step, dumped as JSON lines
  beside the run's results (``step_timings.jsonl``).
- ``phase``: which part of a step is slow (host prepare, device work,
  post-processing). Always on: one perf_counter pair per phase, accumulated
  in ``PHASES``.
- ``device_trace``: a ``torch.profiler`` trace of the host and the card
  around a block, written as a Chrome trace into a directory.

The JAX package's ``enable_compile_cache`` (XLA's persistent compile cache)
has no counterpart: nothing here is compiled per shape, and the CUDA kernels
are built once per source hash into ``build/torch_kernels/``
(``ops.kernels.build``).
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path

log = logging.getLogger(__name__)


@dataclass
class StepTimer:
    records: list[dict] = field(default_factory=list)

    @contextlib.contextmanager
    def step(self, name: str, **meta):
        t0 = time.perf_counter()
        err = None
        try:
            yield
        except Exception as e:  # noqa: BLE001 — recorded then re-raised
            err = repr(e)
            raise
        finally:
            self.records.append({"step": name, "seconds": round(time.perf_counter() - t0, 4), "error": err, **meta})

    def dump(self, path: str | Path) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "w", encoding="utf-8") as f:
            for r in self.records:
                f.write(json.dumps(r) + "\n")

    def total_seconds(self) -> float:
        return sum(r["seconds"] for r in self.records)


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


@contextlib.contextmanager
def device_trace(trace_dir: str | Path, enabled: bool = True):
    """``torch.profiler`` over the block (CPU activity, and CUDA activity
    where a card is present), exported on exit as
    ``trace_dir/trace_<pid>_<n>.json`` (Chrome trace format). Yields the
    profiler (None when disabled), whose ``key_averages()`` sum the kernels
    by name."""
    if not enabled:
        yield None
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = out / f"trace_{os.getpid()}_{len(list(out.glob('trace_*.json')))}.json"
    prof.export_chrome_trace(str(path))
    log.info("device trace written to %s", path)
