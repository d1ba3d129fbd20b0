"""Step and phase timing of the pipeline.

- ``StepTimer``: wall-clock seconds per pipeline step, dumped as JSON lines
  beside the run's results (``step_timings.jsonl``).
- ``phase``: which part of a step is slow (host prepare, device work,
  post-processing). Always on: one perf_counter pair per phase, accumulated
  in ``PHASES``.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path


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
