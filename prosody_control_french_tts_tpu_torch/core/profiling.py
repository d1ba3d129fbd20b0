"""Step and phase timing of the pipeline.

- ``StepTimer``: wall-clock seconds per pipeline step, dumped as JSON lines
  beside the run's results (``step_timings.jsonl``).
- ``phase``: which part of a step is slow (host prepare, device work,
  post-processing). Always on: one perf_counter pair per phase, accumulated
  in ``PHASES``.
- ``device_trace``: a ``torch.profiler`` trace of the host and the card
  around a block, written as a Chrome trace into a directory.
- ``span`` and ``backward_spans``: named ranges inside the training path
  (``train.step``, ``llm.layer.forward`` / ``recompute`` / ``backward``,
  ``quant.dequant``, ``train.optimizer``) that a profiler records. Off by
  default, when each site costs one branch; ``spans()`` switches them on
  around a block, and ``device_trace`` does so for its own.

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

import torch

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


_SPANS = False
_OFF = contextlib.nullcontext()


def spans_enabled() -> bool:
    return _SPANS


@contextlib.contextmanager
def spans(on: bool = True):
    """Switch the program's spans on (or off) for the block, for every
    thread: the autograd engine's threads open spans of the backward."""
    global _SPANS
    was, _SPANS = _SPANS, on
    try:
        yield
    finally:
        _SPANS = was


def span(name: str, args=None):
    """A profiler range ``name`` while spans are on, ``args`` (which
    instance: a layer's index, a micro-step's) as its string; otherwise one
    shared null context, so an instrumented site costs a branch."""
    if not _SPANS:
        return _OFF
    return _Span(name, args)


def _unseen(op, *args):
    """``op(*args)`` out of every dispatch mode's sight and with no
    ``__torch_function__`` handling (which would triple a span's cost). A
    selective checkpoint's mode numbers every operator of a layer's forward
    and expects the same ones in its recompute; a span is no operator of the
    computation, and the recompute opens one the forward does not."""
    with torch._C.DisableTorchFunctionSubclass(), torch._C._DisableTorchDispatch():
        return op(*args)


class _Span:
    """One ``record_function`` range, opened and closed by the profiler's
    own operators: in a ``with`` block, or across autograd's calls
    (:func:`backward_spans`)."""

    __slots__ = ("name", "args", "handle")

    def __init__(self, name: str, args):
        self.name, self.args, self.handle = name, None if args is None else str(args), None

    def open(self) -> None:
        self.handle = _unseen(torch.ops.profiler._record_function_enter_new.default, self.name, self.args)

    def close(self) -> None:
        if self.handle is not None:
            _unseen(torch.ops.profiler._record_function_exit._RecordFunction, self.handle)
            self.handle = None

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _BackwardSpans:
    """The spans ``name`` over the backward of a chain of blocks, each
    marked at its input (``x = mark(x, i)`` before block ``i``) and the
    last at its output (``mark(x)``). One gradient hook a boundary: once the
    boundary's gradient is whole, the block after it is done, so the hook
    closes that block's span and opens the span of the block before it. The
    span still open when the backward pass ends is closed then: the first
    block's input takes no gradient where the embedding is frozen."""

    __slots__ = ("name", "last", "span")

    def __init__(self, name: str):
        self.name, self.last, self.span = name, None, None

    def __call__(self, x, index=None):
        made_by, self.last = self.last, index
        if x.requires_grad:
            x.register_hook(lambda g: self._turn(made_by))
        return x

    def _turn(self, made_by) -> None:
        if self.span is None:  # the pass's first turn
            torch.autograd.Variable._execution_engine.queue_callback(self._close)
        self._close()
        if made_by is not None:
            self.span = _Span(self.name, made_by)
            self.span.open()

    def _close(self) -> None:
        if self.span is not None:
            self.span.close()
            self.span = None


def backward_spans(name: str):
    """The marker of a chain of blocks whose backward is to be the spans
    ``name``, one a block, its index their args (:class:`_BackwardSpans`).
    While spans are off it returns its input and the graph has no hook."""
    if not _SPANS or not torch.is_grad_enabled():
        return _identity
    return _BackwardSpans(name)


def _identity(x, index=None):
    return x


@contextlib.contextmanager
def device_trace(trace_dir: str | Path, enabled: bool = True):
    """``torch.profiler`` over the block (CPU activity, and CUDA activity
    where a card is present), exported on exit as
    ``trace_dir/trace_<pid>_<n>.json`` (Chrome trace format), with the
    program's spans switched on for the block. Yields the profiler (None
    when disabled), whose ``key_averages()`` sum the kernels by name."""
    if not enabled:
        yield None
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof, spans():
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = out / f"trace_{os.getpid()}_{len(list(out.glob('trace_*.json')))}.json"
    prof.export_chrome_trace(str(path))
    log.info("device trace written to %s", path)
