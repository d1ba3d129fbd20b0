"""Micro-batching executor for batched inference.

Inference throughput on the card comes from batch size; serving traffic
arrives one request at a time. The batcher collects concurrent requests for
up to ``max_wait_ms`` (or until ``max_batch``), runs ONE forward over the
padded batch, and hands each request its row of the result — the standard
production pattern the reference lacks (its serving story is per-request
Ollama HTTP calls, fewshot/model.py:603).

Three faults of the JAX package's batcher are not copied: ``close()`` waits
for the flushes in flight with a bounded timeout (not forever), a flush
gives its permit back only after its stats are recorded and its requests
are woken, and the docstring of ``MicroBatcher`` says that ``batch_fn`` runs
on several threads at once.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class _Pending:
    item: object
    event: threading.Event = field(default_factory=threading.Event)
    result: object = None
    error: Exception | None = None
    t_submit: float = 0.0


@dataclass
class BatcherStats:
    """Per-flush instrumentation: where a request's latency goes (queued
    waiting for a flush slot vs inside batch_fn) and how full the batches
    run."""

    batch_sizes: list = field(default_factory=list)
    compute_s: list = field(default_factory=list)  # batch_fn wall per flush
    queue_s: list = field(default_factory=list)  # submit→flush-start, per request
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record(self, batch_size: int, compute_s: float, queue_s: list) -> None:
        with self._lock:
            self.batch_sizes.append(batch_size)
            self.compute_s.append(compute_s)
            self.queue_s.extend(queue_s)

    def clear(self) -> None:
        with self._lock:
            self.batch_sizes.clear()
            self.compute_s.clear()
            self.queue_s.clear()

    def summary(self) -> dict:
        import numpy as np

        with self._lock:
            if not self.batch_sizes:
                return {}
            bs = np.asarray(self.batch_sizes)
            compute, queue = list(self.compute_s), list(self.queue_s)
        return {
            "flushes": int(len(bs)),
            "batch_fill_mean": round(float(bs.mean()), 2),
            "batch_fill_p50": int(np.percentile(bs, 50)),
            "batch_fill_max": int(bs.max()),
            "compute_ms_p50": round(1000 * float(np.percentile(compute, 50)), 2),
            "queue_ms_p50": round(1000 * float(np.percentile(queue, 50)), 2),
            "queue_ms_p99": round(1000 * float(np.percentile(queue, 99)), 2),
        }


class MicroBatcher:
    """Collects submitted items into batches for ``batch_fn(items) ->
    results`` (one result per item, in order).

    Each flush runs on a finisher thread of its own, and up to
    ``pipeline_depth`` flushes are in flight at once, so ``batch_fn`` runs
    on up to ``pipeline_depth`` threads concurrently and must be safe to
    call so: one flush's host work (tokenising, padding, the result's
    copy back) then overlaps the device work of another."""

    def __init__(
        self,
        batch_fn: Callable[[list], list],
        max_batch: int = 32,
        max_wait_ms: float = 5.0,
        pipeline_depth: int = 2,
    ):
        self.batch_fn = batch_fn
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._depth = max(1, pipeline_depth)
        self._inflight = threading.Semaphore(self._depth)
        self.stats = BatcherStats()
        self._queue: list[_Pending] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, item, timeout_s: float = 30.0):
        p = _Pending(item, t_submit=time.monotonic())
        with self._lock:
            if self._stop:
                raise RuntimeError("the batcher is closed")
            self._queue.append(p)
            self._wake.notify()
        if not p.event.wait(timeout_s):
            raise TimeoutError("batched inference timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def _run(self):
        while True:
            with self._lock:
                while not self._queue and not self._stop:
                    self._wake.wait(0.1)
                if self._stop:
                    return
                deadline = time.monotonic() + self.max_wait_ms / 1000.0
            # collect until max_batch or max_wait
            while True:
                with self._lock:
                    n = len(self._queue)
                if n >= self.max_batch or time.monotonic() >= deadline:
                    break
                time.sleep(0.0005)
            with self._lock:
                batch, self._queue = self._queue[: self.max_batch], self._queue[self.max_batch :]
            while not self._inflight.acquire(timeout=0.1):
                if self._stop:
                    self._fail(batch, RuntimeError("the batcher was closed before the batch ran"))
                    return
            threading.Thread(target=self._finish, args=(batch, time.monotonic()), daemon=True).start()

    @staticmethod
    def _fail(batch: list[_Pending], error: Exception) -> None:
        for p in batch:
            p.error = error
            p.event.set()

    def _finish(self, batch: list[_Pending], t_flush: float):
        try:
            try:
                results = self.batch_fn([p.item for p in batch])
                if len(results) != len(batch):
                    raise RuntimeError(f"batch_fn returned {len(results)} results for {len(batch)} items")
                for p, r in zip(batch, results):
                    p.result = r
            except Exception as e:  # noqa: BLE001 — every request of the flush gets the error
                for p in batch:
                    p.error = e
            self.stats.record(len(batch), time.monotonic() - t_flush, [t_flush - p.t_submit for p in batch])
            for p in batch:
                p.event.set()
        finally:
            self._inflight.release()

    def close(self, timeout_s: float = 5.0) -> bool:
        """Stop collecting, fail what is still queued, and wait up to
        ``timeout_s`` for the flushes in flight. Returns whether they all
        finished (a ``batch_fn`` that never returns keeps its daemon thread;
        the wait still ends)."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            self._stop = True
            queued, self._queue = self._queue, []
            self._wake.notify_all()
        self._fail(queued, RuntimeError("the batcher was closed before the batch ran"))
        self._worker.join(timeout=max(0.0, deadline - time.monotonic()))
        held = 0
        while held < self._depth and self._inflight.acquire(timeout=max(0.0, deadline - time.monotonic())):
            held += 1
        for _ in range(held):
            self._inflight.release()
        return held == self._depth and not self._worker.is_alive()
