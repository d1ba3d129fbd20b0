#!/usr/bin/env python3
"""The program's spans beside the card's activity: a traced stretch that
records only the program's own ranges (``core/profiling.span``: the train
step, each decoder layer's forward, recompute and backward, the NF4
dequant, the optimizer) with the device's activity, and the attribution of
each device operation to the span that launched it.

- :func:`recording` records such a stretch: ``torch.profiler``'s
  activities CPU and CUDA restricted to the user scope (``record_function``
  ranges, no operator), with the program's spans switched on for it alone,
  and reads the program's dequant counter before and after.
- :func:`from_result` copies the events into plain tuples, and
  :func:`attribute` works on those, so the tests can hand it a synthetic
  list: each kernel, copy or fill is joined to its runtime call (the
  ``cudaLaunchKernel`` that launched it) by correlation id, and the call to
  the innermost program span open on its thread at its start; where none
  is open there (the autograd thread launches the loss's and the final
  norm's backward outside every layer span, and kineto leaves the thread of
  some calls at 0), to the innermost span open on any thread: the main
  thread waits in ``train.step`` while autograd's runs the backward, so the
  two never run spans side by side. A span's self time is the device time
  of what it launched while innermost.
- :func:`context` is what the per-layer readers ``metrics/llm.*``,
  ``metrics/train.optimizer_ms``, ``metrics/quant.dequant_ms`` and
  ``metrics/nf4_dequant_roofline`` read, under ``ctx["spans"]``.
- :func:`notes` are the stretch's lines for a run's notes.

``tools/train_spans_probe.py`` records such a stretch in one cell on the
card.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

from benchmark import trace as tr

# the program's spans, as the port names them; torch's own ranges (AdamW's
# "Optimizer.step#AdamW.step") and the harness's are left out, so their
# kernels count to the program span around them
SPANS = ("train.step", "train.optimizer", "llm.layer.forward", "llm.layer.recompute", "llm.layer.backward", "quant.dequant")
UNATTRIBUTED = "(no span)"


@dataclass
class Stretch:
    spans: list = field(default_factory=list)  # (name, start_ns, end_ns, thread)
    calls: dict = field(default_factory=dict)  # correlation id -> (start_ns, thread) of a runtime call
    device: list = field(default_factory=list)  # (name, start_ns, end_ns, correlation id)


@contextlib.contextmanager
def recording(device):
    """Record the block with the program's spans on: yields a dict that
    holds, after the block, ``result`` (the profiler's result) and
    ``dequant_calls`` and ``dequant_bytes`` (the program's counters over the
    block)."""
    import torch
    from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
    from torch._C._profiler import ProfilerActivity, ProfilerConfig, ProfilerState, RecordScope, _ExperimentalConfig

    from prosody_control_french_tts_tpu_torch.core import profiling
    from prosody_control_french_tts_tpu_torch.models import quant

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False, _ExperimentalConfig())
    acts = {ProfilerActivity.CPU, ProfilerActivity.CUDA} if cuda else {ProfilerActivity.CPU}
    out = {}
    sync()
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    try:
        calls, nbytes = quant.dequant_calls, quant.dequant_bytes
        with profiling.spans():
            yield out
        sync()
        out["dequant_calls"], out["dequant_bytes"] = quant.dequant_calls - calls, quant.dequant_bytes - nbytes
    finally:
        out["result"] = _disable_profiler()


def from_result(result) -> Stretch:
    """The program's spans (:data:`SPANS`, user annotations on the host), the runtime
    calls and the device operations of a profiler result. A host event's
    thread is its system thread id (``device_resource_id``): kineto gives
    every runtime call the same ``start_thread_id``, whichever thread made
    it."""
    from torch.autograd import DeviceType

    out = Stretch()
    events = list(result.events())
    ranges = {e.name() for e in events if e.device_type() == DeviceType.CPU and tr._annotation(e)}
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if tr._annotation(e):
                if e.name() in SPANS:
                    out.spans.append((e.name(), start, end, e.device_resource_id()))
            elif e.correlation_id():
                out.calls[e.correlation_id()] = (start, e.device_resource_id())
        elif tr._occupies(e, ranges):
            out.device.append((e.name(), start, end, e.correlation_id()))
    return out


class _Innermost:
    """The innermost span open at a time on one thread, where spans nest:
    a step function built once, looked up by bisection."""

    def __init__(self, spans):
        self.at, self.name = [], []
        stack = []

        def close_until(t):
            while stack and stack[-1][1] <= t:
                end = stack.pop()[1]
                self._mark(end, stack[-1][0] if stack else None)

        for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
            close_until(s)
            stack.append((name, e))
            self._mark(s, name)
        close_until(float("inf"))

    def _mark(self, t, name):
        self.at.append(t)
        self.name.append(name)

    def __call__(self, t):
        i = bisect.bisect_right(self.at, t) - 1
        return self.name[i] if i >= 0 else None


def innermost_any(spans, t):
    """The shortest span open at ``t`` on any thread, or None."""
    best = None
    for name, s, e, _ in spans:
        if s <= t < e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else None


def attribute(st: Stretch, top: int = 10) -> dict:
    """Device ns by the span that launched each operation (self time), the
    operations no span claims (``UNATTRIBUTED``), their sum, how many
    launches were found on their own thread or by the fallback, and the
    ``top`` longest idle gaps between device operations, each named by the
    innermost span open at its start on any thread."""
    threads = {}
    for name, s, e, t in st.spans:
        threads.setdefault(t, []).append((name, s, e))
    inner = {t: _Innermost(sp) for t, sp in threads.items()}
    self_ns, how = {}, {"own_thread": 0, "any_thread": 0, "none": 0, "no_call": 0}
    for name, s, e, corr in st.device:
        call = st.calls.get(corr)
        if call is None:
            how["no_call"] += 1
            owner = innermost_any(st.spans, s)
        else:
            t0, thread = call
            owner = inner[thread](t0) if thread in inner else None
            if owner is not None:
                how["own_thread"] += 1
            else:
                owner = innermost_any(st.spans, t0)
                how["any_thread" if owner is not None else "none"] += 1
        key = owner if owner is not None else UNATTRIBUTED
        self_ns[key] = self_ns.get(key, 0) + (e - s)
    device_ns = sum(e - s for _, s, e, _ in st.device)
    unattributed = self_ns.pop(UNATTRIBUTED, 0)
    busy = tr.merged((s, e) for _, s, e, _ in st.device)
    gaps = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:])]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"self_ns": self_ns, "unattributed_ns": unattributed, "device_ns": device_ns, "launches": how,
            "gaps": [[innermost_any(st.spans, a) or "no span", (b - a) / 1e9] for a, b in longest]}


def context(st: Stretch, micro_steps: int, dequant_calls: int, dequant_bytes: int) -> dict:
    """What the spans stretch's readers and notes find under ``ctx["spans"]``."""
    return {**attribute(st), "micro_steps": micro_steps, "dequant_calls": dequant_calls, "dequant_bytes": dequant_bytes,
            "dequant_spans": sum(name == "quant.dequant" for name, *_ in st.spans)}


def self_ms(ctx: dict, name: str):
    """Device ms a micro-step that span ``name`` launched while innermost,
    or None where the context holds no spans stretch or the span launched
    nothing on the device."""
    sp = ctx.get("spans")
    ns = sp["self_ns"].get(name) if sp else None
    return ns / 1e6 / sp["micro_steps"] if ns else None


def notes(sp: dict) -> list:
    """The notes' lines: the unattributed share, the span classes' sum
    beside the device time, the counter's kernels dequantized (beside the
    ``quant.dequant`` spans recorded, which they match where every dequant
    opened its span) and bytes a micro-step, each class a micro-step, the
    longest gaps."""
    n, dev = sp["micro_steps"], sp["device_ns"]
    claimed = sum(sp["self_ns"].values())
    share = 100 * sp["unattributed_ns"] / dev if dev else 0.0
    lines = [f"spans: {share:.4f} % of {dev / 1e9:.6f} device s attributed to no program span; "
             f"the spans' self times sum to {claimed / 1e9:.6f} s (+ unattributed {sp['unattributed_ns'] / 1e9:.6f} s); "
             f"launches {sp['launches']}; dequant calls {sp['dequant_calls'] / n:g} ({sp['dequant_spans'] / n:g} spans), bytes {sp['dequant_bytes'] / n:.0f} a micro-step",
             "spans self ms a micro-step: " + ", ".join(f"{k} {v / 1e6 / n:.3f}" for k, v in sorted(sp["self_ns"].items()))]
    lines.append("spans stretch's longest gaps: " + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in sp["gaps"]))
    return lines
