"""The reduction from a torch.profiler trace to what the per-layer metrics
read: device operations classified by kernel name, the union of their
intervals (busy and idle time), and the longest idle gaps named by what the
host was doing.

The trace is kept in memory: :func:`from_profiler` copies the kineto events
into plain tuples, and everything else works on those, so the tests can hand
it a synthetic list.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

SPAN = "bench.traced"  # the host range around the traced updates

# kineto's device activities that occupy the card (user annotations on the
# device timeline mark ranges and are left out)
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")

# the port's hand-written kernels (``csrc/*.cu``), by the stem of their names
FA_PREFIX = "flash_"
CE_PREFIX = "fused_ce_"
HAND_PREFIXES = (FA_PREFIX, CE_PREFIX, "vmem_attn_", "decode_attn_", "viterbi_", "pitch_candidates", "frames_",
                 "chunk_cumsum", "mask_ema", "ctc_")
# products of cuBLAS, cuBLASLt and CUTLASS, by what their kernel names carry
GEMM_MARKERS = ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas", "splitkreduce")


@dataclass
class Trace:
    device: list = field(default_factory=list)  # (name, start_ns, end_ns)
    host: list = field(default_factory=list)  # (name, start_ns, end_ns, thread)
    span: tuple | None = None  # (start_ns, end_ns) of the SPAN range


def from_profiler(prof) -> Trace:
    """The device activities and host events of a finished
    ``torch.profiler.profile``, and the span of its SPAN range (without one,
    from the first device operation's start to the last one's end)."""
    from torch.autograd import DeviceType

    out = Trace()
    events = list(prof.profiler.kineto_results.events())
    # ranges of record_function (ours, and any the program opens) are mirrored
    # on the device timeline; they occupy nothing
    ranges = {SPAN} | {e.name() for e in events if e.device_type() == DeviceType.CPU and _annotation(e)}
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if e.name() == SPAN and out.span is None:
                out.span = (start, end)
            out.host.append((e.name(), start, end, e.start_thread_id()))
        elif _occupies(e, ranges):
            out.device.append((e.name(), start, end))
    if out.span is None and out.device:
        out.span = (min(s for _, s, _ in out.device), max(e for _, _, e in out.device))
    return out


def _annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag and flag())


def _occupies(e, ranges: set) -> bool:
    """A device event that takes the card: a kernel, a copy or a fill (by
    its activity type where the event has one), not a mirrored range."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_ACTIVITIES
    return not _annotation(e) and e.name() not in ranges


def stem(name: str) -> str:
    """A kernel's name without its return type, namespaces, template and
    arguments: ``void (anonymous namespace)::flash_fwd_bf16<...>(...)`` →
    ``flash_fwd_bf16``."""
    s = name.strip().replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    s = re.split(r"[<(]", s, maxsplit=1)[0]
    return s.rsplit("::", 1)[-1].strip()


def classify(name: str) -> str:
    """``fa`` (the flash attention's kernels), ``ce`` (kernel H's), ``hand``
    (another of the port's kernels), ``gemm`` (a library product) or
    ``other`` (everything else: elementwise, reductions, copies)."""
    s = stem(name)
    if s.startswith(FA_PREFIX):
        return "fa"
    if s.startswith(CE_PREFIX):
        return "ce"
    if s.startswith(HAND_PREFIXES):
        return "hand"
    low = name.lower()
    if any(m in low for m in GEMM_MARKERS):
        return "gemm"
    return "other"


def in_span(trace: Trace) -> list:
    """Device operations that start inside the span, clipped to it."""
    lo, hi = trace.span
    return [(n, max(s, lo), min(e, hi)) for n, s, e in trace.device if lo <= s < hi]


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(trace: Trace) -> int:
    """Nanoseconds of the span in which some device operation runs."""
    return sum(e - s for s, e in merged((s, e) for _, s, e in in_span(trace)))


def gaps(trace: Trace) -> list:
    """(start, end) of every stretch of the span in which nothing runs on
    the device, the leading and trailing ones included."""
    lo, hi = trace.span
    out, t = [], lo
    for s, e in merged((s, e) for _, s, e in in_span(trace)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def time_by_class(trace: Trace) -> dict:
    """Device nanoseconds in the span summed by :func:`classify`'s class
    (a sum of durations, so operations that overlap count each)."""
    out = {}
    for n, s, e in in_span(trace):
        c = classify(n)
        out[c] = out.get(c, 0) + (e - s)
    return out


def count(trace: Trace) -> int:
    """Device operations that start in the span."""
    return len(in_span(trace))


def host_at(trace: Trace, t: int) -> str:
    """The innermost host event, on any thread (the backward runs on
    autograd's own), that runs at ``t``, or ``host idle``."""
    best = None
    for n, s, e, _ in trace.host:
        if s <= t < e and (best is None or e - s < best[1]):
            best = (n, e - s)
    return best[0] if best else "host idle"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (by stem, seconds) and the
    longest idle gaps between them (seconds), each named by the host event
    that ran at the gap's start."""
    by = {}
    for n, s, e in in_span(trace):
        k = stem(n)
        by[k] = by.get(k, 0) + (e - s)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    # between device operations: the stretches before the first and after the
    # last are the synchronisations that bracket the span
    inner = [g for g in gaps(trace) if g[0] != trace.span[0] and g[1] != trace.span[1]]
    longest = sorted(inner, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[k, v / 1e9] for k, v in ops],
            "idle_gaps": [[host_at(trace, s), (e - s) / 1e9] for s, e in longest]}
