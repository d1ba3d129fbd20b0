#!/usr/bin/env python3
"""One training cell of the benchmark with the program's spans recorded
(``benchmark/spans.py``), and what recording them costs.

    python3 tools/train_spans_probe.py --workload <name> --seed <n> [--seconds 8] [--rounds 2]

Run from the root of a checkout on a machine with an NVIDIA H100. It makes
the cell's set-up as a run of ``benchmark/run.py`` does, its window with the
two traced stretches of a ``--trace 1`` run (``benchmark/drivers/train.py``),
then the spans stretch: ``trace_updates`` updates recorded in the profiler's
user scope beside the card's activity, with the dequant counters read
around them. Then ``--rounds`` turns of the plain, card-only and spans
stretches, each timed between synchronisations (the wall of an update),
with the garbage collector's pauses inside each. The readers' values of the
six span metrics (``benchmark/metrics/``), the notes and the NF4 kernel's
launches a micro-step beside the dequant calls go to standard error, one
JSON line to standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness, spans  # noqa: E402
from benchmark import trace as tr  # noqa: E402

METRICS = ("llm.layer_forward_ms", "llm.layer_recompute_ms", "llm.layer_backward_ms", "train.optimizer_ms",
           "quant.dequant_ms", "nf4_dequant_roofline")


def updates(step, batches, mask, start: int, n: int, accum: int) -> int:
    count = batches.shape[0]
    for k in range(n * accum):
        step(batches[(start + k) % count], mask)
    return start + n * accum


@contextlib.contextmanager
def gc_pauses():
    """Yields a list that holds, after the block, the seconds of each pause
    of Python's garbage collector inside it."""
    out, began = [], [0.0]

    def clock(phase, info):
        if phase == "start":
            began[0] = time.perf_counter()
        else:
            out.append(time.perf_counter() - began[0])

    gc.callbacks.append(clock)
    try:
        yield out
    finally:
        gc.callbacks.remove(clock)


def probe(cell: dict, seed: int, seconds: float, rounds: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from prosody_control_french_tts_tpu_torch.ops import kernels, nf4_dequant

    drv = harness.driver(cell["traffic"])
    kernels.library()
    t = cell["traffic"]
    accum, K, U = t["accum"], t["check_updates"], t["trace_updates"]
    step = drv.build(cell, seed, "cuda")[0]
    batches = drv.ring(cell, seed, "cuda")
    mask = torch.ones((t["micro_batch"], t["seq_len"]), dtype=torch.float32, device="cuda")
    i = updates(step, batches, mask, 0, K, accum)
    _, _, micro, profs = drv.window(step, batches, mask, i, seconds, accum, "cuda", U)
    i += micro
    seven, busy, breakdown = drv.per_layer(cell, profs, U * accum)
    del profs

    def timed(around):
        """(what ``around`` yields, the wall of an update, the collector's
        pauses as (sum, longest)) over U updates inside ``around``."""
        nonlocal i
        with around as got, gc_pauses() as paused:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            i = updates(step, batches, mask, i, U, accum)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / U
        return got, wall, (sum(paused), max(paused, default=0.0))

    @contextlib.contextmanager
    def card_only():
        with profile(activities=[ProfilerActivity.CUDA]), record_function(tr.SPAN):
            yield

    launched = nf4_dequant.launches
    rec, _, paused = timed(spans.recording("cuda"))
    launched = nf4_dequant.launches - launched
    sp = spans.context(spans.from_result(rec["result"]), U * accum, rec["dequant_calls"], rec["dequant_bytes"])
    sp["nf4_dequant_launches"] = launched
    new = {m: v for m in METRICS if (v := harness.reader(m)({"spans": sp})) is not None}
    sp["gc_pauses_s"] = paused
    del rec
    kinds = {"plain": contextlib.nullcontext, "card_only": card_only, "spans": lambda: spans.recording("cuda")}
    walls, gc_s = {k: [] for k in kinds}, {k: [] for k in kinds}
    for _ in range(rounds):
        for kind, around in kinds.items():
            _, wall, paused = timed(around())
            walls[kind].append(wall)
            gc_s[kind].append(paused)
    return {"workload": cell["name"], "seed": seed, "card": harness.power_limit(), "seven": {k: v["value"] for k, v in seven.items()},
            "busy": busy, "breakdown": breakdown, "new": new, "spans": sp, "walls": walls, "gc_pauses_s": gc_s,
            "micro_steps_per_update": accum, "memory_peak_bytes": torch.cuda.max_memory_allocated()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rounds", type=int, default=2, help="turns of the plain, card-only and spans stretches")
    args = ap.parse_args()
    harness.set_process()
    cell = harness.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    out = probe(cell, args.seed, args.seconds, args.rounds)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"loaded in this process, which the port may not load: {loaded}", file=sys.stderr)
        return 3
    sp = out["spans"]
    for line in spans.notes(sp):
        print(line, file=sys.stderr)
    n = sp["micro_steps"]
    print(f"ops.nf4_dequant.launches {sp['nf4_dequant_launches'] / n:g} a micro-step beside quant.dequant_calls "
          f"{sp['dequant_calls'] / n:g} (equal where every CUDA call took the kernel)", file=sys.stderr)
    for key in ("seven", "busy", "new", "walls", "gc_pauses_s"):
        print(f"{key}: {json.dumps(out[key])}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
