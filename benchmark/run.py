#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks for.
The cell, its configuration, its traffic (which names its driver under
``drivers/``), its limits and its per-layer metrics' readers are found by
name from ``BENCHMARK.json``. Prints notes and each compared number beside
its limit on standard error, then one JSON line on standard output:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and ``checks`` last. Exits 2 without a result
when the cards are missing, 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    harness.set_process()
    cell = harness.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    out = harness.driver(cell["traffic"]).run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"loaded in this process, which the port may not load: {loaded}", file=sys.stderr)
        return 3
    checks = out["checks"]
    for line in out["notes"]:
        print(line, file=sys.stderr)
    for line in harness.check_lines(checks):
        print(line, file=sys.stderr)
    result = {"correct": harness.is_correct(checks), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"], "device": out["device"]}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
