#!/usr/bin/env python3
"""The readings that a training cell's limits are set from, on the card at
the cell's own size: for each seed, the numbers that decide ``correct``
(``loss``, ``grad1``, ``change``; see ``compare.py``) of

- ``program``: the program as the stage sets it up (the lower readings);
- ``control``: the nearest lower precision in the program's place (the
  upper readings): the reference with every product's operands in float8;
- ``int8_base``: where the stage runs a bf16 base, the program's own int8
  weight path (weights stored in int8, the products still bf16): a reading
  beside the control, which reads as the program does (PERF.md);
- ``half_batch``: the program with half of the batch left out of the loss
  (``faults.half_batch``).

A state left unchanged reads 1 on ``grad1`` and ``change`` by their
definition and needs no run. All against the float32 reference over the
same first updates, in one process.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 ... [--faults 3] [--out FILE]

``--faults N`` runs the control and the fault on the first N seeds only.
Prints one JSON line a seed and variant.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark import compare, faults, harness, weights as wt  # noqa: E402
from benchmark.reference import train_lm  # noqa: E402


def program_readings(train, cell: dict, seed: int, device, quant="stage") -> dict:
    """The program's first updates of ``seed`` (its host readings)."""
    traffic = cell["traffic"]
    step, model, tx, leaves = train.build(cell, seed, device, quant)
    batches = train.ring(cell, seed, device)
    mask = torch.ones((traffic["micro_batch"], traffic["seq_len"]), dtype=torch.float32, device=device)
    out = train.to_host(train.first_updates(step, tx, leaves, batches, mask, traffic["check_updates"], traffic["accum"]))
    del step, model, tx, leaves
    train.free()
    return out


def reference_readings(train, cell: dict, seed: int, device, precision: str = "fp32") -> dict:
    traffic, config = cell["traffic"], cell["config"]
    dims = train.dims_of(config)
    K, accum = traffic["check_updates"], traffic["accum"]
    batches = train.ring(cell, seed, device)[: K * accum]
    mask = torch.ones((traffic["micro_batch"], traffic["seq_len"]), dtype=torch.float32, device=device)
    out = train_lm.follow(dims, train.reference_stage(config), wt.make(dims, seed, device), batches, mask, K, accum, precision)
    train.free()
    return out


def seed_readings(cell: dict, seed: int, device, with_faults: bool) -> dict:
    """variant → readings for one seed."""
    train = harness.driver(cell["traffic"])
    ref = reference_readings(train, cell, seed, device)
    out = {"program": compare.readings(program_readings(train, cell, seed, device), ref)}
    if with_faults:
        low = reference_readings(train, cell, seed, device, "fp8")
        out["control"] = compare.readings({"losses": low["losses"], "grad1": low["grads"][0], "change": low["change"]}, ref)
        if cell["config"]["stage"]["quant"] is None:
            out["int8_base"] = compare.readings(program_readings(train, cell, seed, device, quant="int8"), ref)
        with faults.half_batch():
            out["half_batch"] = compare.readings(program_readings(train, cell, seed, device), ref)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    harness.set_process()
    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    sink = open(args.out, "a") if args.out else None
    for n, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        for variant, values in seed_readings(cell, seed, "cuda", n < args.faults).items():
            line = json.dumps({"workload": args.workload, "seed": seed, "variant": variant, **values})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    if sink:
        sink.close()
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"loaded: {loaded}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
