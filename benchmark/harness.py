"""What every cell's run shares: finding the cell, its configuration, its
traffic, its limits and its metric readers by name; the caches kept inside
the checkout; the card's description; the import check; the result line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE_DIR = ROOT / "build" / "bench_cache"  # fixed, inside the checkout (``build/`` is ignored by git)

# whole top-level module names that may not be loaded in a run: JAX, and the
# JAX package that the port (whose name begins with it) was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "prosody_control_french_tts_tpu")


def set_process() -> None:
    """Kernel and extension caches at fixed paths inside the checkout, so
    that only a checkout's first run builds; JAX kept out of libraries that
    would load it on their own; one host thread for CPU operators (the step
    runs none of weight; idle pool threads would only contend with the
    threads that dispatch to the card)."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, bench_json: Path | None = None) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration (the
    file its entry names), its traffic (``traffic/<traffic>.json``), its
    limits (``cells/<name>.json``) and the metrics it reports."""
    spec = load_json(bench_json or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    entry = configs[cell["config"]]
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")

    def reports(m):
        return name in m.get("workloads", [name])

    return {
        "name": name,
        "chips": cell["chips"],
        "config": load_json(ROOT / entry["file"]),
        "traffic": traffic,
        "limits": load_json(BENCH_DIR / "cells" / f"{name}.json")["limits"],
        "end_to_end": [m for m in spec["end_to_end"] if reports(m)],
        "per_layer": [m for m in spec["per_layer"] if reports(m)],
    }


def driver(traffic: dict):
    """The module ``drivers/<traffic["driver"]>.py``."""
    return _load(BENCH_DIR / "drivers" / f"{traffic['driver']}.py", "bench_driver_" + traffic["driver"])


def reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``'s ``read``."""
    return _load(BENCH_DIR / "metrics" / f"{metric}.py", "bench_metric_" + metric.replace(".", "_")).read


def _load(path: Path, module_name: str):
    if not path.is_file():
        raise SystemExit(f"{path.relative_to(ROOT)} is missing")
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded(modules=None) -> list:
    """The loaded modules whose top-level name (the part before the first
    dot) is one of :data:`FORBIDDEN_MODULES`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN_MODULES)


def card(count: int) -> dict:
    """The ``device`` entry of the result: platform, the card's name, the
    cards used and the peak memory of the fullest."""
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(count))}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.strip().splitlines()[0]


def is_correct(checks: list) -> bool:
    """Every compared number within its limit."""
    return all(c["value"] <= c["limit"] for c in checks)


def check_lines(checks: list) -> list:
    """``name value <= limit`` for each compared number."""
    return [f"check {c['name']} {c['value']!r} <= {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAILED'}" for c in checks]
