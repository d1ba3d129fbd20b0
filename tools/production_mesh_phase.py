#!/usr/bin/env python3
"""The production data mesh on every card of one host: the measure pass
with its segment rows split over all visible cards
(``parallel.mesh.production_data_mesh`` under ``PCFT_DATA_MESH=<cards>``)
against the same pass on one card (the default), on synthetic voices of 10 segments of
8–23 s (``utils/synth.py``). ``run_measure_device`` on one voice and
``measure_voices_batched`` on two must give the same
outputs either way, bit-equal or else within F0 1e-3 relative and LUFS
0.01 dB (the rows' adjustments within 0.1 percentage point; printed);
kernels A and B must launch once per card and measure group.
Both ways are timed warm, in turns.

    python3 tools/production_mesh_phase.py [--seed 0]

Run from the root of a checkout on a host with NVIDIA H100 cards (two or
more for a split; one card runs both ways on that card). Prints each card's
name and power limit, the phase's lines, then its results as one JSON line.
Exits non-zero on any disagreement.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SEGMENTS = 10


def disagreement(a, b) -> dict:
    """Largest differences of the six measure outputs (p_syn, p_seg: Hz,
    relative; the four LUFS outputs: dB)."""
    import numpy as np

    out = {"f0_rel": 0.0, "lufs_db": 0.0}
    for k, (x, y) in enumerate(zip(a, b)):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        if k < 2:
            out["f0_rel"] = max(out["f0_rel"], float((np.abs(x - y) / np.maximum(np.abs(y), 1e-6)).max(initial=0.0)))
        else:
            out["lufs_db"] = max(out["lufs_db"], float(np.abs(x - y).max(initial=0.0)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("production_mesh_phase: torch.cuda.is_available() is False — this needs a CUDA card", file=sys.stderr)
        return 2
    from prosody_control_french_tts_tpu_torch.ops import candidates, kernels, viterbi
    from prosody_control_french_tts_tpu_torch.ops.pitch import PitchParams
    from prosody_control_french_tts_tpu_torch.parallel.mesh import production_data_mesh
    from prosody_control_french_tts_tpu_torch.prosody.adjust import ProsodySettings
    from prosody_control_french_tts_tpu_torch.prosody.measure import measure_voices_batched, prepare_voice, run_measure_device
    from prosody_control_french_tts_tpu_torch.utils.synth import synth_voice

    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    card = "; ".join(c.strip() for c in cards)
    print(card, flush=True)
    n_cards = torch.cuda.device_count()
    kernels.library()
    settings, pp = ProsodySettings(), PitchParams()
    with tempfile.TemporaryDirectory() as tmp:
        preps = {f"v{i}": prepare_voice(*synth_voice(Path(tmp) / f"v{i}", seed=args.seed + i, n_segments=SEGMENTS), settings)
                 for i in range(2)}

    def under(env):
        os.environ["PCFT_DATA_MESH"] = env

    def run(env, fn):
        under(env)
        candidates.launches = viterbi.launches = 0
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, (candidates.launches, viterbi.launches)

    one = lambda: run_measure_device(preps["v0"], pp, "cuda")  # noqa: E731
    batched = lambda: measure_voices_batched(preps, settings, pp, "cuda")  # noqa: E731
    os.environ.pop("PCFT_DATA_MESH", None)
    if production_data_mesh("cuda") is not None:
        raise SystemExit("production mesh: the mesh is on without PCFT_DATA_MESH")
    every = str(n_cards)
    under(every)
    slots = production_data_mesh("cuda")
    n_slots = len(slots) if slots else 1
    print(f"production mesh: {n_cards} cards visible; PCFT_DATA_MESH={every} slots {slots}")
    for env in ("1", every):  # warm both ways: kernels loaded on every card
        run(env, one)
        run(env, batched)
    times = {"one card": {"run_measure_device": [], "measure_voices_batched": []},
             "all cards": {"run_measure_device": [], "measure_voices_batched": []}}
    n_groups = len({(p.nat.shape[1], int(p.rate)) for p in preps.values()})
    results = {}
    for env in ("1", every, every, "1"):
        label = "one card" if env == "1" else "all cards"
        for name, fn, groups in (("run_measure_device", one, 1), ("measure_voices_batched", batched, n_groups)):
            out, s, launches = run(env, fn)
            times[label][name].append(s)
            want = (groups, groups) if env == "1" else (groups * n_slots, groups * n_slots)
            if launches != want:
                raise SystemExit(f"production mesh {label} {name}: A, B launched {launches}, expected {want}")
            results[(label, name)] = out
    os.environ.pop("PCFT_DATA_MESH", None)

    verdict = {}
    a, b = results[("all cards", "run_measure_device")], results[("one card", "run_measure_device")]
    exact = all(x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))
    d = disagreement(a, b)
    verdict["run_measure_device"] = {"bit_equal": exact, **d}
    if not exact and (d["f0_rel"] > 1e-3 or d["lufs_db"] > 0.01):
        raise SystemExit(f"production mesh run_measure_device: all cards vs one card {d}")
    fields = ("raw_pitch", "raw_volume", "raw_rate", "pitch_smooth", "rate_smooth")
    ra, rb = results[("all cards", "measure_voices_batched")], results[("one card", "measure_voices_batched")]
    worst, exact_rows = 0.0, True
    for name in preps:
        if len(ra[name].rows) != len(rb[name].rows):
            raise SystemExit(f"production mesh measure_voices_batched {name}: {len(ra[name].rows)} rows vs {len(rb[name].rows)}")
        for x, y in zip(ra[name].rows, rb[name].rows):
            for f in fields:
                u, v = getattr(x, f), getattr(y, f)
                exact_rows &= u == v
                worst = max(worst, abs(u - v))
    verdict["measure_voices_batched"] = {"bit_equal": exact_rows, "rows_max_abs_pct": worst}
    if not exact_rows and worst > 0.1:
        raise SystemExit(f"production mesh measure_voices_batched: rows differ by {worst} percentage points")
    med = {lab: {k: float(np.median(v)) for k, v in per.items()} for lab, per in times.items()}
    S, T = preps["v0"].nat.shape
    print(f"production mesh ({S} segments a voice, T {T}; {n_slots} slots over {n_cards} cards): run_measure_device "
          f"{json.dumps(verdict['run_measure_device'])}, measure_voices_batched {json.dumps(verdict['measure_voices_batched'])}; "
          f"A and B once per card and group; warm s (medians of 2 in turns) {json.dumps(med)}; card={card}")
    print(json.dumps({"cards": n_cards, "slots": n_slots, "verdict": verdict, "seconds": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
