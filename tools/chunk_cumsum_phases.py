#!/usr/bin/env python3
"""Where the chunk-cumsum CUDA kernel (kernel E) spends its time.

    python3 tools/chunk_cumsum_phases.py [--baseline DIR]

Run from the root of a checkout on a machine with an NVIDIA H100. As
``tools/pitch_candidates_phases.py`` does for kernel A, the split is taken
by subtraction: ``csrc/chunk_cumsum.cu`` is built as it is, without the
register steps (32 .. 512), and without the shuffle steps (1 .. 16) too,
which leaves the loads, the subtraction and the stores. Each build runs at
the measure voice's shape [16, 1,040,384] (``chip_smoke.py``'s cumsum of x²,
here the squares of seeded normal values: E's time does not depend on the
data) and is timed by ``chip_smoke.graph_ms`` (20 launches a graph; 133 MB
read and written a launch, past the 50 MB L2) in two turns. Only the full
build is checked against the plain version, bit for bit. ``--baseline DIR``
also builds ``DIR/chunk_cumsum.cu`` and times it in the same turns.

Prints the card, then one JSON line per build.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from pitch_candidates_phases import TURNS, builds_of, compile_all  # noqa: E402

CUTS = (  # (build label, the phase whose marked lines it removes; cumulative)
    ("no register steps", "register steps"),
    ("loads and stores only (no shuffle steps either)", "shuffle steps"),
)
SHAPE = (16, 1040384)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="a directory holding another chunk_cumsum.cu to time beside")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chunk_cumsum_phases: this needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from prosody_control_french_tts_tpu_torch.ops import chunk_cumsum

    card = chip_smoke.card_line()
    print(card)
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all(builds_of("chunk_cumsum.cu", CUTS, args.baseline), Path(tmp), ["chunk_cumsum_launch"])
        R, C = SHAPE
        x = torch.from_numpy(np.square(np.random.default_rng(0).normal(size=SHAPE)).astype(np.float32)).cuda()
        out = torch.empty_like(x)
        want = chunk_cumsum.chunk_cumsum_plain(x)

        def launcher(lib):
            def run():
                rc = lib.chunk_cumsum_launch(x.data_ptr(), out.data_ptr(), R, C, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"launch failed: cudaError {rc}")
            return run

        for label in ("full kernel", "baseline"):
            if label in libs:
                launcher(libs[label])()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise SystemExit(f"the {label} build differs from the plain version")
        print(f"checked: the full build{' and the baseline' if 'baseline' in libs else ''} equal to the plain version "
              f"bit for bit on [{R}, {C}]")
        times = {label: [] for label in libs}
        for _ in range(TURNS):
            for label, lib in libs.items():
                times[label].append(dict(ms=chip_smoke.graph_ms(launcher(lib), reps=20)))
        for label, turns in times.items():
            print(json.dumps({"build": label, "shape": dict(R=R, C=C), "turns": turns, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
