#!/usr/bin/env python3
"""Phase 23 of ``chip_smoke.py`` alone: the umbrella command line (``run``,
``legacy``, ``sync``, ``corpus``, ``analyze``, ``abtest``), the viewer with
``device_trace``, ``train_stage`` checkpoints, the sinc-refined pitch track
and the HF converters at Qwen2.5-7B's and whisper-base's widths, on the
card.

    python3 tools/cli_phase.py [--seed 0]

Run from the root of a checkout on a machine with an NVIDIA H100. Prints the
card, the phase's lines, then its results as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("cli_phase: torch.cuda.is_available() is False — this needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from prosody_control_french_tts_tpu_torch.ops import kernels

    card = cs.card_line()
    print(card, flush=True)
    kernels.library()
    with tempfile.TemporaryDirectory() as tmp:
        out = cs.cli_phase(Path(tmp), args.seed, card)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
