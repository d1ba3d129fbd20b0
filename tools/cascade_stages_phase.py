#!/usr/bin/env python3
"""Phase 26 of ``chip_smoke.py`` alone: the paper's two cascade training
stages at Qwen2.5-7B's full width and depth (stage A: bf16 base, remat, B 1
x accum 16, L 1024; stage B: the base quantized to NF4 on the card, remat
saving the matrix products, B 1 x accum 32, L 768), stage B served as int8b,
and the 7B fused serving tree quantized to int8b on the card.

    python3 tools/cascade_stages_phase.py [--seed 0]

Run from the root of a checkout on a machine with an NVIDIA H100. Phase 14
does not run here, so its 7B step is not printed beside the stages' peak
memory. Prints the card, the phase's lines, then its results as one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("cascade_stages_phase: torch.cuda.is_available() is False — this needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from prosody_control_french_tts_tpu_torch.ops import kernels

    card = cs.card_line()
    print(card, flush=True)
    kernels.library()
    out = cs.cascade_phase(args, card)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
