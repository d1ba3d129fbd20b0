#!/usr/bin/env python3
"""The contextual POS tagger and the evaluation layer alone: phase 21 of
``chip_smoke.py``.

    python3 tools/pos_eval_phase.py [--seed 0]

Run from the root of a checkout on a machine with an NVIDIA H100. It builds
the kernels, makes phase 15's four brute recordings (616.7 s) and runs them
through the multi-voice pipeline (``multiprocessing: true``, ``denoise:
mask``, the fake TTS, the energy aligner) as phase 15 does, without its
checks and timings, then runs ``chip_smoke.pos_eval_phase`` on that output:
the packaged tagger card against CPU with its held-out gates, the trainer at
the JAX CLI's settings, the eight steps with ``pos_backend: contextual``,
and the evaluation layer. Prints the card and the phase's lines, then its
result as one JSON line.
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
        print("pos_eval_phase: torch.cuda.is_available() is False — this needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from prosody_control_french_tts_tpu_torch.ops import kernels

    card = cs.card_line()
    print(card, flush=True)
    kernels.library()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        base = tmp / "multi_voice"
        texts = {name: cs.build_brute_voice(base, name, seed, cs.FULL_SEGMENTS, seconds=seconds)[0]
                 for name, seed, seconds in cs.MULTI_VOICES}
        cs.drive_all_voices(base, texts, "cuda", "mask")
        out = cs.pos_eval_phase(tmp, args.seed, card, base)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
