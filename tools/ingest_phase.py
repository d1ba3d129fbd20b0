#!/usr/bin/env python3
"""Phase 25 of ``chip_smoke.py`` alone: the native audio ingest (its build
and ``_load_padded`` against the Python path), the corpus prefetch and the
Azure backend against a loopback server, the eight steps at 44.1 and 48
kHz, on the card.

    python3 tools/ingest_phase.py [--seed 0]

Run from the root of a checkout on a machine with an NVIDIA H100. Prints the
card, the phase's lines, then its results as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ingest_phase: torch.cuda.is_available() is False — this needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from prosody_control_french_tts_tpu_torch.ops import kernels
    from prosody_control_french_tts_tpu_torch.utils import native_audio
    from prosody_control_french_tts_tpu_torch.utils.synth import synth_voice

    card = cs.card_line()
    print(card, flush=True)
    kernels.library()
    t0 = time.perf_counter()
    native_audio.library()
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        seg_files, _, _ = synth_voice(tmp / "voice", seed=args.seed, n_segments=cs.FULL_SEGMENTS)
        out = cs.ingest_phase(tmp, args.seed, card, seg_files, build_s)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
