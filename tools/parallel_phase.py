#!/usr/bin/env python3
"""Phase 24 of ``chip_smoke.py`` alone: the parallel layer over a one-rank
``nccl`` group on the card. ``measure_sharded`` against
``run_measure_device`` on the measure voice (10 segments of 8–23 s from
``utils/synth.py``, seed 0) and the 7B dp×tp LoRA step
(``shard_train_inputs`` + ``make_train_step``) against the unsharded step on
a 7B trainer built here (phase 11's, whose cost is printed).

    python3 tools/parallel_phase.py [--seed 0]

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
        print("parallel_phase: torch.cuda.is_available() is False — this needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from prosody_control_french_tts_tpu_torch.ops import kernels
    from prosody_control_french_tts_tpu_torch.prosody.adjust import ProsodySettings
    from prosody_control_french_tts_tpu_torch.prosody.measure import prepare_voice
    from prosody_control_french_tts_tpu_torch.utils.synth import synth_voice

    card = cs.card_line()
    print(card, flush=True)
    kernels.library()
    with tempfile.TemporaryDirectory() as tmp:
        voice = synth_voice(Path(tmp) / "voice", seed=args.seed, n_segments=cs.FULL_SEGMENTS)
        prep = prepare_voice(*voice, ProsodySettings())
    out = cs.parallel_phase(card, prep, cs.build_7b_trainer(args.seed, card))
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
