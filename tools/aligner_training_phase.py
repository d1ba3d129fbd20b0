#!/usr/bin/env python3
"""The packaged recipes of the aligners and the separator at full size, on
the card: the Whisper aligner's (``align/pretrain_whisper.py:pretrain``, 1,536
sentences, 12 epochs, B 16, its three gates asserted), and on request the
CTC aligner's (384 sentences, 12 epochs, B 8) and MaskNet's (256 mixtures,
10 epochs, B 4), which phase 22 of ``chip_smoke.py`` also runs whole; or
phase 22 itself (``phase22``: train_ctc with the ctc_loss kernel held to its
plain version and timed, the CTC and MaskNet recipes, the Whisper recipe
cut).

    python3 tools/aligner_training_phase.py [--recipes whisper,ctc,masknet,phase22] [--seed 0]

Run from the root of a checkout on a machine with an NVIDIA H100. Every
checkpoint goes to a temporary directory: the packaged ones are never
written. Prints the card, one line per recipe (wall seconds, ms a step by
CUDA events, peak device memory, the loss curve and the gates' values),
then the results as one JSON line. A failed gate raises (the Whisper
recipe leaves its weights in the temporary ``.failed`` directory).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--recipes", default="whisper")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("aligner_training_phase: torch.cuda.is_available() is False — this needs a CUDA card", file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    import chip_smoke as cs
    from prosody_control_french_tts_tpu_torch.align import pretrain_ctc, pretrain_whisper
    from prosody_control_french_tts_tpu_torch.audio import separate
    from prosody_control_french_tts_tpu_torch.ops import kernels

    card = cs.card_line()
    print(card, flush=True)
    lib = kernels.library()
    results = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for recipe in args.recipes.split(","):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if recipe == "phase22":
                results[recipe] = cs.aligner_training_phase(card, lib, args.seed)
                continue
            if recipe == "whisper":
                with cs.StepClock(pretrain_whisper, "_make_step") as clock:
                    al, err_ms, acc = pretrain_whisper.pretrain(tmp / "whisper_fr_synth", seed=args.seed)
                res = dict(history=al.history, **al.gates)
            elif recipe == "ctc":
                with cs.StepClock(pretrain_ctc, "_make_step") as clock:
                    _, err_ms = pretrain_ctc.pretrain(tmp / "ctc_fr_synth.npz", seed=args.seed)
                res = dict(boundary_ms=err_ms)
            elif recipe == "masknet":
                with cs.StepClock(separate, "_make_step") as clock:
                    sep, gain = separate.pretrain_masknet(tmp / "masknet.npz", seed=args.seed)
                res = dict(si_snr_gain_db=gain, real_gain_db=sep.real_gain, losses=sep.losses)
            else:
                raise SystemExit(f"unknown recipe {recipe!r}")
            torch.cuda.synchronize()
            res.update(wall_s=time.perf_counter() - t0, steps=clock.steps, ms_per_step=clock.ms_per_step(),
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            print(f"recipe {recipe}: " + json.dumps(res) + f"; card={card}", flush=True)
            results[recipe] = res
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
