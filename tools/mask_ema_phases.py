#!/usr/bin/env python3
"""Where the mask-smoothing CUDA kernel (``csrc/mask_ema.cu``) spends its time.

    python3 tools/mask_ema_phases.py [--baseline DIR]

Run from the root of a checkout on a machine with an NVIDIA H100. As
``tools/chunk_cumsum_phases.py`` does for kernel E, the split is taken by
subtraction: ``csrc/mask_ema.cu`` is built as it is, without the recurrence
(the lines marked ``// [phase: chain]``: each value passes through
unchanged), and without the global stores too (``// [phase: stores]``),
which leaves the asynchronous copies into shared memory, the moves between
shared memory and registers, and the waits: "loads only". Each build runs on
the spectral gate's mask of ``chip_smoke.py``'s 159.5 s brute recording
(seed 0, 44.1 kHz, hop 256: [513, 27,474]) and is timed by
``chip_smoke.graph_ms`` (10 launches a graph) in two turns. The full build
(and the baseline) are checked against the plain version, bit for bit.
``--baseline DIR`` also builds ``DIR/mask_ema.cu`` and times it in the same
turns.

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
    ("no recurrence (values pass through)", "chain"),
    ("... and no stores: loads only", "stores"),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="a directory holding another mask_ema.cu to time beside")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mask_ema_phases: this needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from prosody_control_french_tts_tpu_torch.audio.denoise import gate_mask
    from prosody_control_french_tts_tpu_torch.ops import mask_ema
    from prosody_control_french_tts_tpu_torch.ops.stft import stft
    from prosody_control_french_tts_tpu_torch.utils.wavio import read_wav

    card = chip_smoke.card_line()
    print(card)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        libs = compile_all(builds_of("mask_ema.cu", CUTS, args.baseline), tmp, ["mask_ema_launch"])
        chip_smoke.build_brute_voice(tmp / "voice", "v", 0, chip_smoke.FULL_SEGMENTS)
        brute = read_wav(tmp / "voice" / "Data" / "voice" / "v" / "brute" / "segment.wav").to_mono()
        x = torch.from_numpy(np.ascontiguousarray(brute.samples, np.float32)).cuda()
        m = gate_mask(stft(x, 1024, 256))
        F, T = m.shape
        out = torch.empty_like(m)
        want = mask_ema.mask_ema_plain(m)

        def launcher(lib):
            def run():
                rc = lib.mask_ema_launch(m.data_ptr(), out.data_ptr(), F, T, 0.5, 0.5, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"launch failed: cudaError {rc}")
            return run

        for label in ("full kernel", "baseline"):
            if label in libs:
                launcher(libs[label])()
                torch.cuda.synchronize()
                if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                    raise SystemExit(f"the {label} build differs from the plain version")
        print(f"checked: the full build{' and the baseline' if 'baseline' in libs else ''} equal to the plain version "
              f"bit for bit on the mask [{F}, {T}] of the {brute.duration_seconds:.1f} s recording")
        times = {label: [] for label in libs}
        for _ in range(TURNS):
            for label, lib in libs.items():
                ms = chip_smoke.graph_ms(launcher(lib), reps=10)
                times[label].append(dict(ms=ms, ns_per_step=ms * 1e6 / (2 * (T - 1))))
        for label, turns in times.items():
            print(json.dumps({"build": label, "shape": dict(F=F, T=T), "turns": turns, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
