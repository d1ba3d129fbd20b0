#!/usr/bin/env python3
"""Where the mask-smoothing CUDA kernel (``csrc/mask_ema.cu``) spends its time.

    python3 tools/mask_ema_phases.py [--baseline DIR]

Run from the root of a checkout on a machine with an NVIDIA H100. As
``tools/chunk_cumsum_phases.py`` does for kernel E, the split is taken by
subtraction: ``csrc/mask_ema.cu`` is built as it is, without the fix-up
launches (the lines marked ``// [phase: fixup]``: the speculative passes
alone), then also without the recurrence (``// [phase: chain]``: each value
passes through unchanged), then also without the global stores
(``// [phase: stores]``), which leaves the staging copies, the barriers and
the launches: "loads only". Each build runs on the spectral gate's mask of
``chip_smoke.py``'s 159.5 s brute recording (seed 0, 44.1 kHz, hop 256:
[513, 27,474]) at smooth 0.5 and is timed by ``chip_smoke.graph_ms`` (10
calls a graph) in two turns. The full build also runs at warm-ups of 64,
128 and 256 frames (the chunks recomputed by the fix-ups are counted for
each) and at smooth 0.999, where nearly every chunk is recomputed: the
sequential chain, the worst case. The full build (and the baseline) are
checked against the plain version, bit for bit. ``--baseline DIR`` also
builds ``DIR/mask_ema.cu``, the design with one thread a bin (the interface
of ``git show 2f17a36:prosody_control_french_tts_tpu_torch/csrc/mask_ema.cu``),
and times it in the same turns.

Prints the card, then one JSON line per build.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from pitch_candidates_phases import TURNS, builds_of, compile_all  # noqa: E402

CUTS = (  # (build label, the phase whose marked lines it removes; cumulative)
    ("no fix-up launches: the speculative passes", "fixup"),
    ("... and no recurrence (values pass through)", "chain"),
    ("... and no stores: loads only", "stores"),
)
WARMUPS = (64, 128, 256)
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
BASELINE_LAUNCH = (_VP, _VP, _I, ctypes.c_longlong, _F, _F, _VP)  # mask, out, F, T, smooth, 1 - smooth, stream


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="a directory holding the earlier mask_ema.cu to time beside")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mask_ema_phases: this needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from prosody_control_french_tts_tpu_torch.audio.denoise import gate_mask
    from prosody_control_french_tts_tpu_torch.ops import kernels, mask_ema
    from prosody_control_french_tts_tpu_torch.ops.stft import stft
    from prosody_control_french_tts_tpu_torch.utils.wavio import read_wav

    card = chip_smoke.card_line()
    print(card)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        libs = compile_all(builds_of("mask_ema.cu", CUTS, args.baseline), tmp, [])
        for label, lib in libs.items():
            sigs = {"mask_ema_launch": BASELINE_LAUNCH} if label == "baseline" else {
                fn: kernels._SIGNATURES[fn] for fn in ("mask_ema_launch", "mask_ema_chunks")}
            for fn, sig in sigs.items():
                getattr(lib, fn).argtypes = list(sig)
                getattr(lib, fn).restype = ctypes.c_int
        chip_smoke.build_brute_voice(tmp / "voice", "v", 0, chip_smoke.FULL_SEGMENTS)
        brute = read_wav(tmp / "voice" / "Data" / "voice" / "v" / "brute" / "segment.wav").to_mono()
    x = torch.from_numpy(np.ascontiguousarray(brute.samples, np.float32)).cuda()
    m = gate_mask(stft(x, 1024, 256))
    F, T = m.shape
    out = torch.empty_like(m)
    scratch = torch.empty_like(m)
    enter = torch.empty((F, libs["full kernel"].mask_ema_chunks(T)), dtype=torch.float32, device=m.device)
    fixups = torch.zeros(1, dtype=torch.int64, device=m.device)

    def launcher(lib, smooth=0.5, warm=mask_ema.WARMUP, baseline=False):
        def run():
            if baseline:
                rc = lib.mask_ema_launch(m.data_ptr(), out.data_ptr(), F, T, smooth, 1 - smooth,
                                         torch.cuda.current_stream().cuda_stream)
            else:
                rc = lib.mask_ema_launch(m.data_ptr(), out.data_ptr(), scratch.data_ptr(), enter.data_ptr(),
                                         fixups.data_ptr(), F, T, smooth, 1 - smooth, warm,
                                         torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"launch failed: cudaError {rc}")
        return run

    runs = {label: launcher(lib, baseline=label == "baseline") for label, lib in libs.items()}
    full = libs["full kernel"]
    for w in WARMUPS:
        if w != mask_ema.WARMUP:
            runs[f"full kernel, warm-up {w}"] = launcher(full, warm=w)
    runs["full kernel, smooth 0.999 (worst case)"] = launcher(full, smooth=0.999)
    if "baseline" in libs:
        runs["baseline, smooth 0.999"] = launcher(libs["baseline"], smooth=0.999, baseline=True)
    counts, wants = {}, {smooth: mask_ema.mask_ema_plain(m, smooth) for smooth in (0.5, 0.999)}
    for label, run in runs.items():
        if label.startswith("full kernel") or label.startswith("baseline"):
            fixups.zero_()
            run()
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int32), wants[0.999 if "0.999" in label else 0.5].view(torch.int32)):
                raise SystemExit(f"the {label} build differs from the plain version")
            if label.startswith("full kernel"):
                counts[label] = int(fixups.item())
    print(f"checked: every full-kernel run{' and the baseline' if 'baseline' in libs else ''} equal to the plain version "
          f"bit for bit on the mask [{F}, {T}] of the {brute.duration_seconds:.1f} s recording; chunks recomputed by the "
          f"fix-ups (both passes, of {2 * F * (enter.shape[1] - 1)}): {json.dumps(counts)}")
    times = {label: [] for label in runs}
    for _ in range(TURNS):
        for label, run in runs.items():
            ms = chip_smoke.graph_ms(run, reps=10)
            times[label].append(dict(ms=ms, ns_per_step=ms * 1e6 / (2 * (T - 1))))
    for label, turns in times.items():
        print(json.dumps({"build": label, "shape": dict(F=F, T=T), "fixups": counts.get(label), "turns": turns,
                          "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
