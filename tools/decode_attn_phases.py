#!/usr/bin/env python3
"""Where the decode-attention CUDA kernel spends its time, phase by phase.

    python3 tools/decode_attn_phases.py

Run from the root of a checkout on a machine with an NVIDIA H100. The card
has no per-kernel profiler that works everywhere, so the split is taken by
subtraction: the kernel's source (``csrc/decode_attn.cu`` of the PyTorch
port) is built once as it is and once per phase with an early return put in
front of that phase's marker comment, and each build is timed by its
kernel's duration under ``torch.profiler`` (``chip_smoke.device_ms``), on
random bfloat16 tensors at the serving path's two geometries, with the
caches hot in L2. The builds with an early return compute nothing useful;
only the full build's output is checked, against the plain PyTorch version.

Prints the card, then one line per geometry and build: microseconds up to
the start of each phase, and the full kernel.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (label, the source line each early return goes in front of)
STOPS = (
    ("launch only", "  // this lane's columns of the group's query rows"),
    ("q loaded + phase 1 (scores)", "  // phase 2:"),
    ("+ phase 2 (softmax)", "  // phase 3:"),
    ("+ phase 3 loop (p.V)", "  // the row slots of a warp, then the warps"),
)
GEOMETRIES = {  # B, H, KV heads, hd, S, pos
    "7B geometry": (16, 28, 4, 128, 192, 190),
    "bench geometry": (64, 14, 2, 64, 320, 318),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_attn_phases: this needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from prosody_control_french_tts_tpu_torch.ops import decode_attn, kernels

    print(chip_smoke.card_line())
    src = (kernels.CSRC / "decode_attn.cu").read_text()
    builds = {"full kernel": src}
    for label, marker in STOPS:
        if src.count(marker) != 1:
            raise SystemExit(f"marker {marker!r} not found once in decode_attn.cu")
        builds[label] = src.replace(marker, f"  if (scale != 0.0f) return;\n{marker}")
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, text) in enumerate(builds.items()):
            cu, so = Path(tmp) / f"v{i}.cu", Path(tmp) / f"v{i}.so"
            cu.write_text(text)
            subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", str(cu), "-o", str(so)], check=True)
            lib = ctypes.CDLL(str(so))
            lib.decode_attn_launch.argtypes = list(kernels._SIGNATURES["decode_attn_launch"])
            lib.decode_attn_launch.restype = ctypes.c_int
            libs[label] = lib

        for name, (B, H, KV, hd, S, pos) in GEOMETRIES.items():
            gen = torch.Generator(device="cuda").manual_seed(0)
            q, kc, vc = (
                torch.randn(shape, device="cuda", generator=gen).bfloat16()
                for shape in ((B, H, hd), (B, S, KV * hd), (B, S, KV * hd))
            )
            out = torch.empty_like(q)
            scratch = torch.empty((B, H, pos + 1), dtype=torch.float32, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def launch(lib):
                rc = lib.decode_attn_launch(
                    q.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                    B, S, KV, H // KV, hd, pos, 1.0 / math.sqrt(hd), 1, stream,
                )
                kernels.check(rc, "decode_attn")

            launch(libs["full kernel"])
            torch.cuda.synchronize()
            want = decode_attn.decode_attention_plain(q, kc, vc, pos, KV)
            err = float((out.float() - want.float()).abs().max())
            if err > 2e-2:
                raise SystemExit(f"{name}: the full build disagrees with the plain version by {err}")
            for label, lib in libs.items():
                us = chip_smoke.device_ms(lambda lib=lib: launch(lib), reps=100) * 1e3
                print(f"{name} (B {B}, H {H}, KV {KV}, hd {hd}, pos {pos}): {label}: {us:.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
