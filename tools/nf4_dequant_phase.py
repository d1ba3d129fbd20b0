#!/usr/bin/env python3
"""``chip_smoke.py``'s nf4_dequant row alone: the NF4 dequantization kernel
(``csrc/nf4_dequant.cu``) at stage B's four shapes against its plain
version, bit for bit, its ms beside its byte bound and the plain version's,
and the kernel's registers (ptxas).

    python3 tools/nf4_dequant_phase.py [--splits 1,2,4,8,16,32]

Run from the root of a checkout on a machine with an NVIDIA H100.
``--splits`` also times each of these shares of a scale block's 32 packed
rows (threads a block row) at each shape, beside the plan's. Prints the
card, the phase's lines, then its row as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", default="", help="comma-separated threads a block row to time beside the plan's")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("nf4_dequant_phase: torch.cuda.is_available() is False — this needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from prosody_control_french_tts_tpu_torch.ops import kernels

    card = cs.card_line()
    print(card, flush=True)
    lib = kernels.library()
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(kernels.CSRC / "nf4_dequant.cu"),
           "-o", str(kernels.BUILD_DIR / "ptxas_nf4_dequant.o")]
    text = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=True).stdout
    print("ptxas: nf4_dequant kernels (<output type, 16-byte path>): " + json.dumps(cs.nf4_ptxas_rows(text)), flush=True)
    splits = tuple(int(x) for x in args.splits.split(",") if x)
    print(json.dumps(cs.nf4_dequant_phase(card, lib, splits=splits)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
