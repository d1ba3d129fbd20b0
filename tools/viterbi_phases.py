#!/usr/bin/env python3
"""Where the Viterbi CUDA kernel (kernel B) spends its time.

    python3 tools/viterbi_phases.py

Run from the root of a checkout on a machine with an NVIDIA H100. As
``tools/decode_attn_phases.py`` does for kernel F, the split is taken by
subtraction: ``csrc/viterbi.cu`` is built as it is and with one more piece
cut in each further build (the lines marked ``// [phase: ...]``):

- the backtrack's chain (the shuffle that carries the path from frame to
  frame; its loads and stores stay, every frame then takes the last frame's
  candidate);
- the forward chain (warp 0's steps over each tile of frames);
- the transition costs (the helper warps still stage each tile's inputs and
  store the back-pointers).

Every barrier stays in every build. Each build runs at the measure path's
shape [10, 4,715, 15] on random inputs (``tests/test_torch_kernels.py``'s
``random_viterbi_inputs``, seed 4) and is timed between CUDA events
(``chip_smoke.cuda_ms``, 20 launches after one warm-up); only the full build
is checked, bit for bit, against the plain PyTorch version. The same run
prints the chain floor of ``chip_smoke.viterbi_chain_floor`` at that shape.

Prints the card, then one line per build: milliseconds per launch.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

CUTS = (  # (build label, the phase whose marked lines it removes; cumulative)
    ("no backtrack chain", "backtrack"),
    ("no backtrack chain, no forward chain", "chain"),
    ("no chains, no transition costs", "costs"),
)
SHAPE = (10, 4715, 15)  # segments, frames, candidates of the measure voice
VUV, JUMP = 0.14, 0.35


def cut(src: str, phase: str) -> str:
    """The source with the statements marked ``// [phase: <phase>]`` taken
    out: a marked ``for`` header becomes a loop that runs no step."""
    marker = f"// [phase: {phase}]"
    out, hits = [], 0
    for line in src.splitlines():
        if marker in line:
            hits += 1
            if line.lstrip().startswith("for ("):
                init, _, rest = line.partition(";")
                line = init + "; false;" + rest.partition(";")[2]
            else:
                continue
        out.append(line)
    if not hits:
        raise SystemExit(f"no line marked {marker!r} in viterbi.cu")
    return "\n".join(out) + "\n"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("viterbi_phases: this needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from prosody_control_french_tts_tpu_torch.ops import kernels, viterbi
    from test_torch_kernels import random_viterbi_inputs

    print(chip_smoke.card_line())
    src = (kernels.CSRC / "viterbi.cu").read_text()
    builds = {"full kernel": src}
    text = src
    for label, phase in CUTS:
        text = cut(text, phase)
        builds[label] = text
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, (label, body) in enumerate(builds.items()):
            cu, so = Path(tmp) / f"v{i}.cu", Path(tmp) / f"v{i}.so"
            cu.write_text(body)
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", str(cu), "-o", str(so)]
            procs.append((label, so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        for label, so, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed for {label}:\n{out.decode(errors='replace')}")
            lib = ctypes.CDLL(str(so))
            for fn in ("viterbi_launch", "viterbi_latency_probe"):
                getattr(lib, fn).argtypes = list(kernels._SIGNATURES[fn])
                getattr(lib, fn).restype = ctypes.c_int
            libs[label] = lib

        S, F, K = SHAPE
        delta, lf, voiced, freq = (torch.from_numpy(a).cuda() for a in random_viterbi_inputs(4, S=S, F=F, K=K))
        want = viterbi.viterbi_path_plain(delta, lf, voiced, freq, VUV, JUMP)
        back = torch.empty(delta.shape, dtype=torch.uint8, device="cuda")
        f0 = torch.empty((S, F), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for label, lib in libs.items():
            def run(lib=lib):
                rc = lib.viterbi_launch(delta.data_ptr(), lf.data_ptr(), voiced.data_ptr(), freq.data_ptr(), back.data_ptr(),
                                        f0.data_ptr(), S, F, K, VUV, JUMP, stream)
                kernels.check(rc, "viterbi")

            run()
            torch.cuda.synchronize()
            if label == "full kernel" and not torch.equal(f0, want):
                raise SystemExit("the full build's f0 differs from the plain version")
            print(f"[{S}, {F}, {K}] {label}: {chip_smoke.cuda_ms(run, reps=20):.4f} ms")
        floor = chip_smoke.viterbi_chain_floor(libs["full kernel"], F, K)
        print(f"[{S}, {F}, {K}] chain floor: {floor['chain_floor_ms']:.4f} ms ({floor['chain_floor']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
