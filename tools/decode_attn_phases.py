#!/usr/bin/env python3
"""Where the decode-attention CUDA kernel (kernel F) spends its time, and how
its time moves with the number of blocks a cluster.

    python3 tools/decode_attn_phases.py

Run from the root of a checkout on a machine with an NVIDIA H100. The card
has no per-kernel profiler that works everywhere, so the split is taken by
subtraction: the kernel's source (``csrc/decode_attn.cu`` of the PyTorch
port) is built as it is and with the lines of one more phase cut in each
further build (the lines marked ``// [phase: ...]``): the P.V products, then
the q.K products, then the staging copies, then the softmax's loops over the
rows in the exchange, then the partials pushed to rank 0. Every cut keeps
every barrier and the exchange of maxima and sums through distributed shared
memory, so the clusters still meet (an early return in one block would leave
the others waiting), and what is left in the last build is the launch, the
query load, the three cluster barriers and the combine. Each build is timed by its kernel's duration under
``torch.profiler`` (``chip_smoke.device_ms``) on random bfloat16 tensors at
the serving path's two geometries, with the caches cold in L2 (the calls
rotate over enough copies to exceed the 50 MB cache, as in the decode loop).
The full build is timed at 1, 2, 4 and 8 blocks a cluster, the cut builds
at the number that ``ops/decode_attn.py split_plan`` gives. The builds with cuts compute nothing
useful; only the full build's output is checked, against the plain PyTorch
version.

Prints the card, then one line per geometry, build and cluster size:
microseconds per launch.
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

CUTS = (  # (build label, the phase whose marked lines it removes, cumulative)
    ("no P.V products", "pv"),
    ("no q.K or P.V products", "qk"),
    ("no products, no staging copies", "staging"),
    ("... and no softmax work in the exchange", "exchange"),
    ("... and no partials pushed (launch, q, barriers, combine)", "push"),
)
GEOMETRIES = {  # B, H, KV heads, hd, S, pos
    "7B geometry": (16, 28, 4, 128, 192, 190),
    "bench geometry": (64, 14, 2, 64, 320, 318),
}
TOL = 2e-2  # bfloat16, as chip_smoke.py's TOL_F_BF16


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
        raise SystemExit(f"no line marked {marker!r} in decode_attn.cu")
    return "\n".join(out) + "\n"


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
            lib.decode_attn_launch.argtypes = list(kernels._SIGNATURES["decode_attn_launch"])
            lib.decode_attn_launch.restype = ctypes.c_int
            libs[label] = lib

        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for name, (B, H, KV, hd, S, pos) in GEOMETRIES.items():
            gen = torch.Generator(device="cuda").manual_seed(0)
            q = torch.randn((B, H, hd), device="cuda", generator=gen).bfloat16()
            kc = torch.randn((B, S, KV * hd), device="cuda", generator=gen).bfloat16()
            vc = torch.randn((B, S, KV * hd), device="cuda", generator=gen).bfloat16()
            copies = max(2, int(120e6 // (2 * kc.numel() * 2)) + 1)
            caches = [(kc.clone(), vc.clone()) for _ in range(copies)]
            out = torch.empty_like(q)
            stream = torch.cuda.current_stream().cuda_stream
            turn = [0]

            def launch(lib, C):
                turn[0] += 1
                k, v = caches[turn[0] % copies]
                rc = lib.decode_attn_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, S, KV, H // KV, hd, pos, 1.0 / math.sqrt(hd), 1, C, stream,
                )
                kernels.check(rc, "decode_attn")

            plan = decode_attn.split_plan(B, KV, S, sms)
            sizes = (1, 2, 4, 8)
            want = decode_attn.decode_attention_plain(q, kc, vc, pos, KV).float()
            for C in sizes:
                turn[0] = -1  # the next launch uses caches[0] = (kc, vc)'s values
                launch(libs["full kernel"], C)
                torch.cuda.synchronize()
                err = (out.float() - want).abs()
                if bool((err > TOL + TOL * want.abs()).any()):
                    raise SystemExit(f"{name}, {C} blocks a cluster: the full build disagrees with the plain version by {float(err.max())}")
            shape = f"B {B}, H {H}, KV {KV}, hd {hd}, S {S}, pos {pos}"
            for C in sizes:
                us = chip_smoke.device_ms(lambda: launch(libs["full kernel"], C), reps=200) * 1e3
                print(f"{name} ({shape}): full kernel, {C} blocks a cluster{' (plan)' if C == plan else ''}: {us:.2f} us")
            for label in list(builds)[1:]:
                us = chip_smoke.device_ms(lambda lib=libs[label]: launch(lib, plan), reps=200) * 1e3
                print(f"{name} ({shape}): {label}, {plan} blocks a cluster: {us:.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
