#!/usr/bin/env python3
"""Kernel H (fused LM-head cross-entropy) timed at the training path's shapes,
with its device time split by kernel.

    python3 tools/fused_ce_timing.py [--root DIR ...] [--dtype bfloat16|float32]
    python3 tools/fused_ce_timing.py --phases

Run from the root of a checkout on a machine with an NVIDIA H100. Each
``--root`` is a checkout of the repository (default: this one); each is
measured in a process of its own, which builds that checkout's kernels, so
two versions can be compared on one card in turns (parent, change, change,
parent). Inputs are random, made on the card from a fixed seed, at the 7B
training step's shape (N 2,044, D 3,584, V 152,064) and the bench training
geometry's (N 4,088, D 896, V 32,768). For each: the forward alone and the
backward (forward + backward less the forward) as CUDA-graph replays between
CUDA events (``chip_smoke.fwd_bwd_ms``; W exceeds L2, so every call finds it
cold), then one forward + backward under ``torch.profiler`` for the split by
kernel name. Nothing is checked here: ``chip_smoke.py`` and the gpu tests
hold the kernels to their plain versions.

``--phases`` splits the bfloat16 kernels' time by subtraction instead, as
``tools/decode_attn_phases.py`` does for kernel F: ``csrc/fused_ce.cu`` is
built as it is and once more with every epilogue cut (a continue, or a
return after a block's one tile, put in front of each epilogue's marker
comment, so the blocks run the TMA ring and the wgmma mainloop only and
write nothing useful), and both builds' launchers are timed (CUDA events around repeated launches) with the backward
split by kernel under ``torch.profiler``.

Prints the card, then one JSON line per root (or build) and shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = {"7B": (2044, 3584, 152064), "bench": (4088, 896, 32768)}
# (epilogue marker in csrc/fused_ce.cu, what goes in front of it to cut it)
CUTS = (
    ("    // each thread folds its own 64 columns of each row", "    if (N > 0) continue;\n"),
    ("    // coef = (p - onehot) g straight from the accumulators", "    if (N > 0) continue;\n"),
    ("  // dh (+)= acc: the tile's one owner", "  if (N > 0) return;\n"),
)


def by_kernel(by_name: dict) -> dict:
    """torch.profiler rows {name: [ms, count]} summed by kernel name without
    its arguments."""
    split = {}
    for name, (t, count) in by_name.items():
        key = name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
        slot = split.setdefault(key, [0.0, 0])
        slot[0] += t
        slot[1] += count
    return {k: [round(t, 4), c] for k, (t, c) in sorted(split.items(), key=lambda kv: -kv[1][0])}


def phases() -> None:
    """The bfloat16 launchers of csrc/fused_ce.cu, built as they are and with
    the epilogues cut, timed at both shapes."""
    import torch

    import chip_smoke
    from prosody_control_french_tts_tpu_torch.ops import fused_ce, kernels

    src = (kernels.CSRC / "fused_ce.cu").read_text()
    builds = {"full": src, "mainloop only": src}
    for marker, cut in CUTS:
        if src.count(marker) != 1:
            raise SystemExit(f"marker {marker!r} not found once in fused_ce.cu")
        builds["mainloop only"] = builds["mainloop only"].replace(marker, cut + marker)
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, text in enumerate(builds.values()):
            cu, so = Path(tmp) / f"v{i}.cu", Path(tmp) / f"v{i}.so"
            cu.write_text(text)
            procs.append((so, subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", str(cu), "-o", str(so)])))
        for label, (so, proc) in zip(builds, procs):
            if proc.wait() != 0:
                raise SystemExit(f"nvcc failed for the {label} build")
            lib = ctypes.CDLL(str(so))
            for fn in ("fused_ce_fwd_launch", "fused_ce_bwd_launch"):
                getattr(lib, fn).argtypes = list(kernels._SIGNATURES[fn])
                getattr(lib, fn).restype = ctypes.c_int
            libs[label] = lib

        sms = torch.cuda.get_device_properties(0).multi_processor_count
        gen = torch.Generator(device="cuda").manual_seed(0)
        for shape, (n, d, v) in SHAPES.items():
            h = (torch.randn((n, d), device="cuda", generator=gen) * 0.5).bfloat16()
            w = (torch.randn((d, v), device="cuda", generator=gen) * 0.02).bfloat16()
            tgt = torch.randint(0, v, (n,), device="cuda", generator=gen, dtype=torch.int32)
            g = torch.full((n,), 1.0 / n, device="cuda")
            splits, per = fused_ce.split_plan(n, v, fused_ce.TILE_BF16, sms)
            chunk, cols = fused_ce.chunk_plan(n, v, sms), fused_ce.dh_cols(n, d, sms)
            nll, lse = (torch.empty(n, device="cuda") for _ in range(2))
            partials = torch.empty((3, splits, n), device="cuda")
            coef = torch.empty((n, chunk), dtype=torch.bfloat16, device="cuda")
            dh = torch.empty((n, d), device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            for label, lib in libs.items():
                def fwd(lib=lib):
                    kernels.check(lib.fused_ce_fwd_launch(h.data_ptr(), w.data_ptr(), tgt.data_ptr(), nll.data_ptr(), lse.data_ptr(),
                                                          partials.data_ptr(), n, d, v, splits, per, 1, stream), "fused_ce_fwd")

                def bwd(lib=lib):
                    kernels.check(lib.fused_ce_bwd_launch(h.data_ptr(), w.data_ptr(), tgt.data_ptr(), lse.data_ptr(), g.data_ptr(),
                                                          coef.data_ptr(), dh.data_ptr(), n, d, v, chunk, cols, 1, stream), "fused_ce_bwd")

                fwd_ms = chip_smoke.cuda_ms(fwd, reps=5)
                bwd_ms = chip_smoke.cuda_ms(bwd, reps=5)
                _, by_name = chip_smoke.profile_device(bwd)
                print(json.dumps({"build": label, "shape": shape, "N": n, "D": d, "V": v, "splits": splits, "tiles_per_split": per,
                                  "chunk": chunk, "dh_cols": cols, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                                  "fwd_tflops": 2 * n * d * v / fwd_ms / 1e9, "bwd_tflops": 4 * n * d * v / bwd_ms / 1e9,
                                  "bwd_profiled_ms_by_kernel": by_kernel(by_name)}), flush=True)
            del h, w, coef, dh


def measure(root: Path, dtype_name: str) -> None:
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke
    from prosody_control_french_tts_tpu_torch.ops import fused_ce

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (n, d, v) in SHAPES.items():
        h = (torch.randn((n, d), device="cuda", generator=gen) * 0.5).to(dtype)
        w = (torch.randn((d, v), device="cuda", generator=gen) * 0.02).to(dtype)
        tgt = torch.randint(0, v, (n,), device="cuda", generator=gen, dtype=torch.int32)
        g = torch.full((n,), 1.0 / n, device="cuda")

        def make_call(inputs, grad):
            hh = inputs[0].detach().requires_grad_(True) if grad else inputs[0]
            return fused_ce.linear_ce_rows(hh, w, tgt), g, (hh,)

        ms = chip_smoke.fwd_bwd_ms(make_call, [(h,), (h.clone(),)], reps=3)

        def once():
            out, grad, leaves = make_call((h,), True)
            torch.autograd.grad(out, leaves, grad)

        once()
        _, by_name = chip_smoke.profile_device(once)
        flops = {"fwd": 2 * n * d * v, "bwd": 4 * n * d * v}
        print(json.dumps({"root": str(root), "shape": label, "N": n, "D": d, "V": v, "dtype": dtype_name,
                          "fwd_ms": ms["fwd"], "bwd_ms": ms["bwd"],
                          "fwd_tflops": flops["fwd"] / ms["fwd"] / 1e9, "bwd_tflops": flops["bwd"] / ms["bwd"] / 1e9,
                          "profiled_ms_by_kernel": by_kernel(by_name)}),
              flush=True)
        del h, w


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", type=Path, help="a checkout to measure (repeatable; default this one)")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--phases", action="store_true", help="split the bfloat16 kernels' time: full build against epilogues cut")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        measure(args.one.resolve(), args.dtype)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("fused_ce_timing: torch.cuda.is_available() is False — this needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    print(chip_smoke.card_line(), flush=True)
    if args.phases:
        phases()
        return 0
    for root in args.root or [ROOT]:
        res = subprocess.run([sys.executable, __file__, "--one", str(root), "--dtype", args.dtype])
        if res.returncode != 0:
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
