#!/usr/bin/env python3
"""Planted faults in the flash attention's bfloat16 kernels, held to the
limits ``chip_smoke.py`` holds the sound kernel to.

    python3 tools/flash_attention_faults.py [--seed 0] [--out build/flash_faults.json]

Run from the root of a checkout, on a machine with an H100. It compiles
``csrc/flash_attention.cu`` as it is and five copies of it, each with one
fault planted in the rows of the last quarter of query tiles (or, for dk/dv,
the first quarter of key tiles), where a row averages the most keys and an
error is smallest beside the output:

- ``fwd_tile``: the forward skips key tile qt / 2;
- ``fwd_keys8``: the forward drops 8 keys of key tile qt / 2 (one n8 block of
  the score fragment);
- ``fwd_rescale``: the forward leaves the running sum unrescaled at key tile
  qt / 2;
- ``dq_keys8``: the dq kernel drops those 8 keys from ds;
- ``dkv_queries8``: the dk/dv kernel drops 8 queries of query tile
  (jt + nt) / 2.

Each copy is compiled into a temporary directory, never beside the sources,
and loaded in place of the kernel library. On random bfloat16 inputs at the
7B layer shape [2, 28, 1024, 128], the bench shape [8, 14, 768, 64] and
[1, 4, 2048, 128], it prints for every build the forward and dq/dk/dv
measures of ``chip_smoke.FA_LIMITS`` in bfloat16 (the forward's row 2-norms,
the gradients' error over the plain bf16 version's) and of
``G_LIMITS`` (max |err|, absolute forward, over the largest element for
gradients) and whether each passes its limits, and the sound build's float32
readings of both measures (``FA_LIMITS`` holds float32 at G's). It exits 0
when the sound build passes both and every fault fails ``FA_LIMITS``.
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
sys.path.insert(0, str(ROOT))

FAULT_ROWS = "(4 * qt >= 3 * (int)gridDim.z && kt == qt / 2)"  # forward and dq: the last quarter of query tiles
FAULT_KEYS = "(4 * jt < nt && i == (jt + nt) / 2)"  # dk/dv: the first quarter of key tiles
FAULTS = {
    "fwd_tile": [(
        "    mma_abt<HD, 8>(s, a_q, TL::LD * 2, s_k + buf * TL::BYTES, TL::LD * 2, lane);\n"
        "    const int k0 = kt * kRows;\n    const bool diag = kt == qt;\n    float mx[2]",
        f"    if {FAULT_ROWS} {{ __syncthreads(); continue; }}\n"
        "    mma_abt<HD, 8>(s, a_q, TL::LD * 2, s_k + buf * TL::BYTES, TL::LD * 2, lane);\n"
        "    const int k0 = kt * kRows;\n    const bool diag = kt == qt;\n    float mx[2]",
    )],
    "fwd_keys8": [(
        "s[n][e] = exp2f(s[n][e] - m[e >> 1]);",
        f"s[n][e] = ({FAULT_ROWS} && n == 3) ? 0.0f : exp2f(s[n][e] - m[e >> 1]);",
    )],
    "fwd_rescale": [("l[r] *= alpha[r];", f"if (!{FAULT_ROWS}) l[r] *= alpha[r];")],
    "dq_keys8": [(
        "const bool masked = diag && k0 + n * 8 + 2 * tig + (e & 1) > row0 + 8 * r;",
        f"const bool masked = (diag && k0 + n * 8 + 2 * tig + (e & 1) > row0 + 8 * r) || ({FAULT_ROWS} && n == 3);",
    )],
    "dkv_queries8": [(
        "const bool live = key0 + 8 * (e >> 1) <= query;",
        f"const bool live = key0 + 8 * (e >> 1) <= query && !({FAULT_KEYS} && qc == 1 && n == 0);",
    )],
}
SHAPES = {"7B": (2, 28, 1024, 128), "bench": (8, 14, 768, 64), "L 2048": (1, 4, 2048, 128)}


def build_all(tmp: Path) -> dict:
    """Compile the sound source and every faulty copy, in parallel: name -> .so path."""
    from prosody_control_french_tts_tpu_torch.ops import kernels

    src = (kernels.CSRC / "flash_attention.cu").read_text()
    texts = {"sound": src}
    for name, edits in FAULTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"fault {name}: the anchor is not found once in flash_attention.cu: {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        cu = tmp / f"{name}.cu"
        cu.write_text(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", str(cu), "-o", str(tmp / f"{name}.so")]
        procs[name] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for name, (cmd, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name} ({' '.join(cmd)}):\n{out.decode(errors='replace')}")
    return {name: tmp / f"{name}.so" for name in texts}


def load(path: Path):
    """The library at ``path`` with the flash attention's C signatures."""
    from prosody_control_french_tts_tpu_torch.ops import kernels

    lib = ctypes.CDLL(str(path))
    for fn, args in kernels._SIGNATURES.items():
        if fn.startswith("flash_attn_"):
            f = getattr(lib, fn)
            f.argtypes = list(args)
            f.restype = ctypes.c_int
    return lib


def measures(got, want, ref) -> dict:
    import chip_smoke as cs

    names = ("fwd", "dq", "dk", "dv")
    return {
        "fa": {n: cs.fa_measure(a, b, r, n != "fwd") for n, a, b, r in zip(names, got, want, ref)},
        "g": {n: cs.g_measure(a, b, r, n != "fwd") for n, a, b, r in zip(names, got, want, ref)},
    }


def verdict(m: dict, lim) -> bool:
    return m["fwd"] <= lim.fwd and all(m[n] <= lim.grad for n in ("dq", "dk", "dv"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "flash_faults.json")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from prosody_control_french_tts_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    results = {"card": card, "limits": {f"{which} {kind}": [lim.fwd, lim.grad, lim.text] for which, limits in
                                        (("FA", cs.FA_LIMITS), ("G", cs.G_LIMITS)) for kind, lim in limits.items()}, "shapes": {}}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: load(p) for name, p in build_all(Path(tmp)).items()}
        rng = np.random.default_rng(args.seed)
        for label, (B, H, L, hd) in SHAPES.items():
            inputs = [torch.from_numpy(rng.standard_normal((B, H, L, hd)).astype(np.float32)).cuda().bfloat16() for _ in range(4)]
            scale = float(hd**-0.5)
            row = {}
            ref = None  # the plain version in float32 on the bf16 inputs upcast, as chip_smoke.py holds them
            for dtype in (torch.float32, torch.bfloat16):
                args_t = [t.to(dtype) for t in inputs]
                want = cs.attn_grads(cs.flash_plain, *args_t, scale)
                ref = ref or want
                for name, lib in libs.items():
                    if dtype == torch.float32 and name != "sound":
                        continue  # the faults are planted in the bfloat16 kernels
                    kernels._LIB = lib
                    got = cs.attn_grads(cs.flash_call, *args_t, scale)
                    torch.cuda.synchronize()
                    if not all(bool(torch.isfinite(t).all()) for t in got):
                        m = {"fa": None, "g": None, "finite": False}
                        passes_fa = passes_g = False
                    else:
                        m = measures(got, want, ref)
                        kind = "bf16" if dtype == torch.bfloat16 else "f32"
                        if kind == "f32":
                            m["fa"] = None  # FA_LIMITS holds float32 to G's measure
                        passes_fa = verdict(m["fa" if kind == "bf16" else "g"], cs.FA_LIMITS[kind])
                        passes_g = verdict(m["g"], cs.G_LIMITS[kind])
                    m.update(passes_fa_limits=passes_fa, passes_g_limits=passes_g)
                    key = f"{name} {str(dtype)[6:]}"
                    row[key] = m
                    fmt = lambda d: "none" if d is None else " ".join(f"{n} {x:.3e}" for n, x in d.items())  # noqa: E731
                    print(f"{label} {(B, H, L, hd)} {key}: FA measure [{fmt(m['fa'])}] pass={passes_fa}; "
                          f"G measure [{fmt(m['g'])}] pass={passes_g}")
                    expect_pass = name == "sound"
                    ok &= passes_fa == expect_pass and (passes_g or not expect_pass)
                    del got
                del want
            results["shapes"][label] = dict(shape=[B, H, L, hd], builds=row)
        kernels._LIB = None
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=1))
    print(json.dumps({"ok": ok, "out": str(args.out)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
