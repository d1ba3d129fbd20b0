"""Planted faults in the flash attention's bfloat16 kernels, held to the
limits ``chip_smoke.py`` holds the sound kernel to.

    python3 tools/flash_attention_faults.py [--seed 0] [--out build/flash_faults.json]

Run from the root of a checkout, on a machine with an H100. It compiles
``csrc/flash_attention.cu`` as it is and seven copies of it, each with one
fault planted. The first five sit in the rows of the last quarter of query
tiles (or, for dk/dv, the first quarter of key tiles), where a row averages
the most keys and an error is smallest beside the output:

- ``fwd_tile``: the forward skips key tile qt / 2;
- ``fwd_keys8``: the forward drops 8 keys of key tile qt / 2 (one n8 group
  of the score fragment);
- ``fwd_rescale``: the forward leaves the running sum unrescaled at key tile
  qt / 2;
- ``dq_keys8``: the dq kernel drops 8 keys of its middle key tile from ds;
- ``dkv_queries8``: the dk/dv kernel drops 8 queries of its middle query
  tile;

and two only a grouped-query design can have:

- ``gqa_kv_head``: the forward's query head h reads KV head h // group + 1
  (modulo the KV heads);
- ``gqa_group_sum``: the dk/dv group sum (``flash_dkv_group_sum``) leaves
  out the group's last head.

Each copy is compiled into a temporary directory, never beside the sources,
and loaded in place of the kernel library. On random bfloat16 inputs in the
model's layout through ``flash_attention_gqa``, at the 7B layer shape
(B 2, H 28, KV heads 4, L 1024, hd 128), the bench shape (8, 14, 2, 768, 64)
and (1, 4, 2, 2048, 128), it prints for every build the forward and dq/dk/dv
measures of ``chip_smoke.FA_LIMITS`` in bfloat16 (the forward's row 2-norms,
the gradients' error over the plain bf16 version's, per (b, head)) and of
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

FAULT_ROWS = "(4 * qt >= 3 * (L / BM) && kt == qt / 2)"  # forward: the last quarter of query tiles
FAULT_DQ = "(4 * qt >= 3 * (L / BM) && kt == n_kt / 2)"  # dq: the same query tiles, their middle key tile
FAULT_KEYS = "(4 * jt < L / BM && t == (t0 + nt) / 2)"  # dk/dv: the first quarter of key tiles
FAULTS = {
    "fwd_tile": [(
        "    const bool diag = kt == qt;  // key tile kt and query tile qt share their local indices\n",
        "    const bool diag = kt == qt;  // key tile kt and query tile qt share their local indices\n"
        f"    if {FAULT_ROWS} {{\n      for (int i = 0; i < BM / 2; ++i) s[i] = kNeg;\n    }}\n",
    )],
    "fwd_keys8": [(
        "      s[i] = fast_exp2(fmaf(s[i], c2, -m[(i >> 1) & 1]));",
        f"      s[i] = ({FAULT_ROWS} && (i >> 2) == 3) ? 0.0f : fast_exp2(fmaf(s[i], c2, -m[(i >> 1) & 1]));",
    )],
    "fwd_rescale": [("      l[r] *= alpha[r];", f"      if (!{FAULT_ROWS}) l[r] *= alpha[r];")],
    "dq_keys8": [(
        "const bool masked = mask && k0 + 8 * j + at_.colq + (i & 1) > q0 + at_.row + 8 * r;",
        f"const bool masked = (mask && k0 + 8 * j + at_.colq + (i & 1) > q0 + at_.row + 8 * r) || ({FAULT_DQ} && j == 3);",
    )],
    "dkv_queries8": [(
        "const bool masked = mask && k0 + at_.row + 8 * (i >> 1) > qa + qc;",
        f"const bool masked = (mask && k0 + at_.row + 8 * (i >> 1) > qa + qc) || ({FAULT_KEYS} && j == 1);",
    )],
    "gqa_kv_head": [(
        "      const int kvh = h / group;\n      mbar_expect_tx(bar.once, TILE);",
        "      const int kvh = (h / group + 1) % (H / group);\n      mbar_expect_tx(bar.once, TILE);",
    )],
    "gqa_group_sum": [(
        "  for (int g = 0; g < group; ++g) {\n    const size_t idx",
        "  for (int g = 0; g < group - 1; ++g) {\n    const size_t idx",
    )],
}
# (B, H, KV heads, L, hd)
SHAPES = {"7B": (2, 28, 4, 1024, 128), "bench": (8, 14, 2, 768, 64), "L 2048": (1, 4, 2, 2048, 128)}


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
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-shared", str(cu), "-o", str(tmp / f"{name}.so")]
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
        for label, (B, H, KVH, L, hd) in SHAPES.items():
            inputs = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().bfloat16()
                      for shape in ((B, L, H, hd), (B, L, KVH, hd), (B, L, KVH, hd), (B, L, H, hd))]
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
                    print(f"{label} {(B, H, KVH, L, hd)} {key}: FA measure [{fmt(m['fa'])}] pass={passes_fa}; "
                          f"G measure [{fmt(m['g'])}] pass={passes_g}")
                    expect_pass = name == "sound"
                    ok &= passes_fa == expect_pass and (passes_g or not expect_pass)
                    del got
                del want
            results["shapes"][label] = dict(shape=[B, H, KVH, L, hd], builds=row)
        kernels._LIB = None
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=1))
    print(json.dumps({"ok": ok, "out": str(args.out)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
