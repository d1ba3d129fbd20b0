#!/usr/bin/env python3
"""Where the CTC forced-alignment CUDA kernel (``csrc/ctc_viterbi.cu``)
spends its time.

    python3 tools/ctc_viterbi_phases.py [--baseline DIR]

Run from the root of a checkout on a machine with an NVIDIA H100. As
``tools/mask_ema_phases.py`` does, the split is taken by subtraction:
``csrc/ctc_viterbi.cu`` is built as it is and with one more piece cut in
each further build (the lines marked ``// [phase: ...]``):

- the backtrack (the windows' staging and the walk; the states of the frames
  it walks are not written);
- the packed pointer stores;
- the hand-off (lane 0's reads of the warp before it, lane 31's writes, the
  barrier that ends each frame; the frames then run unsynchronised);
- the chain (the recurrence's add; what only fed it, the gather, goes too);
- the ring's loads (the asynchronous tile copies and the gather), which
  leaves the launch, the set-up and the frame loop's bookkeeping.

Each build runs at the shape of the CTC pipeline's Final Transcribe in
``chip_smoke.py`` (log-probs [13,108, 47], 1,632 labels: S 3,265, 7,673
frames advanced) and at a segment's (log-probs [1,024, 47], 150 labels,
750 frames advanced), on log-softmax of random logits from a seed (the
kernel does the same work whatever the values), and is timed by
``chip_smoke.graph_ms`` (a CUDA graph of 10 launches) in two turns. The full
build also runs with every instantiation that fits S (2, 4, 8 or 16 states
a thread) on clusters of 1, 2, 4 and 8 blocks, to choose the defaults, and
with its frame loop unrolled by 1, 4 and 8 instead of 2. ``ctc_forced_align`` is timed as a whole
call (host wall, synchronised). ``--baseline DIR`` also builds
``DIR/ctc_viterbi.cu``, the design that read gathered emissions [T, S] (the
interface of ``git show 2f17a36:prosody_control_french_tts_tpu_torch/csrc/ctc_viterbi.cu``),
and times it alone and with the gather ``log_probs[:, ext]`` that its
caller made. The full build, its unrollings and the baseline are checked
against the plain version (states and score bit for bit). A clocked copy of the full build
(``clock64()`` counters patched in at the lines ``CLOCK_PATCHES`` names)
runs once a shape at the defaults and prints, per frame, the forward loop's
cycles (mean over the warps, first and last warp), those spent reading the
predecessor's slot (its wait included) and at the tile barriers, and the
backtrack's cycles.

Prints the card, then one JSON line per build and shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from pitch_candidates_phases import TURNS, builds_of, compile_all  # noqa: E402

CUTS = (  # (build label, the phase whose marked lines it removes; cumulative)
    ("no backtrack", "backtrack"),
    ("... and no pointer stores", "stores"),
    ("... and no hand-off (no barrier a frame)", "handoff"),
    ("... and no chain", "chain"),
    ("... and no ring loads or gather", "loads"),
)
UNROLLS = (1, 4, 8)  # other unrollings of the frame loop, timed at the defaults beside its 2
SHAPES = {  # name: (T, V, labels, frames advanced)
    "final_transcribe": (13108, 47, 1632, 7673),
    "segment": (1024, 47, 150, 750),
}
_VP, _I = ctypes.c_void_p, ctypes.c_int
BASELINE_LAUNCH = (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP)  # emit, skip, inp, lab, back, states, score, B, T, S


# The clocked build: clock64() counters patched into a copy of the source at
# these lines (each must be found once): per warp, the forward loop's cycles,
# those spent reading the predecessor's slot (the wait for it included) and
# those at the tile barriers; the backtrack's cycles in block 0.
CLOCK_PATCHES = (
    ("namespace cg = cooperative_groups;",
     "namespace cg = cooperative_groups;\n__device__ unsigned long long g_clk[2048][4];"),
    ("  const int tile_floats = TF * V;",
     "  long long c_loop0 = clock64(), c_wait = 0, c_bar = 0;\n  const int tile_floats = TF * V;"),
    ("      const unsigned want = (unsigned)(t - 1);",
     "      const unsigned want = (unsigned)(t - 1);\n      const long long cw0 = clock64();"),
    ("      if (lane == 0) {\n        p2 = __uint_as_float((unsigned)x);",
     "      c_wait += clock64() - cw0;\n      if (lane == 0) {\n        p2 = __uint_as_float((unsigned)x);"),
    ("    __pipeline_wait_prior(kTiles - 2);  // tile m + 1 has landed\n    __syncthreads();",
     "    const long long cb0 = clock64();\n    __pipeline_wait_prior(kTiles - 2);\n    __syncthreads();\n    c_bar += clock64() - cb0;"),
    ("  __pipeline_wait_prior(0);\n  if (acc_frames > 0)",
     "  if (lane == 0) {\n    unsigned long long* g = g_clk[k * warps + warp];\n    g[0] = clock64() - c_loop0;\n"
     "    g[1] = c_wait;\n    g[2] = c_bar;\n  }\n  __pipeline_wait_prior(0);\n  if (acc_frames > 0)"),
    ("  int st = last;\n  int ref = last;", "  const long long c_bt0 = clock64();\n  int st = last;\n  int ref = last;"),
    ("    st = cur_state[i & 1];\n  }\n}", "    st = cur_state[i & 1];\n  }\n  if (tid == 0) g_clk[2047][0] = clock64() - c_bt0;\n}"),
)


def clocked_source(src: str) -> str:
    for old, new in CLOCK_PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"the clocked build's anchor is not in ctc_viterbi.cu once: {old!r}")
        src = src.replace(old, new)
    return src + ('\nextern "C" int ctc_viterbi_clocks(void* dst) '
                  '{ return (int)cudaMemcpyFromSymbol(dst, g_clk, sizeof(g_clk)); }\n')


def inputs(T, V, L, Tv, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(rng.normal(scale=3.0, size=(T, V)).astype(np.float32)), -1)
    labels = torch.from_numpy(rng.integers(1, V, size=L).astype(np.int64))
    return lp, labels, Tv


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="a directory holding the earlier ctc_viterbi.cu to time beside")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ctc_viterbi_phases: this needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from prosody_control_french_tts_tpu_torch.ops import ctc_viterbi, kernels

    card = chip_smoke.card_line()
    print(card)
    dev = torch.device("cuda")
    builds = builds_of("ctc_viterbi.cu", CUTS, args.baseline)
    builds["clocked"] = clocked_source(builds["full kernel"])
    unroll = "#pragma unroll 2  // two frames a pass"
    if builds["full kernel"].count(unroll) != 1:
        raise SystemExit(f"no line {unroll!r} once in ctc_viterbi.cu")
    for n in UNROLLS:
        builds[f"frames unrolled by {n}"] = builds["full kernel"].replace(unroll, f"#pragma unroll {n}  //")
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all(builds, Path(tmp), [])
    clocked = libs.pop("clocked")
    clocked.ctc_viterbi_clocks.argtypes = [ctypes.c_void_p]
    for fn in ("ctc_viterbi_launch", "ctc_viterbi_back_words"):
        getattr(clocked, fn).argtypes = list(kernels._SIGNATURES[fn])
        getattr(clocked, fn).restype = kernels._RESTYPES.get(fn, ctypes.c_int)
    for label, lib in libs.items():
        names = {"ctc_viterbi_launch": BASELINE_LAUNCH} if label == "baseline" else kernels._SIGNATURES
        for fn, sig in names.items():
            if fn.startswith("ctc_viterbi"):
                getattr(lib, fn).argtypes = list(sig)
                getattr(lib, fn).restype = kernels._RESTYPES.get(fn, ctypes.c_int)
    new = libs["full kernel"]
    for shape, (T, V, L, Tv) in SHAPES.items():
        lp, labels, Tv = inputs(T, V, L, Tv, seed=len(shape))
        ext, skip = ctc_viterbi._states(labels, 0)
        S = ext.shape[0]
        want_states, want_score = ctc_viterbi.ctc_forced_align_plain(lp, labels, Tv, L)
        lp_d = lp[None].to(dev)
        meta = torch.cat([torch.tensor([Tv, L]), ext, skip.long()]).int().to(dev)
        states = torch.empty((1, T), dtype=torch.int32, device=dev)
        score = torch.empty((1,), dtype=torch.float32, device=dev)

        def new_launcher(lib, kK, C):
            back = torch.empty((1, new.ctc_viterbi_back_words(T, S, kK, C)), dtype=torch.int32, device=dev)

            def run():
                rc = lib.ctc_viterbi_launch(lp_d.data_ptr(), meta[2:].data_ptr(), meta[2 + S:].data_ptr(), meta.data_ptr(),
                                            meta[1:].data_ptr(), back.data_ptr(), states.data_ptr(), score.data_ptr(), 1,
                                            T, S, V, kK, C, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"launch failed: cudaError {rc}")
            return run

        ext_d, skip_u8 = ext.to(dev), skip.to(dev, torch.uint8)[None]
        back_old = torch.empty((1, T - 1, S), dtype=torch.int8, device=dev)
        emit_d = lp_d[0][:, ext_d][None].contiguous()

        def old_launcher(gather):
            def run():
                emit = lp_d[0][:, ext_d][None].contiguous() if gather else emit_d
                rc = libs["baseline"].ctc_viterbi_launch(emit.data_ptr(), skip_u8.data_ptr(), meta.data_ptr(),
                                                         meta[1:].data_ptr(), back_old.data_ptr(), states.data_ptr(),
                                                         score.data_ptr(), 1, T, S,
                                                         torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"baseline launch failed: cudaError {rc}")
            return run

        kK0 = new.ctc_viterbi_states_per_thread(S)
        C0 = new.ctc_viterbi_cluster_blocks(S, kK0)
        runs = {f"{label} (kK {kK0}, C {C0})": new_launcher(lib, kK0, C0) for label, lib in libs.items()
                if label != "baseline"}  # the full kernel, each cut, each unrolling
        for kK in (2, 4, 8, 16):
            for C in (1, 2, 4, 8):
                if (kK, C) != (kK0, C0) and -(-(-(-S // kK)) // C) <= 256:
                    runs[f"full kernel (kK {kK}, C {C})"] = new_launcher(new, kK, C)
        if "baseline" in libs:
            runs["baseline: kernel alone"] = old_launcher(False)
            runs["baseline: gather and kernel"] = old_launcher(True)
        for label, run in runs.items():
            if label.startswith(("full kernel", "baseline", "frames unrolled")):
                states.zero_()
                run()
                torch.cuda.synchronize()
                if not torch.equal(states[0].cpu(), want_states) or score.cpu().view(torch.int32) != want_score.view(torch.int32):
                    raise SystemExit(f"{label} differs from the plain version at {shape}")
        print(f"checked: every full-kernel instantiation{' and the baseline' if 'baseline' in libs else ''} equal to the "
              f"plain version (states and score bit for bit) at {shape}: [T, V] [{T}, {V}], S {S}, {Tv} frames advanced")
        times = {label: [] for label in runs}
        calls = []
        for _ in range(TURNS):
            for label, run in runs.items():
                ms = chip_smoke.graph_ms(run, reps=10)
                times[label].append(dict(ms=ms, ns_per_frame=ms * 1e6 / max(Tv - 1, 1)))
            lp0 = lp_d[0]
            ctc_viterbi.ctc_forced_align(lp0, labels, Tv, L)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                ctc_viterbi.ctc_forced_align(lp0, labels, Tv, L)
            torch.cuda.synchronize()
            calls.append((time.perf_counter() - t0) * 100)
        for label, turns in times.items():
            print(json.dumps({"build": label, "shape": shape, "T_V_S_Tv": [T, V, S, Tv], "turns": turns, "card": card}))
        print(json.dumps({"build": "ctc_forced_align, whole call (host wall, synchronised)", "shape": shape,
                          "ms": calls, "card": card}))
        # the clocked build at the defaults: cycles a frame, per warp
        new_launcher(clocked, kK0, C0)()
        torch.cuda.synchronize()
        clk = (ctypes.c_ulonglong * (2048 * 4))()
        kernels.check(clocked.ctc_viterbi_clocks(ctypes.addressof(clk)), "ctc_viterbi_clocks")
        warps = C0 * ((-(-(-(-S // kK0)) // C0) + 31) // 32)
        per = [[clk[4 * w + j] / max(Tv - 1, 1) for j in range(3)] for w in range(warps)]
        mean = [sum(r[j] for r in per) / warps for j in range(3)]
        print(json.dumps({"build": f"clocked (kK {kK0}, C {C0})", "shape": shape, "warps": warps,
                          "cycles_per_frame_mean": dict(forward=mean[0], slot_read_and_wait=mean[1],
                                                        tile_barriers=mean[2]),
                          "forward_first_warp": per[0][0], "forward_last_warp": per[-1][0],
                          "backtrack_cycles_per_frame": clk[4 * 2047] / max(Tv - 2, 1), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
