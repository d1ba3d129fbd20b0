#!/usr/bin/env python3
"""Where the pitch-candidate CUDA kernel (kernel A) spends its time.

    python3 tools/pitch_candidates_phases.py [--baseline DIR]

Run from the root of a checkout on a machine with an NVIDIA H100. As
``tools/viterbi_phases.py`` does for kernel B, the split is taken by
subtraction: ``csrc/pitch_candidates.cu`` is built as it is and with one
more piece cut in each further build (the lines marked ``// [phase: ...]``):

- the parabolic step (an entry ranked below k stores its lag and value);
- the rank and the entries' stores (the zero padding stays);
- the compaction (no list in shared memory);
- the detection (no neighbour shuffles: a lag counts where r is above half
  the voicing threshold) -- what is left is the loads, the test that skips
  the rows with no lag above that, one ballot and popcount a register in
  the others, and the stores of the zero padding: "loads only".

Each build runs on the measure path's own r [47,150, 297] (k 14, lags
[73, 295)), taken from ``chip_smoke.py``'s full-width synthetic voice
(seed 0) through ``measure_and_build_ssml``, and is timed by
``chip_smoke.graph_ms`` (a CUDA graph of 20 launches replayed between
events): over two copies of r in turn (2 x 56 MB, past the 50 MB L2), on
one copy, and over two copies of r's voiced rows (those with a lag above
half the voicing threshold, which the kernel does not skip) tiled to the
same shape. The builds are timed in two turns. Only the full build is
checked against the plain version (valid equal, lag_f and strength bit for
bit, on both inputs).
``--baseline DIR`` also builds ``DIR/pitch_candidates.cu`` (for example the
parent commit's ``csrc``, unpacked with ``git archive`` under ``build/``) and
times it in the same turns. The row's maxima counts (mean, largest, rows
past 32) are printed beside.

Prints the card, then one JSON line per build.
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

CUTS = (  # (build label, the phase whose marked lines it removes; cumulative)
    ("no parabola", "parabola"),
    ("no parabola, no rank or entry stores", "rank"),
    ("... and no compaction", "compaction"),
    ("... and no detection: loads only", "detection"),
)
TURNS = 2


def cut(src: str, phase: str, name: str) -> str:
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
        raise SystemExit(f"no line marked {marker!r} in {name}")
    return "\n".join(out) + "\n"


def builds_of(name: str, cuts, baseline: Path | None) -> dict:
    """{label: source text}: the source as it is, each cumulative cut, and
    the baseline directory's copy of ``name``."""
    from prosody_control_french_tts_tpu_torch.ops import kernels

    src = (kernels.CSRC / name).read_text()
    builds = {"full kernel": src}
    text = src
    for label, phase in cuts:
        text = cut(text, phase, name)
        builds[label] = text
    if baseline is not None:
        builds["baseline"] = (baseline / name).read_text()
    return builds


def compile_all(builds: dict, tmp: Path, functions) -> dict:
    """Compile each source into its own shared library (all nvcc processes
    at once, the build's own flags) and load it: {label: ctypes library}."""
    from prosody_control_french_tts_tpu_torch.ops import kernels

    procs = []
    for i, (label, body) in enumerate(builds.items()):
        cu, so = tmp / f"b{i}.cu", tmp / f"b{i}.so"
        cu.write_text(body)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", str(cu), "-o", str(so)]
        procs.append((label, so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for label, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {label}:\n{out.decode(errors='replace')}")
        lib = ctypes.CDLL(str(so))
        for fn in functions:
            getattr(lib, fn).argtypes = list(kernels._SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[label] = lib
    return libs


def measure_path_r():
    """The r [rows, L] and (k, min_lag, max_lag, vth) that the measure path
    hands kernel A for chip_smoke's full-width voice."""
    import chip_smoke
    from prosody_control_french_tts_tpu_torch.core.pipeline import measure_and_build_ssml
    from prosody_control_french_tts_tpu_torch.ops import candidates
    from prosody_control_french_tts_tpu_torch.prosody.adjust import ProsodySettings
    from prosody_control_french_tts_tpu_torch.utils.synth import synth_voice

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        seg_files, tg_dir, raw_dir = synth_voice(tmp / "voice", seed=0, n_segments=chip_smoke.FULL_SEGMENTS)
        with chip_smoke.Capture(candidates, "topk_parabolic") as cap:
            measure_and_build_ssml(seg_files, tg_dir, raw_dir, tmp / "out", ProsodySettings(), "fr-FR-DeniseNeural",
                                   1.0, device="cuda")
    (r, k, min_lag, max_lag, vth), _ = cap.calls[0]
    return r, k, min_lag, max_lag, vth


def maxima_counts(r, min_lag, max_lag, vth) -> dict:
    import torch

    lag = torch.arange(r.shape[1], device=r.device)
    is_max = ((r[:, 1:-1] > r[:, :-2]) & (r[:, 1:-1] >= r[:, 2:]) & (r[:, 1:-1] > 0.5 * vth)
              & (lag[1:-1] >= min_lag) & (lag[1:-1] < max_lag))
    n = is_max.sum(-1)
    return dict(mean=round(float(n.float().mean()), 3), largest=int(n.max()), rows_past_32=int((n > 32).sum()),
                rows_without=int((n == 0).sum()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="a directory holding another pitch_candidates.cu to time beside")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("pitch_candidates_phases: this needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from prosody_control_french_tts_tpu_torch.ops import candidates

    card = chip_smoke.card_line()
    print(card)
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all(builds_of("pitch_candidates.cu", CUTS, args.baseline), Path(tmp), ["pitch_candidates_launch"])
        r, k, min_lag, max_lag, vth = measure_path_r()
        R, L = r.shape
        # the rows with a lag above half the threshold (the voiced frames),
        # tiled to R rows: every row takes the detection
        live = r[(r[:, min_lag - 1:max_lag + 1] > 0.5 * vth).any(-1)]
        voiced = live.repeat(-(-R // live.shape[0]), 1)[:R].contiguous()
        inputs = {"measure r": [r, r.clone()], "voiced rows": [voiced, voiced.clone()]}
        outs = [(torch.empty((R, k), device="cuda"), torch.empty((R, k), device="cuda"),
                 torch.empty((R, k), dtype=torch.uint8, device="cuda")) for _ in range(2)]

        def launcher(lib, copies):
            turn = [0]

            def run():
                i = turn[0] % len(copies)
                turn[0] += 1
                lag_f, strength, valid = outs[i]
                rc = lib.pitch_candidates_launch(copies[i].data_ptr(), lag_f.data_ptr(), strength.data_ptr(),
                                                 valid.data_ptr(), R, L, k, min_lag, max_lag, float(0.5 * vth),
                                                 torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"launch failed: cudaError {rc}")
            return run

        for name, copies in inputs.items():
            want = candidates.topk_parabolic_plain(copies[0], k, min_lag, max_lag, vth)
            for label in ("full kernel", "baseline"):
                if label not in libs:
                    continue
                launcher(libs[label], copies[:1])()
                torch.cuda.synchronize()
                lag_f, strength, valid = outs[0]
                if not (torch.equal(valid.bool(), want[2]) and torch.equal(lag_f, want[0])
                        and torch.equal(strength, want[1])):
                    raise SystemExit(f"the {label} build differs from the plain version on the {name}")
        print(f"checked: the full build{' and the baseline' if 'baseline' in libs else ''} equal to the plain version "
              f"bit for bit on r {tuple(r.shape)} (k {k}, lags [{min_lag}, {max_lag})) and on its {live.shape[0]} "
              f"voiced rows tiled to {R}; maxima per row: {json.dumps(maxima_counts(r, min_lag, max_lag, vth))}")
        times = {label: [] for label in libs}
        for _ in range(TURNS):
            for label, lib in libs.items():
                times[label].append(dict(cold_ms=chip_smoke.graph_ms(launcher(lib, inputs["measure r"]), reps=20),
                                         one_copy_ms=chip_smoke.graph_ms(launcher(lib, inputs["measure r"][:1]), reps=20),
                                         voiced_cold_ms=chip_smoke.graph_ms(launcher(lib, inputs["voiced rows"]), reps=20)))
        for label, turns in times.items():
            print(json.dumps({"build": label, "shape": dict(R=R, L=L, k=k), "turns": turns, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
