#!/usr/bin/env python3
"""Drive the PyTorch port's measure-and-SSML step on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout, on a machine with an NVIDIA H100. It

1. builds the port's CUDA kernels from ``prosody_control_french_tts_tpu_torch/csrc``
   (``nvcc``, into ``build/torch_kernels/``);
2. synthesises a full-width voice from the seed (10 segments of 8–23 s at
   44.1 kHz, word TextGrids, a raw rendering of each segment) and runs
   ``measure_and_build_ssml(..., device="cuda")`` with the kernels' launch
   counts set to 0 just before and read just after;
3. checks the result: finite rows, the three CSVs, every kernel launched,
   a 200 Hz tone read as 200 Hz, and a small voice measured on the card
   agreeing with the plain PyTorch path on the CPU;
4. holds each kernel against its plain PyTorch version on the slice's own
   full-width tensors (kernel A within 1e-6, kernel B exactly);
5. times each kernel, its plain version and, where one exists, one PyTorch
   library call computing the same function, with CUDA events.

It prints the card's name and power limit, one line per kernel, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
Any failed phase raises, and the script exits non-zero. Without a card it
exits non-zero at once and prints no result.
"""

from __future__ import annotations

import argparse
import csv
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
TOL_A = 1e-6  # kernel A vs plain: |lag_f|, |strength| (valid exact)
TOL_B = 0.0  # kernel B vs plain: f0 equal in every frame
FULL_SEGMENTS = 10  # the full-width voice: 10 segments of 8–23 s

KERNEL_A = dict(
    name="pitch_candidates",
    route="cuda",
    source="prosody_control_french_tts_tpu_torch/csrc/pitch_candidates.cu",
    replaces="prosody_control_french_tts_tpu/ops/pallas_kernels.py:307",
)
KERNEL_B = dict(
    name="viterbi",
    route="cuda",
    source="prosody_control_french_tts_tpu_torch/csrc/viterbi.cu",
    replaces="prosody_control_french_tts_tpu/ops/viterbi_pallas.py:180",
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Capture:
    """Wrap a module function to keep the arguments of its calls."""

    def __init__(self, module, name):
        self.module, self.name, self.orig, self.calls = module, name, getattr(module, name), []

    def __enter__(self):
        def wrapper(*a, **k):
            self.calls.append((a, k))
            return self.orig(*a, **k)

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def profile_measure(fn) -> dict:
    """One warm measure step under torch.profiler: wall time, the device
    time of every kernel and copy (one stream, so they do not overlap: busy
    share = their sum / wall) and the heaviest of them by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.name.startswith("Activity Buffer"):
            continue
        slot = by_name.setdefault(ev.name[:90], [0.0, 0])
        slot[0] += ev.time_range.elapsed_us() / 1e3
        slot[1] += 1
    device_ms = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if wall_ms > 0 else None,
        "top_device_ms": [[k, round(t, 4), n] for k, (t, n) in top],
    }


def read_csv(path):
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from prosody_control_french_tts_tpu_torch.core import profiling
    from prosody_control_french_tts_tpu_torch.core.pipeline import CSV_NAMES, measure_and_build_ssml
    from prosody_control_french_tts_tpu_torch.ops import candidates, kernels, pitch, viterbi
    from prosody_control_french_tts_tpu_torch.prosody.adjust import ProsodySettings
    from prosody_control_french_tts_tpu_torch.prosody.measure import bucket_length
    from prosody_control_french_tts_tpu_torch.utils.synth import synth_voice

    card = card_line()
    print(card)
    dev = torch.device("cuda")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s ({kernels.build().name})")

    settings = ProsodySettings()
    voice_name = "fr-FR-DeniseNeural"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # -- 2. full-width voice through the main path ---------------------
        t0 = time.perf_counter()
        seg_files, tg_dir, raw_dir = synth_voice(tmp / "voice", seed=args.seed, n_segments=FULL_SEGMENTS)
        audio_s = 0.0
        longest = 0
        for p in seg_files:
            n = (p.stat().st_size - 44) // 2
            audio_s += n / 44100
            longest = max(longest, n)
        print(f"voice: {len(seg_files)} segments, {audio_s:.1f} s of audio, padded T = {bucket_length(longest)}, "
              f"synthesised in {time.perf_counter() - t0:.1f} s")

        candidates.launches = 0
        viterbi.launches = 0
        profiling.reset_phases()
        t0 = time.perf_counter()
        result = measure_and_build_ssml(seg_files, tg_dir, raw_dir, tmp / "out", settings, voice_name, 1.0, device="cuda")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = {"pitch_candidates": candidates.launches, "viterbi": viterbi.launches}
        cold_phases = dict(profiling.PHASES)
        print(f"main path launches: {json.dumps(launches)}")
        for name, n in launches.items():
            if n < 1:
                raise SystemExit(f"kernel {name} was not launched on the main path")

        # -- 3. checks on the result --------------------------------------
        rows = result.rows
        if not rows:
            raise SystemExit("no syntagme rows")
        vals = np.array([[r.raw_pitch, r.raw_volume, r.raw_rate, r.pitch_smooth, r.rate_smooth] for r in rows])
        if not np.isfinite(vals).all():
            raise SystemExit("non-finite measure rows")
        stats = np.array([[s.p_nat, s.l_nat, s.l_syn] for s in result.seg_stats])
        if not np.isfinite(stats).all() or not (stats[:, 0] > 0).all():
            raise SystemExit(f"bad segment stats {stats}")
        for name in CSV_NAMES:
            got = read_csv(tmp / "out" / name)
            want = len({r.segment for r in rows}) if name == "BDD_ssml.csv" else len(rows)
            if len(got) != want or not all(r["ssml"].startswith("<speak") for r in got):
                raise SystemExit(f"{name}: {len(got)} rows, expected {want}")
        print(f"result: {len(rows)} syntagme rows, segment F0 medians {np.round(stats[:, 0], 1).tolist()} Hz, "
              f"LUFS {np.round(stats[:, 1], 2).tolist()}")

        # warm run, capturing each kernel's full-width inputs
        profiling.reset_phases()
        with Capture(candidates, "topk_parabolic") as cap_a, Capture(viterbi, "viterbi_path") as cap_b:
            t0 = time.perf_counter()
            measure_and_build_ssml(seg_files, tg_dir, raw_dir, tmp / "out2", settings, voice_name, 1.0, device="cuda")
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
        warm_phases = dict(profiling.PHASES)
        trace = profile_measure(lambda: measure_and_build_ssml(
            seg_files, tg_dir, raw_dir, tmp / "out3", settings, voice_name, 1.0, device="cuda"))

        tone = (0.5 * np.sin(2 * np.pi * 200.0 * np.arange(44100) / 44100)).astype(np.float32)
        f0 = pitch.praat_pitch(tone, 44100, device="cuda").f0.cpu().numpy()
        tone_med = float(np.median(f0[f0 > 0]))
        if abs(tone_med - 200.0) > 1.0:
            raise SystemExit(f"200 Hz tone measured at {tone_med} Hz")

        small = synth_voice(tmp / "small", seed=args.seed + 1, n_segments=3, seconds=(1.0, 2.0))
        res_gpu = measure_and_build_ssml(*small, tmp / "sg", settings, voice_name, 1.0, device="cuda")
        res_cpu = measure_and_build_ssml(*small, tmp / "sc", settings, voice_name, 1.0, device="cpu")
        small_err = max(
            max(abs(a.pitch_smooth - b.pitch_smooth), abs(a.rate_smooth - b.rate_smooth), abs(a.raw_volume - b.raw_volume))
            for a, b in zip(res_gpu.rows, res_cpu.rows)
        )
        if len(res_gpu.rows) != len(res_cpu.rows) or small_err > 0.05:
            raise SystemExit(f"small voice: card vs CPU differ by {small_err} points")
        print(f"reference: 200 Hz tone -> {tone_med:.3f} Hz; small voice card vs CPU max |diff| {small_err:.2e} points")

    # -- 4. kernel vs plain on the slice's own tensors ---------------------
    (r, k, min_lag, max_lag, vth), _ = cap_a.calls[0]
    (delta, lf, voiced, freq, vuv, jump), _ = cap_b.calls[0]
    got_a = candidates.topk_parabolic(r, k, min_lag, max_lag, vth)
    want_a = candidates.topk_parabolic_plain(r, k, min_lag, max_lag, vth)
    if not torch.equal(got_a[2], want_a[2]):
        raise SystemExit("kernel A: valid differs from its plain version")
    err_a = max(float((got_a[i] - want_a[i]).abs().max()) for i in (0, 1))
    if err_a > TOL_A:
        raise SystemExit(f"kernel A: max |err| {err_a} > {TOL_A}")
    got_b = viterbi.viterbi_path(delta, lf, voiced, freq, vuv, jump)
    want_b = viterbi.viterbi_path_plain(delta, lf, voiced, freq, vuv, jump)
    err_b = float((got_b - want_b).abs().max())
    if err_b > TOL_B:
        raise SystemExit(f"kernel B: {int((got_b != want_b).sum())} frames differ from its plain version")
    print(f"check: pitch_candidates r {tuple(r.shape)} max |err| {err_a:.3e} (tol {TOL_A}); "
          f"viterbi {tuple(delta.shape)} max |err| {err_b} (exact)")

    # -- 5. timing ---------------------------------------------------------
    R, L = r.shape
    bytes_a = R * L * 4 + R * k * (4 + 4 + 1)
    lag = torch.arange(L, device=dev)
    r_m1 = torch.cat([r[:, :1], r[:, :-1]], -1)
    r_p1 = torch.cat([r[:, 1:], r[:, -1:]], -1)
    score = torch.where((r > r_m1) & (r >= r_p1) & (r > 0.5 * vth) & (lag >= min_lag) & (lag < max_lag), r, float("-inf"))
    ms_a = cuda_ms(lambda: candidates.topk_parabolic(r, k, min_lag, max_lag, vth), reps=50)
    plain_a = cuda_ms(lambda: candidates.topk_parabolic_plain(r, k, min_lag, max_lag, vth), reps=5)
    lib_a = cuda_ms(lambda: torch.topk(score, k, dim=-1), reps=50)

    S, F, K = delta.shape
    bytes_b = S * F * K * (4 + 4 + 1 + 4) + S * F * 4
    ms_b = cuda_ms(lambda: viterbi.viterbi_path(delta, lf, voiced, freq, vuv, jump), reps=20)
    plain_b = cuda_ms(lambda: viterbi.viterbi_path_plain(delta, lf, voiced, freq, vuv, jump), reps=1, warmup=0)

    rows_out = []
    for spec, n, ms, plain_ms, lib_ms, nbytes, err in (
        (KERNEL_A, launches["pitch_candidates"], ms_a, plain_a, lib_a, bytes_a, err_a),
        (KERNEL_B, launches["viterbi"], ms_b, plain_b, None, bytes_b, err_b),
    ):
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows_out.append(dict(spec, launches=n, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                             bound_by="bytes", library_ms=lib_ms, check="pass"))
        print(f"kernel {spec['name']}: ms={ms:.4f} launches={n} bound_ms={bound:.5f} (bytes {nbytes}) "
              f"plain_ms={plain_ms:.3f} library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
              f"max_abs_err={err:.3e} card={card}")

    print(f"measure step (warm): wall {warm_s:.3f} s, {audio_s / warm_s:.1f} audio-s/s; cold {cold_s:.3f} s; card={card}")
    print("phases warm: " + json.dumps({k2: round(v, 4) for k2, v in sorted(warm_phases.items())}))
    print("phases cold: " + json.dumps({k2: round(v, 4) for k2, v in sorted(cold_phases.items())}))
    print("profile (warm measure step): " + json.dumps(trace))
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
