#!/usr/bin/env python3
"""Where the CTC loss kernels (``csrc/ctc_loss.cu``) spend their time.

    python3 tools/ctc_loss_phases.py [--baseline DIR] [--train-ctc ROOT ...]

Run from the root of a checkout on a machine with an NVIDIA H100. As
``tools/ctc_viterbi_phases.py`` does, the split is taken by subtraction:
``csrc/ctc_loss.cu`` is built as it is and with one more piece cut in each
further build (the lines marked ``// [phase: ...]``):

- the hand-off between warps (the waits for a slot, the slot writes and the
  writer's look at its reader), in the forward and the adjoint chain;
- alpha's stores (forward) and d e's (chain);
- the ring loads: the emissions (forward), the weights (chain);
- the weights pass and the column sums (launches that write nothing).

Each build runs at train_ctc's largest step in phase 22 of ``chip_smoke.py``
([T, V] [945, 47], 206 labels: S 413, 945 frames), at train_ctc's 20 s cap
(1,000 frames, 300 labels: S 601) and at S 1,201 (1,000 frames, 600
labels), on log-softmax of random logits from a seed; every launch (the
forward; the weights, chain and column-sum launches of the backward) is
timed alone by ``chip_smoke.graph_ms`` (a CUDA graph of 10 launches) in two
turns. The full build's ptxas report (registers, spills) and the exactness
checks of its two shortcuts (``ctc_loss_exact_checks``) are printed, and at
each shape it is held to the plain version (within chip_smoke's limits).

``--baseline DIR`` also builds ``DIR/ctc_loss.cu``, the first design (one
block, a barrier a frame: ``git show
574f2c3:prosody_control_french_tts_tpu_torch/csrc/ctc_loss.cu``, written to
DIR by hand), times its two launches at the same shapes, and compares the
two designs' loss and d loss / d log_probs bit for bit on the shapes of
``tests/test_torch_kernels.py``'s ``CTC_LOSS_CASES``.

``--train-ctc ROOT`` (repeatable; for example this checkout and the parent
commit unpacked with ``git archive`` under ``build/``) runs phase 22's
``train_ctc_aligner`` (12 synthetic segments, 3 epochs, seed 0) in a
process of its own in each root, in the order given and then in reverse,
and prints its ms a step (CUDA events, after the first epoch).

Prints the card, then one JSON line per build and shape.
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
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "tests"))

from pitch_candidates_phases import TURNS, builds_of, compile_all  # noqa: E402

CUTS = (  # (build label, the phase whose marked lines it removes; cumulative)
    ("no hand-off", "handoff"),
    ("... and no alpha or d e stores", "stores"),
    ("... and no ring loads", "loads"),
    ("... and no weights pass", "weights"),
    ("... and no column sums", "columns"),
)
SHAPES = {  # name: (T, V, labels, frames advanced)
    "train_ctc_largest": (945, 47, 206, 945),
    "train_ctc_cap": (1000, 47, 300, 1000),
    "s1201": (1000, 47, 600, 1000),
}
_VP, _I = ctypes.c_void_p, ctypes.c_int
BASELINE = {  # the first design's interface
    "ctc_loss_fwd_launch": (_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP),
    "ctc_loss_bwd_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP),
}
TRAIN_CTC = r"""
import json, sys, tempfile
from pathlib import Path
root = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(root))
import torch
import chip_smoke as cs
from prosody_control_french_tts_tpu_torch.align.ctc_aligner import CTCAligner
from prosody_control_french_tts_tpu_torch.align.train_ctc import train_ctc_aligner
from prosody_control_french_tts_tpu_torch.audio.corpus import build_natural_corpus
from prosody_control_french_tts_tpu_torch.ops import kernels
kernels.library()
with tempfile.TemporaryDirectory() as tmp:
    tmp = Path(tmp)
    cs.write_sentence_voice(tmp / "data", "synth-fr", cs.TRAIN_CTC_SEGMENTS, 4242)
    build_natural_corpus(tmp / "data", tmp / "corpus")
    with cs.StepClock(CTCAligner, "make_train_step") as clock:
        train_ctc_aligner(tmp / "corpus", tmp / "ctc.npz", epochs=cs.TRAIN_CTC_EPOCHS, seed=0)
        torch.cuda.synchronize()
    print(json.dumps(dict(root=str(root), train_ctc_ms_per_step=clock.ms_per_step(cs.TRAIN_CTC_SEGMENTS),
                          with_first_epoch=clock.ms_per_step(), steps=clock.steps)))
"""


def inputs(T, V, L, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(rng.normal(scale=3.0, size=(T, V)).astype(np.float32)), -1)
    return lp, rng.integers(1, V, size=L).tolist()


class Pair:
    """One build's four launches on one set of buffers."""

    def __init__(self, lib, lp, labels, Tv, label_len, pl):
        import torch

        from prosody_control_french_tts_tpu_torch.ops import ctc_loss

        self.lib, self.lp, self.Tv, self.pl = lib, lp, Tv, pl
        self.T, self.V = lp.shape
        self.S, self.lab = pl.S, label_len
        dev, Sp = lp.device, pl.stride
        self.meta = torch.from_numpy(ctc_loss.host_meta(labels, 0, self.V)).to(dev)
        self.alpha = torch.empty((Tv, Sp), dtype=torch.float32, device=dev)
        self.planes = torch.empty((max(Tv - 1, 1), 4, Sp), dtype=torch.float32, device=dev)
        self.de = torch.empty((Tv, Sp), dtype=torch.float32, device=dev)
        self.loss = torch.empty((), dtype=torch.float32, device=dev)
        self.go = torch.ones((), dtype=torch.float32, device=dev)
        self.dlogp = torch.empty((self.T, self.V), dtype=torch.float32, device=dev)

    def _check(self, rc, name):
        if rc:
            raise SystemExit(f"{name} failed: cudaError {rc}")

    def fwd(self):
        import torch

        m, pl = self.meta, self.pl
        self._check(self.lib.ctc_loss_fwd_launch(
            self.lp.data_ptr(), m.data_ptr(), m[self.S:].data_ptr(), self.alpha.data_ptr(), self.loss.data_ptr(),
            self.T, self.S, self.V, self.Tv, self.lab, pl.warps, pl.stride, torch.cuda.current_stream().cuda_stream),
            "ctc_loss_fwd_launch")

    def weights(self):
        import torch

        self._check(self.lib.ctc_loss_weights_launch(
            self.alpha.data_ptr(), self.meta[self.S:].data_ptr(), self.planes.data_ptr(), self.S, self.Tv,
            self.pl.stride, torch.cuda.current_stream().cuda_stream), "ctc_loss_weights_launch")

    def chain(self):
        import torch

        pl = self.pl
        self._check(self.lib.ctc_loss_chain_launch(
            self.planes.data_ptr(), self.alpha.data_ptr(), self.meta[self.S:].data_ptr(), self.go.data_ptr(),
            self.de.data_ptr(), self.S, self.Tv, self.lab, pl.warps, pl.stride, torch.cuda.current_stream().cuda_stream),
            "ctc_loss_chain_launch")

    def columns(self):
        import torch

        S, V = self.S, self.V
        self._check(self.lib.ctc_loss_columns_launch(
            self.de.data_ptr(), self.meta[2 * S:].data_ptr(), self.meta[2 * S + V + 1:].data_ptr(),
            self.dlogp.data_ptr(), self.T, V, self.Tv, self.pl.stride, torch.cuda.current_stream().cuda_stream),
            "ctc_loss_columns_launch")

    def run(self):
        self.fwd()
        self.weights()
        self.chain()
        self.columns()


def baseline_run(lib, lp, labels, Tv, label_len):
    """The first design's (loss, dlogp) and a function that launches its pair."""
    import torch

    from prosody_control_french_tts_tpu_torch.ops import ctc_loss

    T, V = lp.shape
    S, dev = 2 * len(labels) + 1, lp.device
    meta = torch.from_numpy(ctc_loss.host_meta(labels, 0, V)).to(dev)
    alpha = torch.empty((T, S), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    go = torch.ones((), dtype=torch.float32, device=dev)
    de = torch.empty((Tv, S), dtype=torch.float32, device=dev)
    dlogp = torch.empty((T, V), dtype=torch.float32, device=dev)

    def fwd():
        rc = lib.ctc_loss_fwd_launch(lp.data_ptr(), meta.data_ptr(), meta[S:].data_ptr(), alpha.data_ptr(),
                                     loss.data_ptr(), T, S, V, Tv, label_len, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"baseline forward failed: cudaError {rc}")

    def bwd():
        rc = lib.ctc_loss_bwd_launch(alpha.data_ptr(), meta[S:].data_ptr(), meta[2 * S:].data_ptr(),
                                     meta[2 * S + V + 1:].data_ptr(), go.data_ptr(), de.data_ptr(), dlogp.data_ptr(),
                                     T, S, V, Tv, label_len, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"baseline backward failed: cudaError {rc}")

    return loss, dlogp, fwd, bwd


def bits_equal(a, b) -> bool:
    import torch

    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def ptxas_report(src: str, tmp: Path) -> list:
    """(kernel, registers, spill bytes) of each instantiation, from
    ``nvcc -Xptxas -v``."""
    import re

    from prosody_control_french_tts_tpu_torch.ops import kernels

    cu = tmp / "ptxas.cu"
    cu.write_text(src)
    out = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(cu), "-o",
                          str(tmp / "ptxas.o")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT).stdout.decode()
    rows, name, spill = [], None, 0
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"(fwd|weights|chain|columns|latency_probe)_kernel(?:ILi(\d+)E(?:Lb([01])E)?)?", m.group(1))
            name = (f"{k.group(1)}<{k.group(2)}{',' + k.group(3) if k.group(3) else ''}>" if k and k.group(2)
                    else (k.group(1) if k else m.group(1)))
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="a directory holding the first design's ctc_loss.cu")
    ap.add_argument("--train-ctc", type=Path, action="append", default=[], metavar="ROOT",
                    help="a checkout to run phase 22's train_ctc_aligner in (repeatable)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ctc_loss_phases: this needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from prosody_control_french_tts_tpu_torch.ops import ctc_loss, kernels
    from test_torch_kernels import CTC_LOSS_CASES, CTC_LOSS_LAYOUT_CASES, _ctc_loss_inputs

    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    builds = builds_of("ctc_loss.cu", CUTS, args.baseline)
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all(builds, Path(tmp), [])
        print(json.dumps({"ptxas": ptxas_report(builds["full kernel"], Path(tmp)), "card": card}), flush=True)
    for label, lib in libs.items():
        names = BASELINE if label == "baseline" else {fn: sig for fn, sig in kernels._SIGNATURES.items()
                                                     if fn.startswith("ctc_loss")}
        for fn, sig in names.items():
            getattr(lib, fn).argtypes = list(sig)
            getattr(lib, fn).restype = ctypes.c_int
    new = libs["full kernel"]
    mism = torch.zeros(2, dtype=torch.int64, device=dev)
    new.ctc_loss_exact_checks(mism.data_ptr(), torch.cuda.current_stream().cuda_stream)
    print(json.dumps({"check": "log1p_unit against log1pf on [0, 1]; lae_neg against lae(x, NEG) on every float",
                      "mismatches": mism.tolist()}), flush=True)

    # the first design against this one, bit for bit, on the kernel tests' shapes
    if "baseline" in libs:
        for T, V, L, inp, lab, labels in CTC_LOSS_CASES + CTC_LOSS_LAYOUT_CASES:
            lp, lab_t = _ctc_loss_inputs(T, V, L, T + L, labels)
            lp, labels_l, Tv = lp.to(dev), lab_t.tolist(), ctc_loss._frames(T, inp)
            old_loss, old_d, old_f, old_b = baseline_run(libs["baseline"], lp, labels_l, Tv, lab)
            old_f()
            old_b()
            pair = Pair(new, lp, labels_l, Tv, lab, ctc_loss.plan(2 * L + 1))
            pair.run()
            torch.cuda.synchronize()
            print(json.dumps({"build": "this design vs the first, bit for bit", "case": [T, V, L, inp, lab],
                              "loss_equal": bits_equal(pair.loss, old_loss),
                              "dlogp_equal": bits_equal(pair.dlogp, old_d),
                              "loss": [float(pair.loss), float(old_loss)],
                              "dlogp_max_abs_diff": float((pair.dlogp - old_d).abs().max())}), flush=True)

    for shape, (T, V, L, Tv) in SHAPES.items():
        lp, labels = inputs(T, V, L, seed=len(shape))
        lp = lp.to(dev)
        S = 2 * L + 1
        pl0 = ctc_loss.plan(S)
        rel, gerr = chip_smoke.check_ctc_loss(lp, labels, Tv, L, f"ctc_loss_phases {shape}")
        print(f"checked: within the plain version's limits (loss rel {rel:.2e}, gradient {gerr:.2e} of its scale) "
              f"at {shape}: [T, V] [{T}, {V}], S {S}, {Tv} frames; {pl0}", flush=True)

        runs = {}  # label: {launch: fn}
        for label, lib in libs.items():
            if label == "baseline":
                continue
            p = Pair(lib, lp, labels, Tv, L, pl0)
            p.run()
            runs[label] = dict(forward=p.fwd, weights=p.weights, chain=p.chain, columns=p.columns)
        if "baseline" in libs:
            _, _, old_f, old_b = baseline_run(libs["baseline"], lp, labels, Tv, L)
            old_f()
            old_b()
            runs["baseline (the first design)"] = dict(forward=old_f, backward=old_b)
        times = {label: {k: [] for k in fns} for label, fns in runs.items()}
        for _ in range(TURNS):
            for label, fns in runs.items():
                for k, fn in fns.items():
                    times[label][k].append(chip_smoke.graph_ms(fn, reps=10))
        for label, t in times.items():
            print(json.dumps({"build": label, "shape": shape, "T_V_S_Tv": [T, V, S, Tv], "ms": t,
                              "ns_per_frame": {k: [x * 1e6 / max(Tv - 1, 1) for x in v] for k, v in t.items()},
                              "card": card}), flush=True)

    for root in [r.resolve() for r in args.train_ctc + args.train_ctc[::-1]]:
        res = subprocess.run([sys.executable, "-c", TRAIN_CTC, str(root)], cwd=str(root), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE)
        if res.returncode != 0:
            raise SystemExit(f"train_ctc in {root} failed:\n{res.stderr.decode()[-4000:]}")
        line = res.stdout.decode().strip().splitlines()[-1]
        print(json.dumps({"build": "train_ctc ms a step", **json.loads(line), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
