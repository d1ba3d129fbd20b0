"""The port's parallel layer over four ranks: four OS processes in one
``gloo`` process group on the CPU, held to the JAX package's meshes on the
conftest's 8 virtual CPU devices.

The ranks are launched once for the module (``ranks``); this file is also
their program (the ``__main__`` branch at the bottom, which imports no JAX).
Each rank runs every case and writes its results to an npz; the tests assert
over them. Meanwhile the test process runs the JAX side (``measure_sharded``
and ``shard_train_inputs`` + ``make_train_step`` on ``make_mesh(data=2,
model=2)``) and the port's single-process step on the same inputs.

- ``initialize`` from the ``PCFT_*`` variables; ``hybrid_mesh`` with
  ``LOCAL_WORLD_SIZE=2``; ``host_local_batch_slice`` cut per host as JAX
  cuts per process, with ``LOCAL_WORLD_SIZE=2`` (two hosts of two ranks) and
  with it unset (one host), and a cross-rank sum of its rows;
- ``measure_sharded`` on meshes (2, 2) and (4, 1), S 3 (one padded row):
  F0 within 1e-3 relative and LUFS within 0.01 dB of JAX, equal to the
  port's unsharded passes;
- the forward over int8, int8b and NF4 projections sharded on (2, 2)
  against the unsharded quantized model;
- the dp×tp LoRA step at the training parity shape, B 4, L 128, 3 steps, from
  JAX's initialisation: (dot, dense) and (vmem, fused) against JAX and the
  port's single-process step, (flash, fused), a ("dcn", "data", "model")
  mesh and ``accum=2`` against the single-process step; replicated leaves
  bit-identical on the four ranks, frozen leaves unchanged. The mask counts
  different numbers of positions on the two batch ranks, so a mean of the
  ranks' means would show.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
# tests/test_torch_training.py's parity shape and learning rate
PARITY = dict(vocab_size=1024, dim=128, layers=2, heads=4, kv_heads=2, ffn=256, max_len=128, lora_rank=4)
LR = 1e-3
STEPS = 3
B, L = 4, 128
# case → (attn_impl, loss_impl, mesh, accum)
CASES = {
    "dot-dense": ("dot", "dense", "2x2", 1),
    "vmem-fused": ("vmem", "fused", "2x2", 1),
    "flash-fused": ("flash", "fused", "2x2", 1),
    "hybrid-dot-dense": ("dot", "dense", "hybrid", 1),
    "accum2-dot-dense": ("dot", "dense", "2x2", 2),
}
JAX_CASES = ("dot-dense", "vmem-fused")
QUANTS = ("int8", "int8b", "nf4")
RANK_TIMEOUT_S = 240
# global batches for host_local_batch_slice: even, with a remainder, fewer rows than ranks
SLICE_BATCHES = (8, 9, 3)


def train_batches():
    """ids [STEPS + 1, B, L] (accum cases take a new batch a call) and a
    mask whose two halves of the batch count different numbers of
    positions."""
    ids = np.random.default_rng(0).integers(1, PARITY["vocab_size"], (STEPS + 1, B, L)).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    mask[0, :96] = 0
    mask[1, :40] = 0
    mask[3, -10:] = 0
    return ids, mask


def measure_batch():
    """tests/test_cascade_and_dist.py's sharded-measure inputs: S 3."""
    rng = np.random.default_rng(0)
    sr = 22050
    S, T, N = 3, 1 << 15, 4
    t = np.arange(T) / sr
    nat = np.stack([(0.4 * np.sin(2 * np.pi * f * t) * (rng.random(T) < 0.97)).astype(np.float32) for f in (180.0, 220.0, 260.0)])
    lens = np.array([T, T - 2000, T - 4000], np.int32)
    for i, n in enumerate(lens):
        nat[i, n:] = 0
    win = np.zeros((S, N, 2), np.int32)
    mask = np.zeros((S, N), bool)
    for i in range(S):
        step = int(lens[i]) // N
        for j in range(N):
            win[i, j] = (j * step, (j + 1) * step)
            mask[i, j] = True
    return sr, (nat, lens, nat, lens, win, win, mask)


def step_count(accum: int) -> int:
    return STEPS + 1 if accum > 1 else STEPS


def batch_for(ids, i: int, accum: int):
    return ids[i] if accum > 1 else ids[0]


# ---------------------------------------------------------------------------
# the rank program (no JAX)
# ---------------------------------------------------------------------------


def torch_trainer(weights: dict, attn_impl: str, loss_impl: str, accum: int):
    import torch

    from prosody_control_french_tts_tpu_torch.models import llm, training

    cfg = llm.LLMConfig(**PARITY, dtype=torch.float32, attn_impl=attn_impl)
    model, tx, state = training.init_train(cfg, lr=LR, accum=accum, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return model, tx, state


def run_case(weights, case: str, mesh=None):
    """The case's steps, sharded on ``mesh`` or in one process: (losses,
    the model's state_dict as numpy, the trainable mask, whether every frozen
    leaf kept its bits)."""
    import torch

    from prosody_control_french_tts_tpu_torch.models import training

    attn_impl, loss_impl, _, accum = CASES[case]
    model, tx, state = torch_trainer(weights, attn_impl, loss_impl, accum)
    ids, mask = train_batches()
    losses = []
    shard = (lambda i, m: training.shard_train_inputs(mesh, model, tx, i, m)) if mesh is not None else (lambda i, m: (i, m))
    shard(ids[0], mask)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = training.make_train_step(model, tx, trainable=state.mask, loss_impl=loss_impl)
    assert step.loss_impl == loss_impl
    for i in range(step_count(accum)):
        losses.append(float(step(*shard(batch_for(ids, i, accum), mask))))
    after = model.state_dict()
    frozen_same = all(torch.equal(after[k], before[k]) for k in after if not state.mask[k])
    return np.array(losses), {k: v.numpy().copy() for k, v in after.items()}, state.mask, frozen_same


def quantized_logits(weights: dict, quant: str, mesh=None) -> np.ndarray:
    """Logits of the parity model with its projections stored ``quant``
    (int8b: NF4 recoded for serving) on one batch, float32; sharded on
    ``mesh``, the vocabulary blocks gathered over "model"."""
    import torch
    import torch.distributed as dist

    from prosody_control_french_tts_tpu_torch.models import llm, quant as tquant
    from prosody_control_french_tts_tpu_torch.parallel.sharding import shard_params

    sd = tquant.quantize_params({k: torch.from_numpy(v) for k, v in weights.items()}, "int8" if quant == "int8" else "nf4")
    if quant == "int8b":
        sd = tquant.recode_params_nf4_serving(sd)
    model = llm.DecoderLM(llm.LLMConfig(**PARITY, dtype=torch.float32, quant=quant), device="cpu")
    model.load_state_dict(sd)
    ids = torch.from_numpy(train_batches()[0][0])
    with torch.no_grad():
        if mesh is None:
            return model(ids).numpy()
        shards = shard_params(model, mesh)
        local = model(ids).contiguous()
        parts = [torch.empty_like(local) for _ in range(shards.model_size)]
        dist.all_gather(parts, local, group=shards.model_group)
        return torch.cat(parts, dim=-1).numpy()


def rank_main(inputs: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from prosody_control_french_tts_tpu_torch.ops.pitch import PitchParams
    from prosody_control_french_tts_tpu_torch.parallel import make_mesh
    from prosody_control_french_tts_tpu_torch.parallel.distributed import host_local_batch_slice, hybrid_mesh, initialize
    from prosody_control_french_tts_tpu_torch.parallel.measure_sharded import measure_sharded
    from prosody_control_french_tts_tpu_torch.prosody.measure import measure_nat, measure_raw

    out: dict[str, np.ndarray] = {}
    t0 = time.perf_counter()
    out["initialized"] = np.array(initialize(device="cpu", timeout_s=60))
    rank = dist.get_rank()
    out["world"] = np.array(dist.get_world_size())
    out["backend"] = np.array(dist.get_backend())
    out["hybrid_shape"] = np.array(hybrid_mesh(device="cpu").mesh.shape)
    out["hybrid_model2_shape"] = np.array(hybrid_mesh(model=2, device="cpu").mesh.shape)

    full = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    local = torch.from_numpy(full[host_local_batch_slice(8)].copy())
    total = local.sum()
    dist.all_reduce(total)
    out["batch_sum"] = np.array(float(total))
    out["host_slices_local2"] = np.array([(sl.start, sl.stop) for sl in map(host_local_batch_slice, SLICE_BATCHES)])
    local_world = os.environ.pop("LOCAL_WORLD_SIZE")
    out["host_slices_unset"] = np.array([(sl.start, sl.stop) for sl in map(host_local_batch_slice, SLICE_BATCHES)])
    os.environ["LOCAL_WORLD_SIZE"] = local_world

    sr, args = measure_batch()
    for label, shape in (("2x2", (2, 2)), ("4x1", (4, 1))):
        res = measure_sharded(make_mesh(*shape, device="cpu"), *args, rate=sr)
        for k, a in enumerate(res):
            out[f"measure_{label}_{k}"] = a
    if rank == 0:
        nat, lens, raw, raw_len, win, win_raw, mask = (torch.from_numpy(np.asarray(a)) for a in args)
        pp = PitchParams()
        one = (*measure_nat(nat, lens.long(), win.long(), mask, float(sr), nat.shape[1], pp),
               *measure_raw(raw, raw_len.long(), win_raw.long(), float(sr), raw.shape[1]))
        for k, a in enumerate(one):
            out[f"measure_single_{k}"] = a.numpy()

    weights = dict(np.load(Path(inputs) / "weights.npz"))
    for quant in QUANTS:
        out[f"quant_{quant}"] = quantized_logits(weights, quant, make_mesh(2, 2, device="cpu"))
    for case, (_, _, mesh_kind, _) in CASES.items():
        mesh = hybrid_mesh(model=2, device="cpu") if mesh_kind == "hybrid" else make_mesh(2, 2, device="cpu")
        losses, state, trainable, frozen_same = run_case(weights, case, mesh)
        out[f"{case}/losses"] = losses
        out[f"{case}/frozen_same"] = np.array(frozen_same)
        for k, v in state.items():
            if trainable[k]:
                out[f"{case}/{k}"] = v
    out["jax_loaded"] = np.array("jax" in sys.modules or "prosody_control_french_tts_tpu" in sys.modules)
    out["seconds"] = np.array(time.perf_counter() - t0)
    dist.barrier()
    dist.destroy_process_group()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

import pytest  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jax_runs() -> dict:
    """The JAX package on make_mesh(data=2, model=2): measure_sharded, and
    the (dot, dense) and (vmem, fused) steps from its own initialisation."""
    import jax
    import jax.numpy as jnp

    from prosody_control_french_tts_tpu.models import llm as jllm, training as jtraining
    from prosody_control_french_tts_tpu.parallel.measure_sharded import measure_sharded
    from prosody_control_french_tts_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(data=2, model=2)
    sr, args = measure_batch()
    out = {"measure": measure_sharded(mesh, *args, rate=sr)}
    ids, mask = train_batches()
    for case in JAX_CASES:
        attn_impl, loss_impl, _, _ = CASES[case]
        cfg = jllm.LLMConfig(**PARITY, dtype=jnp.float32, attn_impl=attn_impl)
        model, tx, state = jtraining.init_train(cfg, lr=LR)
        step = jtraining.make_train_step(model, tx, donate=False, trainable=state.mask, loss_impl=loss_impl)
        p, o, i, m = jtraining.shard_train_inputs(mesh, state.params, state.opt_state, jnp.asarray(ids[0]), jnp.asarray(mask))
        losses = []
        with mesh:
            for _ in range(STEPS):
                p, o, loss = step(p, o, i, m)
                losses.append(float(loss))
        out[case] = (np.array(losses), jax.tree.map(np.asarray, p))
    return out


def jax_init_weights(path: Path) -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    from prosody_control_french_tts_tpu.models import llm as jllm, training as jtraining
    from prosody_control_french_tts_tpu_torch import convert
    from prosody_control_french_tts_tpu_torch.models import llm

    _, _, state = jtraining.init_train(jllm.LLMConfig(**PARITY, dtype=jnp.float32), lr=LR)
    sd = convert.llm_params_from_jax(jax.tree.map(np.asarray, state.params), llm.LLMConfig(**PARITY, dtype=torch.float32))
    weights = {k: v.numpy() for k, v in sd.items()}
    np.savez(path, **weights)
    return weights


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Launch the four ranks, run the JAX side and the single-process port
    meanwhile, and collect everything."""
    import torch

    tmp = tmp_path_factory.mktemp("ranks")
    weights = jax_init_weights(tmp / "weights.npz")
    env = dict(os.environ, PCFT_NUM_PROCESSES=str(WORLD), PCFT_COORDINATOR=f"127.0.0.1:{_free_port()}",
               LOCAL_WORLD_SIZE="2", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    env.pop("PCFT_DATA_MESH", None)
    procs, logs = [], [tmp / f"rank{r}.log" for r in range(WORLD)]
    for r in range(WORLD):
        with open(logs[r], "w") as log:  # a file, not a pipe: a rank never blocks on its output
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(tmp), str(tmp)],
                                          env=dict(env, PCFT_PROCESS_ID=str(r)), cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
    t0 = time.perf_counter()
    try:
        jax_out = jax_runs()
        single = {case: run_case(weights, case) for case in CASES}
        quant_single = {quant: quantized_logits(weights, quant) for quant in QUANTS}
        # until all ranks end, one fails (the others are then killed) or the time is up
        while any(p.poll() is None for p in procs) and time.perf_counter() - t0 < RANK_TIMEOUT_S:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed (rc={p.returncode}):\n{logs[r].read_text()[-6000:]}"
    per_rank = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return dict(ranks=per_rank, jax=jax_out, single=single, quant_single=quant_single, weights=weights)


def test_ranks_initialize_from_the_environment(ranks):
    for r, out in enumerate(ranks["ranks"]):
        assert out["initialized"] and out["world"] == WORLD and str(out["backend"]) == "gloo", r
        assert not out["jax_loaded"], r


def test_hybrid_mesh_shapes(ranks):
    """LOCAL_WORLD_SIZE=2: two slices of two ranks; model=2 leaves data 1."""
    for out in ranks["ranks"]:
        assert tuple(out["hybrid_shape"]) == (2, 2, 1)
        assert tuple(out["hybrid_model2_shape"]) == (2, 1, 2)


def test_host_local_rows_sum_to_the_full_batch(ranks):
    """With two hosts of two ranks, each host's rows are summed once per
    rank of the host: the cross-rank sum is twice the full batch's, and the
    first rank of each host holds half of it."""
    full = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    assert {float(out["batch_sum"]) for out in ranks["ranks"]} == {2 * float(full.sum())}
    halves = [full[slice(*ranks["ranks"][r]["host_slices_local2"][0])].sum() for r in (0, 2)]
    assert float(sum(halves)) == float(full.sum())


@pytest.mark.parametrize("label,hosts", [("local2", 2), ("unset", 1)])
def test_host_local_batch_slice_cuts_per_host_like_jax(ranks, monkeypatch, label, hosts):
    """Every rank's rows are those the JAX package's host_local_batch_slice
    gives the process of its host (host = rank // LOCAL_WORLD_SIZE): the
    ranks of a host get the same rows, the last host the remainder, and one
    host (LOCAL_WORLD_SIZE unset) the whole batch."""
    import jax

    from prosody_control_french_tts_tpu.parallel import distributed as jdist

    per_host = WORLD // hosts
    for r, out in enumerate(ranks["ranks"]):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r // per_host)
        monkeypatch.setattr(jax, "process_count", lambda: hosts)
        want = [jdist.host_local_batch_slice(b) for b in SLICE_BATCHES]
        got = out[f"host_slices_{label}"]
        assert [tuple(g) for g in got] == [(w.start, w.stop) for w in want], (label, r)
    if hosts == 1:
        assert all((tuple(g) == (0, b)) for g, b in zip(ranks["ranks"][3]["host_slices_unset"], SLICE_BATCHES))


@pytest.mark.parametrize("label", ["2x2", "4x1"])
def test_measure_sharded_matches_jax_and_the_unsharded_passes(ranks, label):
    """Every rank returns the same six arrays; F0 within 1e-3 relative and
    LUFS within 0.01 dB of the JAX package's measure_sharded on
    make_mesh(data=2, model=2) (tests/test_torch_measure.py's bounds), and
    equal to the port's unsharded measure_nat/measure_raw on one rank."""
    outs = ranks["ranks"]
    got = [outs[0][f"measure_{label}_{k}"] for k in range(6)]
    for out in outs[1:]:
        for k in range(6):
            np.testing.assert_array_equal(out[f"measure_{label}_{k}"], got[k])
    _, args = measure_batch()
    mask = args[6]
    want = [np.asarray(a) for a in ranks["jax"]["measure"]]
    assert [a.shape for a in got] == [a.shape for a in want]
    np.testing.assert_allclose(got[0][mask], want[0][mask], rtol=1e-3, atol=0)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3, atol=0)
    assert (got[1] > 0).all()
    for k in (2, 3, 4, 5):
        sel = mask if got[k].ndim == 2 else slice(None)
        np.testing.assert_allclose(got[k][sel], want[k][sel], rtol=0, atol=0.01)
    for k in range(6):
        np.testing.assert_array_equal(got[k], outs[0][f"measure_single_{k}"])


def adapters_of(out: dict, case: str) -> dict:
    prefix = f"{case}/"
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix) and k.split("/", 1)[1] not in ("losses", "frozen_same")}


@pytest.mark.parametrize("case", list(CASES))
def test_replicated_leaves_are_bit_identical_on_every_rank(ranks, case):
    """After the steps every rank holds the same bits in every trainable
    (replicated) leaf, and no frozen leaf moved."""
    outs = ranks["ranks"]
    first = adapters_of(outs[0], case)
    assert len(first) == 2 * 7 * PARITY["layers"]
    for r, out in enumerate(outs):
        assert bool(out[f"{case}/frozen_same"]), (case, r)
        np.testing.assert_array_equal(out[f"{case}/losses"], outs[0][f"{case}/losses"])
        mine = adapters_of(out, case)
        assert mine.keys() == first.keys()
        for k, v in mine.items():
            np.testing.assert_array_equal(v, first[k], err_msg=f"{case} rank {r} {k}")


def check_close(losses, adapters, want_losses, want_adapters, tol: float, steps: int, label: str) -> tuple:
    """tests/test_torch_training.py's bounds: losses within ``tol``
    relative; adapters within 0.25·lr·steps everywhere and 2 % of lr·steps
    on average. Returns the measured worst figures."""
    rel = np.abs(losses - want_losses) / np.abs(want_losses)
    assert (rel <= tol).all(), (label, losses, want_losses)
    worst_max = worst_mean = 0.0
    for k, v in want_adapters.items():
        diff = np.abs(adapters[k] - v)
        assert diff.max() <= 0.25 * LR * steps, (label, k, diff.max())
        assert diff.mean() <= 0.02 * LR * steps, (label, k, diff.mean())
        worst_max, worst_mean = max(worst_max, float(diff.max())), max(worst_mean, float(diff.mean()))
    return float(rel.max()), worst_max, worst_mean


@pytest.mark.parametrize("case", JAX_CASES)
def test_step_matches_jax_shard_train_inputs(ranks, case):
    """The four ranks' (2, 2) step against the JAX package's
    shard_train_inputs + make_train_step on make_mesh(data=2, model=2), from
    the same initialisation: losses within 2e-5 relative (5e-4 with vmem),
    adapters within the parity bounds."""
    from prosody_control_french_tts_tpu_torch import convert
    from prosody_control_french_tts_tpu_torch.models import llm

    import torch

    want_losses, jparams = ranks["jax"][case]
    want = convert.llm_params_from_jax(jparams, llm.LLMConfig(**PARITY, dtype=torch.float32))
    got = adapters_of(ranks["ranks"][0], case)
    tol = 5e-4 if case.startswith("vmem") else 2e-5
    figures = check_close(ranks["ranks"][0][f"{case}/losses"], got, want_losses, {k: want[k].numpy() for k in got}, tol, STEPS, case)
    print(f"{case} vs JAX: loss rel {figures[0]:.2e}, adapters max {figures[1]:.2e} mean {figures[2]:.2e}")
    assert ranks["ranks"][0][f"{case}/losses"][-1] < ranks["ranks"][0][f"{case}/losses"][0]


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_the_single_process_step(ranks, case):
    """Every case against the port's single-process step on the whole batch:
    the same bounds as against JAX."""
    losses, state, trainable, _ = ranks["single"][case]
    got = adapters_of(ranks["ranks"][0], case)
    assert set(got) == {k for k, t in trainable.items() if t}
    tol = 5e-4 if case.startswith(("vmem", "flash")) else 2e-5
    steps = step_count(CASES[case][3]) // CASES[case][3]
    figures = check_close(ranks["ranks"][0][f"{case}/losses"], got, losses, {k: state[k] for k in got}, tol, steps, case)
    print(f"{case} vs one process: loss rel {figures[0]:.2e}, adapters max {figures[1]:.2e} mean {figures[2]:.2e}")


@pytest.mark.parametrize("quant", QUANTS)
def test_quantized_storage_shards(ranks, quant):
    """The forward over quantized projections sharded on (2, 2) (int8 scales
    on "model" for the column kernels, NF4 packed rows and blockwise scales
    as their kernels): the gathered logits within 1e-5 of their largest
    value of the unsharded quantized model's (7.9e-7 to 9.5e-7 measured:
    the row-parallel sums add in another order), equal on every rank."""
    want = ranks["quant_single"][quant]
    got = ranks["ranks"][0][f"quant_{quant}"]
    assert got.shape == want.shape
    print(f"{quant}: {np.abs(got - want).max() / np.abs(want).max():.2e} of the largest logit")
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    for out in ranks["ranks"][1:]:
        np.testing.assert_array_equal(out[f"quant_{quant}"], got)


def test_the_mask_counts_differ_between_batch_ranks():
    """The mask makes a mean of the two batch ranks' means differ from the
    global mean, so the loss checks above would catch one."""
    _, mask = train_batches()
    counts = [mask[:2, 1:].sum(), mask[2:, 1:].sum()]
    assert counts[0] != counts[1]


def test_the_rank_program_imports_no_jax():
    text = Path(__file__).read_text()
    main = text[text.index("def rank_main"): text.index("# the test side")]
    assert "import jax" not in main and "prosody_control_french_tts_tpu." not in main


if __name__ == "__main__":
    rank_main(sys.argv[1], sys.argv[2])
