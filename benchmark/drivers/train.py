"""The training driver: one cell's run of the port's LoRA train step.

Set-up builds the trainer with ``models.training.init_train`` as the stage
sets it up, loads the benchmark's own weights (for a quantized base,
quantized by the program's ``quant.quantize_params`` on the card), makes a
ring of distinct micro-batches on the card, and drives the step through
its first updates with the window's own call and feed; those updates are
the warm-up and the program's side of the check. The window then runs whole
updates back to back from the ring until ``seconds`` have passed, reading
nothing back until it ends. After it, the program is freed and the plain
reference follows the same first updates from the same weights and
micro-batches.

With ``trace``, a steady stretch of whole updates inside the window is
traced by ``torch.profiler`` and the per-layer metrics are read from it.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent.parent
if str(BENCH.parent) not in sys.path:
    sys.path.insert(0, str(BENCH.parent))

from benchmark import compare, harness, trace as tr, weights as wt  # noqa: E402
from benchmark.reference import train_lm  # noqa: E402

ATTN = ("q", "k", "v", "o")
IDS_SEED = 0x1D5  # added to the cell's seed for the token ids


def dims_of(config: dict) -> dict:
    """The shapes the harness works with, from the source's keys."""
    return {"vocab_size": config["vocab_size"], "dim": config["hidden_size"], "layers": config["num_hidden_layers"],
            "heads": config["num_attention_heads"], "kv_heads": config["num_key_value_heads"],
            "ffn": config["intermediate_size"], "rope_theta": config["rope_theta"], "rms_eps": config["rms_norm_eps"],
            "init_std": config["initializer_range"], "lora_rank": config["stage"]["lora_rank"]}


def llm_config(config: dict, traffic: dict, quant="stage"):
    """The port's ``LLMConfig`` for the stage (``quant`` overrides the
    stage's base storage)."""
    from prosody_control_french_tts_tpu_torch.models import llm

    st, d = config["stage"], dims_of(config)
    if traffic["seq_len"] != st["seq_len"]:
        raise SystemExit(f"traffic length {traffic['seq_len']} is not the stage's {st['seq_len']}")
    return llm.LLMConfig(vocab_size=d["vocab_size"], dim=d["dim"], layers=d["layers"], heads=d["heads"], kv_heads=d["kv_heads"],
                         ffn=d["ffn"], max_len=st["seq_len"], rope_theta=d["rope_theta"], lora_rank=st["lora_rank"],
                         lora_alpha=st["lora_alpha"], dtype=torch.bfloat16, quant=st["quant"] if quant == "stage" else quant,
                         attn_impl=st["attn_impl"], fused_qkv=st["fused_qkv"], remat=st["remat"], remat_policy=st["remat_policy"])


def load_weights(model, w: dict, quant) -> None:
    """The benchmark's weights into the program's model; a quantized base
    is quantized by the program's own ``quantize_params``."""
    from prosody_control_french_tts_tpu_torch.models import quant as q

    tree = {}
    with torch.no_grad():
        model.embed.embedding.copy_(w["embed"])
        model.lm_head.kernel.copy_(w["head"])
        model.ln_f.scale.copy_(w["ln_f"])
        for i, layer in enumerate(model.layers):
            layer.ln1.scale.copy_(w["ln1"][i])
            layer.ln2.scale.copy_(w["ln2"][i])
            for k in wt.KINDS:
                mod = getattr(layer.attn if k in ATTN else layer.mlp, k)
                if quant is None:
                    mod.kernel.copy_(w[k][i])
                else:
                    tree[f"layers.{i}.{'attn' if k in ATTN else 'mlp'}.{k}.kernel"] = w[k][i]
                if k in wt.BIASED:
                    mod.bias.copy_(w["b" + k][i])
                mod.lora_a.copy_(w["A." + k][i])
                mod.lora_b.zero_()
    if tree:
        qtree = q.quantize_params(tree, quant)
        _, unexpected = model.load_state_dict(qtree, strict=False)
        if unexpected:
            raise SystemExit(f"the quantized base does not load: {unexpected[:3]}")


def build(cell: dict, seed: int, device, quant="stage"):
    """(step, model, tx, leaves): the trainer as the stage sets it up, with
    the weights of ``seed``; ``leaves`` are (name, parameter) of the
    trainable leaves in the optimizer's order."""
    from prosody_control_french_tts_tpu_torch.models import training

    config, traffic = cell["config"], cell["traffic"]
    cfg = llm_config(config, traffic, quant)
    model, tx, state = training.init_train(cfg, seed=seed, lr=config["stage"]["lr"], accum=traffic["accum"],
                                           frozen_dtype=torch.bfloat16, device=device)
    w = wt.make(dims_of(config), seed, device)
    load_weights(model, w, cfg.quant)
    del w
    step = training.make_train_step(model, tx, trainable=state.mask, loss_impl="auto")
    want = config["stage"]["loss_impl"]
    if step.loss_impl != want:
        raise SystemExit(f"loss_impl='auto' resolved to {step.loss_impl!r}, the stage runs {want!r}")
    by_id = {id(p): n for n, p in model.named_parameters()}
    leaves = [(by_id[id(p)], p) for p in tx.params]
    return step, model, tx, leaves


def ring(cell: dict, seed: int, device) -> torch.Tensor:
    """``traffic["ring"]`` distinct micro-batches [ring, B, L] of token ids
    drawn uniformly from [token_low, vocab) on the device."""
    t, v = cell["traffic"], cell["config"]["vocab_size"]
    gen = torch.Generator(device=device).manual_seed(seed + IDS_SEED)
    shape = (t["ring"], t["micro_batch"], t["seq_len"])
    return torch.randint(t["token_low"], v, shape, generator=gen, device=device, dtype=torch.int64).to(torch.int32)


def first_updates(step, tx, leaves, batches, mask, updates: int, accum: int) -> dict:
    """The program's first ``updates`` updates through ``step``: each
    micro-step's loss, the first update's gradient as AdamW holds it (its
    first moment over 1 - beta1), and each leaf's change after the last, by
    leaf name (device tensors until :func:`to_host`)."""
    b1 = tx.inner.param_groups[0]["betas"][0]
    start = [p.detach().clone() for _, p in leaves]
    losses, grad1 = [], None
    for u in range(updates):
        for j in range(accum):
            losses.append(step(batches[u * accum + j], mask))
        if u == 0:
            grad1 = torch.stack([(tx.inner.state[p]["exp_avg"] / (1 - b1)).norm() if "exp_avg" in tx.inner.state.get(p, {})
                                 else torch.zeros((), device=p.device) for _, p in leaves])
    change = torch.stack([(p.detach() - s).norm() for (_, p), s in zip(leaves, start)])
    return {"losses": torch.stack(losses), "grad1": grad1, "change": change, "names": [n for n, _ in leaves]}


def to_host(r: dict) -> dict:
    names = r["names"]
    return {"losses": r["losses"].double().tolist(), "grad1": dict(zip(names, r["grad1"].double().tolist())),
            "change": dict(zip(names, r["change"].double().tolist()))}


def launch_counts() -> dict:
    from prosody_control_french_tts_tpu_torch.ops import flash_attention, fused_ce

    return {"flash_attn_fwd": flash_attention.launches, "flash_attn_bwd": flash_attention.launches_bwd,
            "fused_ce_fwd": fused_ce.launches, "fused_ce_bwd": fused_ce.launches_bwd}


def reset_launch_counts() -> None:
    from prosody_control_french_tts_tpu_torch.ops import flash_attention, fused_ce

    flash_attention.launches = flash_attention.launches_bwd = 0
    fused_ce.launches = fused_ce.launches_bwd = 0


def expected_launches(layers: int, micro_steps: int, remat: bool) -> dict:
    """The flash attention's forward twice a layer a micro-step under remat
    (the recompute launches it again: it is no matrix product that "dots"
    keeps), once without; its backward once a layer a micro-step; kernel H
    once a micro-step each way."""
    return {"flash_attn_fwd": layers * micro_steps * (2 if remat else 1), "flash_attn_bwd": layers * micro_steps,
            "fused_ce_fwd": micro_steps, "fused_ce_bwd": micro_steps}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(step, batches, mask, start: int, seconds: float, accum: int, device, trace_updates: int = 0):
    """Whole updates back to back from ``batches[start:]`` (cycled) until
    ``seconds`` have passed on the host clock, then a synchronisation.
    With ``trace_updates``, updates 1 .. trace_updates (counting from 0: the
    first is left to settle) are traced with the device's activity alone
    (recording every host operation would slow the host enough to idle the
    card), then one more update with the host's operations too, to name what
    the host did in the card's idle gaps; the window runs at least that far.
    Returns (losses on the device, seconds, micro-steps, the profilers)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    # (first update, update after the last, activities) of each traced stretch
    stretches = [(1, 1 + trace_updates, [ProfilerActivity.CUDA]),
                 (1 + trace_updates, 2 + trace_updates, [ProfilerActivity.CPU, ProfilerActivity.CUDA])] if trace_updates else []
    last = stretches[-1][1] if stretches else 0
    n = batches.shape[0]
    losses, i, u, traced, open_ = [], start, 0, [], None
    sync(device)
    t0 = time.perf_counter()
    while True:
        if stretches and u == stretches[0][0]:
            _, stop, activities = stretches.pop(0)
            sync(device)
            open_ = (contextlib.ExitStack(), stop)
            traced.append(open_[0].enter_context(profile(activities=activities)))
            open_[0].enter_context(record_function(tr.SPAN))
        for _ in range(accum):
            losses.append(step(batches[i % n], mask))
            i += 1
        u += 1
        if open_ is not None and u == open_[1]:
            sync(device)
            open_[0].close()
            open_ = None
        if time.perf_counter() - t0 >= seconds and u >= last:
            break
    sync(device)
    return torch.stack(losses), time.perf_counter() - t0, i - start, traced


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def per_layer(cell: dict, profs, micro_steps: int) -> tuple[dict, dict, dict]:
    """(metrics, device busy and window seconds, breakdown) from the device
    trace of ``micro_steps`` micro-steps; the breakdown's idle gaps from the
    update traced with the host's operations."""
    t = tr.from_profiler(profs[0])
    if t.span is None:
        raise SystemExit("the trace holds no device operation")
    traffic = cell["traffic"]
    ctx = {"trace": t, "dims": dims_of(cell["config"]), "batch": traffic["micro_batch"], "seq": traffic["seq_len"],
           "micro_steps": micro_steps, "by_class": tr.time_by_class(t), "span_s": (t.span[1] - t.span[0]) / 1e9}
    out = {}
    for m in cell["per_layer"]:
        v = harness.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"busy_s": tr.busy_ns(t) / 1e9, "window_s": ctx["span_s"]}
    host = tr.from_profiler(profs[1])
    return out, dev, {"device_ops": tr.breakdown(t)["device_ops"], "idle_gaps": tr.breakdown(host)["idle_gaps"]}


def run(cell: dict, seed: int, seconds: float, trace: bool, device="cuda", t_start: float | None = None) -> dict:
    """One run of a training cell: set-up, the window, the check against
    the reference. Returns the result's parts: ``metrics``, ``device``,
    ``breakdown`` (traced), ``attempted``, ``failed``, ``checks``,
    ``notes`` (lines for standard error)."""
    t_start = time.perf_counter() if t_start is None else t_start
    traffic, config = cell["traffic"], cell["config"]
    accum, K = traffic["accum"], traffic["check_updates"]
    B, L = traffic["micro_batch"], traffic["seq_len"]
    if traffic["loss_mask"] != "ones":
        raise SystemExit(f"loss_mask {traffic['loss_mask']!r}: this driver trains on every position ('ones')")
    if traffic["ring"] < K * accum:
        raise SystemExit(f"a ring of {traffic['ring']} micro-batches cannot feed {K} check updates of {accum}")
    notes = []
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from prosody_control_french_tts_tpu_torch.ops import kernels

        kernels.library()
    t_lib = time.perf_counter()
    step, model, tx, leaves = build(cell, seed, device)
    batches = ring(cell, seed, device)
    mask = torch.ones((B, L), dtype=torch.float32, device=device)
    sync(device)
    t_built = time.perf_counter()
    mine = first_updates(step, tx, leaves, batches, mask, K, accum)
    sync(device)
    setup_s = time.perf_counter() - t_start
    notes.append(f"setup: {t_lib - t_start:.2f} s to the kernel library loaded, {t_built - t_lib:.2f} s to build the trainer and "
                 f"load the weights, {time.perf_counter() - t_built:.2f} s for the first {K} updates")

    reset_launch_counts()
    losses, elapsed, micro, prof = window(step, batches, mask, K * accum, seconds, accum, device,
                                          traffic["trace_updates"] if trace else 0)
    counts_seen = launch_counts()
    result = {"attempted": micro, "failed": int((~torch.isfinite(losses)).sum())}
    if cuda:
        result["device"] = harness.card(cell["chips"])
    tokens = micro * B * L
    if trace:
        traced = traffic["trace_updates"] * accum
        result["metrics"], busy, result["breakdown"] = per_layer(cell, prof, traced)
        result.setdefault("device", {}).update(busy)
        notes.append(f"traced {traced} micro-steps: {busy['busy_s']:.4f} s busy of {busy['window_s']:.4f} s")
    else:
        result["metrics"] = {"train_tokens_per_s": {"value": tokens / elapsed, "unit": "tokens/s"},
                             "setup_s": {"value": setup_s, "unit": "s"}}
    notes.append(f"window: {micro} micro-steps of {B} x {L} tokens in {elapsed:.4f} s; setup {setup_s:.4f} s; "
                 f"peak {result.get('device', {}).get('memory_peak_bytes')} bytes")
    mine = to_host(mine)
    del step, model, tx, leaves, prof, losses
    free()

    # the reference follows the first updates, from the same weights and micro-batches
    t_ref = time.perf_counter()
    dims = dims_of(config)
    w = wt.make(dims, seed, device)
    ref = train_lm.follow(dims, reference_stage(config), w, batches[: K * accum], mask, K, accum)
    del w
    free()
    values = compare.readings(mine, ref)
    result["checks"] = compare.checks(values, cell["limits"])
    notes.append(f"readings {values} (compared: {sorted(cell['limits'])})")
    if cuda:
        want = expected_launches(dims["layers"], micro, config["stage"]["remat"])
        ok = counts_seen == want
        result["checks"].append({"name": "launch_mismatch", "value": 0 if ok else 1, "limit": 0})
        notes.append(f"launches in the window {counts_seen}, expected {want}")
    notes.append(f"reference: {K} updates of {accum} micro-steps in {time.perf_counter() - t_ref:.1f} s; "
                 f"losses program {mine['losses']} reference {ref['losses']}")
    if result["failed"]:
        result["checks"].append({"name": "nonfinite_losses", "value": result["failed"], "limit": 0})
    result["notes"] = notes
    return result


def reference_stage(config: dict) -> dict:
    st = config["stage"]
    return {"lora_alpha": st["lora_alpha"], "quant": st["quant"], "lr": st["lr"], "weight_decay": st["weight_decay"],
            "betas": tuple(st["betas"]), "adam_eps": st["adam_eps"]}

