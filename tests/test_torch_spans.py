"""The program's spans inside the LoRA train step and the dequant counter
(``core/profiling.py``, ``models/{training,llm,quant}.py``), on the CPU at
``LLMConfig.tiny`` widths.

A profiler that records only ``record_function`` ranges (the user scope)
sees no span while the switch is off, and with it on, per micro-step:
``train.step`` and ``train.optimizer`` once, ``llm.layer.forward`` and
``llm.layer.backward`` once a layer, ``llm.layer.recompute`` once a layer
under remat, and ``quant.dequant`` once a quantized kernel in the forward,
in the recompute and in the backward, except in the first layer's backward
for q, k and v: their input is the frozen embedding's, so no input gradient
is made and no kernel is needed. The switch changes no bit of the losses or
of the trained leaves, under either remat policy, whose selective
checkpoint numbers the operators of a layer's forward to match them in its
recompute.
"""

import dataclasses
from collections import Counter

import pytest
import torch
from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
from torch._C._profiler import ProfilerActivity, ProfilerConfig, ProfilerState, RecordScope, _ExperimentalConfig

from prosody_control_french_tts_tpu_torch.core import profiling
from prosody_control_french_tts_tpu_torch.models import llm, quant, training

SPANS = ("train.step", "train.optimizer", "llm.layer.forward", "llm.layer.recompute", "llm.layer.backward", "quant.dequant")
REMAT = {"none": dict(remat=False), "full": dict(remat=True, remat_policy=None), "dots": dict(remat=True, remat_policy="dots")}
PROJ = 7  # q, k, v, o, gate, up, down
ACCUM = 2
B, L = 2, 16


def record(fn):
    """Run ``fn`` under a profiler that records the user scope alone:
    (name, start_ns, end_ns, thread) of each program span."""
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False, _ExperimentalConfig())
    acts = {ProfilerActivity.CPU}
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    try:
        fn()
    finally:
        events = _disable_profiler().events()
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id()) for e in events if e.name() in SPANS]


def trainer(remat="none", quant_mode=None, seed=0):
    """(step, model, cfg): a tiny float32 model, LoRA over a base drawn from
    ``seed`` (quantized by ``quant.quantize_params`` where asked), AdamW
    with accumulation."""
    cfg = dataclasses.replace(llm.LLMConfig.tiny(), dtype=torch.float32, quant=quant_mode, **REMAT[remat])
    model, tx, state = training.init_train(cfg, seed=seed, accum=ACCUM, device="cpu")
    if quant_mode is not None:
        base = llm.DecoderLM(dataclasses.replace(cfg, quant=None), device="cpu", seed=seed)
        _, unexpected = model.load_state_dict(quant.quantize_params(base.state_dict(), quant_mode), strict=False)
        assert not unexpected
    return training.make_train_step(model, tx, trainable=state.mask), model, cfg


def batches(n, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(1, 512, (B, L), generator=g) for _ in range(n)]


def test_switch_off_by_default_and_a_shared_null_context():
    assert not profiling.spans_enabled()
    off = profiling.span("quant.dequant")
    assert off is profiling.span("train.step", 3)
    with off:
        pass
    mark = profiling.backward_spans("llm.layer.backward")
    x = torch.ones(2, requires_grad=True) * 2
    assert mark(x, 0) is x and mark(x) is x and x._backward_hooks is None
    with profiling.spans():
        assert profiling.spans_enabled()
        assert profiling.span("train.step") is not off
        assert profiling.backward_spans("llm.layer.backward")(x, 0) is x and len(x._backward_hooks) == 1
        with profiling.spans(False):
            assert not profiling.spans_enabled()
        assert profiling.spans_enabled()
    assert not profiling.spans_enabled()


def test_no_program_span_while_off():
    step, _, _ = trainer("dots", "nf4")
    ids = batches(ACCUM)
    assert record(lambda: [step(i, torch.ones(B, L)) for i in ids]) == []


@pytest.mark.parametrize("quant_mode", [None, "nf4"])
@pytest.mark.parametrize("remat", list(REMAT))
def test_spans_per_micro_step(remat, quant_mode):
    step, _, cfg = trainer(remat, quant_mode)
    ids = batches(ACCUM)
    step(ids[0], torch.ones(B, L))  # warm

    def run():
        with profiling.spans():
            for i in ids:
                step(i, torch.ones(B, L))

    got = Counter(name for name, *_ in record(run))
    layers = cfg.layers
    passes = 3 if cfg.remat else 2  # forward, recompute, backward
    want = {"train.step": 1, "train.optimizer": 1, "llm.layer.forward": layers, "llm.layer.backward": layers,
            "llm.layer.recompute": layers if cfg.remat else 0,
            # the first layer's q, k, v: no input gradient, so no backward dequant
            "quant.dequant": PROJ * layers * passes - 3 if quant_mode else 0}
    assert {k: got[k] / ACCUM for k in SPANS} == want


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_spans_nest(remat):
    """On the CPU the backward runs on the calling thread, so every span
    nests by time on one thread: the layers and the optimizer inside
    ``train.step``, each recompute inside a layer's backward, each dequant
    inside a layer's forward, recompute or backward."""
    step, _, cfg = trainer(remat, "nf4")
    ids = batches(1)

    def run():
        with profiling.spans():
            step(ids[0], torch.ones(B, L))

    spans = record(run)
    assert len({t for *_, t in spans}) == 1

    def parent(s):
        around = [p for p in spans if p is not s and p[1] <= s[1] and s[2] <= p[2]]
        return min(around, key=lambda p: p[2] - p[1])[0] if around else None

    by = Counter((s[0], parent(s)) for s in spans)
    passes = {"llm.layer.forward": PROJ * cfg.layers, "llm.layer.recompute": PROJ * cfg.layers,
              "llm.layer.backward": PROJ * cfg.layers - 3}
    assert by == Counter({("train.step", None): 1, ("train.optimizer", "train.step"): 1,
                          ("llm.layer.forward", "train.step"): cfg.layers, ("llm.layer.backward", "train.step"): cfg.layers,
                          ("llm.layer.recompute", "llm.layer.backward"): cfg.layers,
                          **{("quant.dequant", k): n for k, n in passes.items()}})
    # each layer's backward: the later layer's first, its recompute inside
    back = sorted((s for s in spans if s[0] == "llm.layer.backward"), key=lambda s: s[1])
    assert all(a[2] <= b[1] for a, b in zip(back, back[1:]))


def test_dequant_bytes_formula():
    w = torch.randn(128, 96)
    packed, scale = quant.quantize_kernel_nf4(w)
    q8, s8 = quant.quantize_kernel_int8(w)
    calls, nbytes = quant.dequant_calls, quant.dequant_bytes
    quant.dequant_nf4(packed, scale, torch.bfloat16)
    # codes a byte per two weights, float32 scales one per 64 weights, bf16 result
    assert quant.dequant_bytes - nbytes == 64 * 96 + 2 * 96 * 4 + 128 * 96 * 2
    quant.dequant_int8(q8, s8, torch.float32)
    assert quant.dequant_bytes - nbytes == (64 * 96 + 2 * 96 * 4 + 128 * 96 * 2) + (128 * 96 + 96 * 4 + 128 * 96 * 4)
    assert quant.dequant_calls - calls == 2


@pytest.mark.parametrize("remat", list(REMAT))
def test_dequant_bytes_per_micro_step(remat):
    """Every quantized kernel's least bytes, times the passes that dequantize
    it, less the first layer's q, k, v in the backward."""
    step, model, cfg = trainer(remat, "nf4")
    ids = batches(ACCUM)
    step(ids[0], torch.ones(B, L))
    kernels = {name: m for name, m in model.named_modules() if isinstance(m, llm.LoRALinear)}
    least = {name: m.kernel_q.numel() + m.kernel_scale.numel() * 4 + m.in_features * m.features * 4 for name, m in kernels.items()}
    passes = 3 if cfg.remat else 2
    want = passes * sum(least.values()) - sum(least[f"layers.0.attn.{k}"] for k in "qkv")
    before = quant.dequant_bytes
    for i in ids:
        step(i, torch.ones(B, L))
    assert (quant.dequant_bytes - before) == ACCUM * want


@pytest.mark.parametrize("quant_mode", [None, "nf4"])
@pytest.mark.parametrize("remat", list(REMAT))
def test_spans_change_no_bit(remat, quant_mode):
    """Two updates with the spans on and off: every loss and every
    parameter bit-equal."""
    ids = batches(2 * ACCUM)
    out = []
    for on in (False, True):
        step, model, _ = trainer(remat, quant_mode)
        with profiling.spans(on):
            losses = [step(i, torch.ones(B, L)) for i in ids]
        out.append((torch.stack(losses), {k: v.clone() for k, v in model.state_dict().items()}))
    (l0, p0), (l1, p1) = out
    assert torch.equal(l0, l1)
    assert p0.keys() == p1.keys() and all(torch.equal(p0[k], p1[k]) for k in p0)


def test_switched_on_between_forward_and_backward():
    """A "dots" layer's recompute that opens spans its forward did not (the
    switch turned on in between) matches the forward's operators and gives
    the same gradients."""
    grads = []
    for on in (False, True):
        _, model, _ = trainer("dots", "nf4")
        ids = batches(1)[0]
        loss = llm.causal_lm_loss(model(ids), ids, torch.ones(B, L))
        with profiling.spans(on):
            loss.backward()
        grads.append([p.grad.clone() for p in model.parameters() if p.grad is not None])
    assert len(grads[0]) == len(grads[1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_device_trace_records_the_spans(tmp_path):
    step, _, _ = trainer("full")
    ids = batches(1)[0]
    with profiling.device_trace(tmp_path) as prof:
        assert profiling.spans_enabled()
        step(ids, torch.ones(B, L))
    assert not profiling.spans_enabled()
    names = {e.key for e in prof.key_averages()}
    assert {"train.step", "llm.layer.forward", "llm.layer.recompute", "llm.layer.backward", "train.optimizer"} <= names
    assert len(list(tmp_path.glob("trace_*.json"))) == 1
