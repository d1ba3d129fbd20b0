"""The spans stretch's attribution on a synthetic event list, and the
readers of the metrics it feeds."""

import pytest
from torch.autograd import DeviceType

from benchmark import harness, spans as sp
from benchmark.tests.test_bench_harness import SPEC, ctx as trace_ctx

METRICS = ("llm.layer_forward_ms", "llm.layer_recompute_ms", "llm.layer_backward_ms", "train.optimizer_ms",
           "quant.dequant_ms", "nf4_dequant_roofline")

M = 1_000_000  # the synthetic times in ms
MAIN, AUTOGRAD = 11, 22


def synthetic():
    """A micro-step: the forward on the main thread, the backward on
    autograd's, the optimizer on the main thread again."""
    st = sp.Stretch()
    st.spans = [("train.step", 0, 1000 * M, MAIN), ("llm.layer.forward", 10 * M, 200 * M, MAIN),
                ("quant.dequant", 20 * M, 50 * M, MAIN), ("llm.layer.backward", 400 * M, 800 * M, AUTOGRAD),
                ("llm.layer.recompute", 420 * M, 600 * M, AUTOGRAD), ("quant.dequant", 430 * M, 460 * M, AUTOGRAD),
                ("train.optimizer", 900 * M, 990 * M, MAIN)]
    st.calls = {1: (25 * M, MAIN), 2: (60 * M, MAIN), 3: (300 * M, AUTOGRAD), 4: (435 * M, AUTOGRAD), 5: (500 * M, AUTOGRAD),
                6: (700 * M, AUTOGRAD), 7: (950 * M, MAIN), 8: (1500 * M, MAIN)}
    st.device = [("k1", 30 * M, 40 * M, 1), ("k2", 70 * M, 100 * M, 2), ("k3", 310 * M, 330 * M, 3), ("k4", 440 * M, 445 * M, 4),
                 ("k5", 510 * M, 560 * M, 5), ("k6", 710 * M, 790 * M, 6), ("k7", 955 * M, 975 * M, 7),
                 ("k8", 1510 * M, 1520 * M, 8), ("k9", 1600 * M, 1610 * M, 99)]
    return st


def test_attribution():
    a = sp.attribute(synthetic())
    # k1 and k4: the dequant, innermost on each thread; k3: autograd's thread
    # has no span open at 300, so the main thread's train.step takes it
    assert a["self_ns"] == {"quant.dequant": 15 * M, "llm.layer.forward": 30 * M, "train.step": 20 * M,
                            "llm.layer.recompute": 50 * M, "llm.layer.backward": 80 * M, "train.optimizer": 20 * M}
    # k8: no span open anywhere; k9: no runtime call and no span at its start
    assert a["unattributed_ns"] == 20 * M
    assert a["device_ns"] == 235 * M == sum(a["self_ns"].values()) + a["unattributed_ns"]
    assert a["launches"] == {"own_thread": 6, "any_thread": 1, "none": 1, "no_call": 1}
    assert a["gaps"][:4] == [["train.optimizer", 0.535], ["llm.layer.forward", 0.21], ["llm.layer.backward", 0.165],
                             ["llm.layer.recompute", 0.15]]
    assert [g[0] for g in a["gaps"][4:]] == ["train.step", "no span", "quant.dequant", "quant.dequant"]


def test_innermost_where_spans_touch_and_share_a_start():
    inner = sp._Innermost([("a", 0, 100), ("b", 0, 40), ("c", 40, 60), ("d", 60, 60)])
    assert [inner(t) for t in (-1, 0, 39, 40, 59, 60, 99, 100)] == [None, "b", "b", "c", "c", "a", "a", None]


def test_the_fallback_takes_the_shortest_span_on_any_thread():
    spans = [("train.step", 0, 100, MAIN), ("llm.layer.backward", 20, 80, AUTOGRAD)]
    assert sp.innermost_any(spans, 50) == "llm.layer.backward"
    assert sp.innermost_any(spans, 90) == "train.step"
    assert sp.innermost_any(spans, 100) is None


class _Event:
    """A kineto event as torch 2.11 gives it: no ``activity_type``."""

    def __init__(self, name, kind, device, start, dur, corr=0, thread=0, annotation=False):
        self._v = (name, kind, device, start, dur, corr, thread, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def device_resource_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[7]


class _TypedEvent(_Event):
    def activity_type(self):
        return self._v[1]


@pytest.mark.parametrize("event", [_Event, _TypedEvent])
def test_from_result_sorts_spans_calls_and_device_operations(event):
    events = [event("train.step", "user_annotation", DeviceType.CPU, 0, 100, 1, MAIN, True),
              event("Optimizer.step#AdamW.step", "user_annotation", DeviceType.CPU, 60, 30, 2, MAIN, True),
              event("cudaLaunchKernel", "cuda_runtime", DeviceType.CPU, 10, 5, 500, AUTOGRAD),
              event("cudaDeviceSynchronize", "cuda_runtime", DeviceType.CPU, 90, 5, 0, MAIN),
              event("nvjet_tst", "kernel", DeviceType.CUDA, 20, 30, 500),
              event("Memset (Device)", "gpu_memset", DeviceType.CUDA, 50, 2, 501),
              event("train.step", "gpu_user_annotation", DeviceType.CUDA, 20, 40, 1, annotation=True)]

    class Result:
        def events(self):
            return events

    st = sp.from_result(Result())
    assert st.spans == [("train.step", 0, 100, MAIN)]
    assert st.calls == {500: (10, AUTOGRAD)}
    assert st.device == [("nvjet_tst", 20, 50, 500), ("Memset (Device)", 50, 52, 501)]


def ctx():
    s = sp.context(synthetic(), micro_steps=2, dequant_calls=4, dequant_bytes=2 * int(3.35e9 * 0.75))
    return {"spans": s}


@pytest.mark.parametrize("metric, want", [("llm.layer_forward_ms", 15.0), ("llm.layer_recompute_ms", 25.0),
                                          ("llm.layer_backward_ms", 40.0), ("train.optimizer_ms", 10.0),
                                          ("quant.dequant_ms", 7.5), ("nf4_dequant_roofline", 10.0)])
def test_readers(metric, want):
    assert harness.reader(metric)(ctx()) == pytest.approx(want)
    # nothing to read: no spans stretch in the context
    assert harness.reader(metric)({}) is None


def test_readers_with_no_device_time_for_their_span():
    c = ctx()
    c["spans"]["self_ns"] = {"train.step": 5}
    for m in METRICS:
        assert harness.reader(m)(c) is None
    c = ctx()
    c["spans"]["dequant_bytes"] = 0
    assert harness.reader("nf4_dequant_roofline")(c) is None


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_the_accepted_readers_ignore_the_spans_stretch(metric):
    plain = trace_ctx()
    assert harness.reader(metric)(dict(plain, **ctx())) == harness.reader(metric)(plain)


def test_notes():
    lines = sp.notes(ctx()["spans"])
    assert lines[0].startswith("spans: 8.5106 % of 0.235000 device s attributed to no program span")
    assert "dequant calls 2 (1 spans), bytes 2512500000 a micro-step" in lines[0]
    assert "quant.dequant 7.500" in lines[1]
    assert lines[2].startswith("spans stretch's longest gaps: train.optimizer 535.000 ms")


def test_a_recorded_stretch_on_the_cpu():
    """A real recording of one micro-step of the tiny stage-B cell on the
    CPU: every program span on one thread (the CPU runs the backward on
    the calling thread), no device operation, the counter's bytes."""
    import torch

    from benchmark.drivers import train
    from benchmark.tests.tiny_cell import tiny

    cell = tiny("cascade_b.train")
    step, model, _, _ = train.build(cell, 7, "cpu")
    ids = train.ring(cell, 7, "cpu")
    mask = torch.ones(ids.shape[1:], dtype=torch.float32)
    step(ids[0], mask)
    with sp.recording("cpu") as rec:
        step(ids[1], mask)
    st = sp.from_result(rec["result"])
    names = [n for n, *_ in st.spans]
    assert {n: names.count(n) for n in set(names)} == {"train.step": 1, "train.optimizer": 1, "llm.layer.forward": 2,
                                                        "llm.layer.recompute": 2, "llm.layer.backward": 2,
                                                        "quant.dequant": 7 * 2 * 3 - 3}
    assert len({t for *_, t in st.spans}) == 1 and st.device == []
    kernels = [m for m in model.modules() if hasattr(m, "kernel_q")]
    least = 3 * sum(m.kernel_q.numel() + m.kernel_scale.numel() * 4 + m.in_features * m.features * 2 for m in kernels)
    first_qkv = sum(m.kernel_q.numel() + m.kernel_scale.numel() * 4 + m.in_features * m.features * 2
                    for m in (model.layers[0].attn.q, model.layers[0].attn.k, model.layers[0].attn.v))
    assert rec["dequant_bytes"] == least - first_qkv
    assert rec["dequant_calls"] == names.count("quant.dequant")
    assert "dequant calls 39 (39 spans)" in sp.notes(sp.context(st, 1, rec["dequant_calls"], rec["dequant_bytes"]))[0]


def test_the_probes_gc_pauses_are_clocked():
    """``tools/train_spans_probe.py``'s clock of the collector's pauses."""
    import gc
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[2] / "tools" / "train_spans_probe.py"
    spec = importlib.util.spec_from_file_location("train_spans_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    assert probe.METRICS == METRICS
    with probe.gc_pauses() as paused:
        gc.collect()
    assert len(paused) == 1 and paused[0] >= 0
    assert not any(getattr(c, "__name__", "") == "clock" for c in gc.callbacks)
