"""The harness finds each cell's pieces by name, and BENCHMARK.json keeps
the contract's shape."""

import json
import re

import pytest

from benchmark import harness, trace as tr

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PUBLISHED = {"hidden_size": 3584, "intermediate_size": 18944, "num_attention_heads": 28, "num_hidden_layers": 28,
             "num_key_value_heads": 4, "vocab_size": 152064, "rope_theta": 1000000.0, "rms_norm_eps": 1e-06,
             "tie_word_embeddings": False, "max_position_embeddings": 32768}
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_find_cell(name):
    cell = harness.find_cell(name)
    assert cell["traffic"]["driver"] == "train"
    assert harness.driver(cell["traffic"]).run
    assert {"grad1", "change"} <= set(cell["limits"]) <= {"loss", "grad1", "change"}
    assert {m["name"] for m in cell["end_to_end"]} == {"train_tokens_per_s", "setup_s"}
    assert len(cell["per_layer"]) == 7
    assert cell["traffic"]["seq_len"] == cell["config"]["stage"]["seq_len"]
    for key, value in PUBLISHED.items():
        assert cell["config"][key] == value, key


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        harness.find_cell("no_such.cell")


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200 and w["chips"] == 1
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] == "train_tokens_per_s" and set(m["workloads"]) <= set(CELLS)
    assert len(json.dumps(SPEC)) < 64 * 1024


def ctx():
    t = tr.Trace(span=(0, 1_000_000_000))
    t.device = [("flash_fwd_bf16", 0, 10_000_000), ("fused_ce_fwd_bf16_kernel", 10_000_000, 50_000_000),
                ("nvjet_tst", 50_000_000, 600_000_000), ("elementwise", 600_000_000, 900_000_000)]
    cell = harness.find_cell("cascade_a.train")
    from benchmark.drivers.train import dims_of
    return {"trace": t, "dims": dims_of(cell["config"]), "batch": 8, "seq": 1024, "micro_steps": 1,
            "by_class": tr.time_by_class(t), "span_s": 1.0}


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_metric_has_a_reader(metric):
    v = harness.reader(metric)(ctx())
    assert v is not None and v > 0


def test_readers_values():
    c = ctx()
    assert harness.reader("device.idle_share")(c) == pytest.approx(10.0)
    assert harness.reader("model.gemm_ms")(c) == pytest.approx(550.0)
    assert harness.reader("step.kernels_per_microstep")(c) == 4
    assert harness.reader("step_mfu")(c) == pytest.approx(100 * 237.72e12 / 989e12, rel=1e-3)


def test_a_reader_with_nothing_to_read_returns_none():
    c = ctx()
    c["by_class"] = {}
    assert harness.reader("flash_attention_roofline")(c) is None
    assert harness.reader("fused_ce_roofline")(c) is None
