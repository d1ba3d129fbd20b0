"""The yardstick's counts at Qwen2.5-7B's published widths."""

import pytest

from benchmark import counts, harness
from benchmark.drivers.train import dims_of

QWEN = dims_of(harness.load_json(harness.BENCH_DIR / "configs" / "qwen25_7b_cascade_a.json"))


def test_dense_weights():
    assert counts.layer_weights(QWEN) == 233_046_016
    assert counts.head_weights(QWEN) == 544_997_376
    assert counts.dense_weights(QWEN) == 233_046_016 * 28 + 544_997_376 == 7_070_285_824


def test_lora_flops():
    per_layer = counts.lora_flops_per_token(QWEN) / 28
    assert per_layer == 4_325_376  # 4.33 MFLOP a layer at r 8


@pytest.mark.parametrize("seq, want", [(1024, 29.02e9), (768, 28.86e9)])
def test_flops_per_token(seq, want):
    assert counts.flops_per_token(QWEN, seq) == pytest.approx(want, abs=0.005e9)


def test_attention_flops():
    # six products of 2·B·H·L²·hd, halved for causality, in each of 28 layers
    assert counts.attention_flops(QWEN, 8, 1024) == 28 * 6 * 8 * 28 * 1024 * 1024 * 128


def test_microstep_flops_counts_the_head_once_a_predicted_token():
    b, seq = 8, 1024
    full = counts.flops_per_token(QWEN, seq) * b * seq
    got = counts.microstep_flops(QWEN, b, seq)
    assert full - got == pytest.approx(4 * counts.head_weights(QWEN) * b, rel=1e-9)


def test_bound_is_the_larger_of_compute_and_bytes():
    assert counts.bound_s(989e12, 1.0) == pytest.approx(1.0)
    assert counts.bound_s(1.0, 3.35e12) == pytest.approx(1.0)
    # the head's cross-entropy and the attention are compute-bound at these shapes
    b, seq = 8, 1024
    assert counts.head_ce_flops(QWEN, b, seq) / 989e12 > counts.head_ce_bytes(QWEN, b, seq) / 3.35e12
    assert counts.attention_flops(QWEN, b, seq) / 989e12 > counts.attention_bytes(QWEN, b, seq) / 3.35e12
