"""The trace reduction on a synthetic event list."""

import pytest

from benchmark import trace as tr

GEMMS = ["sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64_warpgroupsize2x1x1_execute_segment_k_off_kernel__5x_cublas",
         "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", "void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_16x16_32x1_nn_align8>(Params)",
         "void cublasLt::splitKreduce_kernel<32, 16, int, float, float>(params)"]


@pytest.mark.parametrize("name, want", [
    ("void flash_fwd_bf16<128>(CUtensorMap, CUtensorMap)", "fa"), ("flash_dkv_group_sum", "fa"),
    ("fused_ce_coef_bf16_kernel", "ce"), ("void fused_ce_fwd_bf16_kernel(CUtensorMap)", "ce"),
    ("decode_attn_cluster_kernel", "hand"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<c10::BFloat16>>(int)", "other"),
    ("Memcpy DtoD (Device -> Device)", "other"),
] + [(g, "gemm") for g in GEMMS])
def test_classify(name, want):
    assert tr.classify(name) == want


def synthetic():
    t = tr.Trace(span=(100, 1100))
    t.device = [("flash_fwd_bf16", 100, 300), ("nvjet_tst_x", 250, 400), ("elementwise", 600, 700),
                ("fused_ce_fwd_bf16_kernel", 700, 800), ("late", 1050, 1200), ("before", 50, 90)]
    t.host = [(tr.SPAN, 100, 1100, 1), ("aten::mm", 390, 650, 1), ("cudaLaunchKernel", 420, 430, 1),
              ("aten::add", 800, 1060, 7)]
    return t


def test_union_gaps_and_busy():
    t = synthetic()
    assert tr.merged([(5, 10), (0, 3), (2, 4), (10, 12)]) == [(0, 4), (5, 12)]
    assert tr.count(t) == 5  # "before" starts outside the span
    assert tr.busy_ns(t) == 300 + 200 + 50  # 100..400, 600..800, 1050..1100 (clipped)
    assert tr.gaps(t) == [(400, 600), (800, 1050)]


def test_time_by_class_sums_durations():
    by = tr.time_by_class(synthetic())
    assert by == {"fa": 200, "gemm": 150, "other": 100 + 50, "ce": 100}


def test_breakdown_names_gaps_by_the_innermost_host_event():
    b = tr.breakdown(synthetic())
    assert b["device_ops"][0] == ["flash_fwd_bf16", 200e-9]
    assert b["idle_gaps"] == [["aten::add", 250e-9], ["aten::mm", 200e-9]]
