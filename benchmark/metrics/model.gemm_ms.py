"""model.gemm_ms: device ms a micro-step in library products (cuBLAS,
cuBLASLt, CUTLASS), classified by kernel name."""


def read(ctx):
    ns = ctx["by_class"].get("gemm")
    return None if ns is None else ns / 1e6 / ctx["micro_steps"]
