"""model.other_ms: device ms a micro-step in operations that are neither
library products nor the port's hand-written kernels: the elementwise tail,
reductions, copies, and the NF4 dequant where the base is quantized."""


def read(ctx):
    ns = ctx["by_class"].get("other")
    return None if ns is None else ns / 1e6 / ctx["micro_steps"]
