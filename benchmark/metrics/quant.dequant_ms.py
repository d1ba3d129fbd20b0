"""quant.dequant_ms: device ms a micro-step of the base kernels'
dequantization (the span ``quant.dequant``: ``quant.dequant_nf4`` and
``dequant_int8`` in the forward, the recompute and the backward), from the
spans stretch."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, "quant.dequant")
