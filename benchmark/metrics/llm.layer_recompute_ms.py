"""llm.layer_recompute_ms: device ms a micro-step of the remat recompute
(the span ``llm.layer.recompute``, inside each layer's backward: the whole
forward again under full remat, everything but the saved products under
"dots"; the NF4 dequant excluded), from the spans stretch."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, "llm.layer.recompute")
