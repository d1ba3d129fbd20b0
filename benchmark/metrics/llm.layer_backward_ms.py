"""llm.layer_backward_ms: device ms a micro-step of the decoder layers'
backward outside their recompute and dequant (the span
``llm.layer.backward``), from the spans stretch."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, "llm.layer.backward")
