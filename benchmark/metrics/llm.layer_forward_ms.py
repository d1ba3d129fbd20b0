"""llm.layer_forward_ms: device ms a micro-step that the decoder layers'
forward launched while innermost (the span ``llm.layer.forward``: every
layer's forward, its products and its elementwise work, the NF4 dequant
excluded), from the spans stretch."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, "llm.layer.forward")
