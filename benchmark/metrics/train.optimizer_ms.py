"""train.optimizer_ms: device ms a micro-step of ``AccumAdamW.step`` (the
span ``train.optimizer``: the gradient accumulation's passes, and AdamW
on the update's micro-step), from the spans stretch."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, "train.optimizer")
