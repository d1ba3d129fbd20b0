"""step_mfu: the model operations of the traced micro-steps (the
yardstick's count: every needed product once, no recompute) over the traced
span's wall time and the card's bf16 peak, in %."""

from benchmark import counts


def read(ctx):
    flops = counts.microstep_flops(ctx["dims"], ctx["batch"], ctx["seq"]) * ctx["micro_steps"]
    return 100.0 * flops / (ctx["span_s"] * counts.PEAK_BF16_FLOPS)
