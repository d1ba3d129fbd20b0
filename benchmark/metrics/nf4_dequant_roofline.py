"""nf4_dequant_roofline: the least time of the stretch's dequantization
(the program's ``quant.dequant_bytes`` over the stretch: codes and float32
scales read once, the result written once, at the card's HBM rate) over the
device time of the span ``quant.dequant``, in %."""

from benchmark import counts, spans


def read(ctx):
    sp = ctx.get("spans")
    ms = spans.self_ms(ctx, "quant.dequant")
    if ms is None or not sp["dequant_bytes"]:
        return None
    least_ms = sp["dequant_bytes"] / sp["micro_steps"] / counts.PEAK_HBM_BYTES * 1e3
    return 100.0 * least_ms / ms
