"""fused_ce_roofline: the least time of the LM head's cross-entropy a
micro-step needs (the logits and the hidden state's gradient, each once)
over the device time of every fused_ce kernel a micro-step, in %."""

from benchmark import counts


def read(ctx):
    ns = ctx["by_class"].get("ce")
    if not ns:
        return None
    d, b, L = ctx["dims"], ctx["batch"], ctx["seq"]
    least = counts.bound_s(counts.head_ce_flops(d, b, L), counts.head_ce_bytes(d, b, L))
    return 100.0 * least / (ns / 1e9 / ctx["micro_steps"])
