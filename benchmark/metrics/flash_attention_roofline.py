"""flash_attention_roofline: the least time of the causal attention work a
micro-step needs (each product once, recompute not counted) over the device
time of every flash attention kernel a micro-step, in %."""

from benchmark import counts


def read(ctx):
    ns = ctx["by_class"].get("fa")
    if not ns:
        return None
    d, b, L = ctx["dims"], ctx["batch"], ctx["seq"]
    least = counts.bound_s(counts.attention_flops(d, b, L), counts.attention_bytes(d, b, L))
    return 100.0 * least / (ns / 1e9 / ctx["micro_steps"])
