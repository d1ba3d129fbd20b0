"""device.idle_share: the share of the traced span in which no device
operation runs (outside the union of their intervals), in %."""

from benchmark import trace


def read(ctx):
    t = ctx["trace"]
    span = t.span[1] - t.span[0]
    return 100.0 * (span - trace.busy_ns(t)) / span
