"""step.kernels_per_microstep: device operations (kernels, copies, fills)
in the traced span over the micro-steps traced: the host's dispatch work."""

from benchmark import trace


def read(ctx):
    return trace.count(ctx["trace"]) / ctx["micro_steps"]
