"""The host's kernel and graph launch calls per consistency step in the traced stretch."""

from port_bench import readers


def read(ctx):
    return readers.traced(ctx, "consistency", "launches_per_step")
