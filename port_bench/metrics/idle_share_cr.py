"""The device's idle share of the traced consistency stretch, in %."""

from port_bench import readers


def read(ctx):
    return readers.idle_share(ctx, "consistency")
