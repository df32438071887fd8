"""Model FLOPs of the consistency window over its wall, as % of the card's bf16 peak."""

from port_bench import readers


def read(ctx):
    return readers.mfu(ctx, "consistency")
