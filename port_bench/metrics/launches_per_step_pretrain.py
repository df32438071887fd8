"""The host's kernel and graph launch calls per pretraining step in the traced stretch."""

from port_bench import readers


def read(ctx):
    return readers.traced(ctx, "pretrain", "launches_per_step")
