"""Labeled plus unlabeled images of every consistency step in the window, over its wall."""

from port_bench import readers


def read(ctx):
    return readers.rate(ctx, "consistency")
