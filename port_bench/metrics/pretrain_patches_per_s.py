"""3 x triplets of every pretraining step in the window, over the window's wall."""

from port_bench import readers


def read(ctx):
    return readers.rate(ctx, "pretrain")
