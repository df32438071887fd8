"""The 3-view stack's views of every fine-tune step in the window, over its wall."""

from port_bench import readers


def read(ctx):
    return readers.rate(ctx, "finetune")
