"""Seconds from the process's start to the first timed step: the imports,
the data, the weights and the first chunk of steps (kernel builds, the
graph's capture)."""


def read(ctx):
    return ctx["setup_s"]
