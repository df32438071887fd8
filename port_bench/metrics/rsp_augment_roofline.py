"""The fused augmentation kernel's share of its roofline, in %: its least
time at the mix's batch and tile (``yardstick.rsp_augment_least_s``) over
the profiler's device time per launch of the kernel in the traced
stretch (its kernel records, each with its own time); the wrapper's
counter has to show the kernel ran in the stretch."""

from port_bench import yardstick
from port_bench.readers import traced


def read(ctx):
    seconds = traced(ctx, "pretrain", "kernel_s")
    if not seconds:
        return None
    counts = ctx["trace"]["kernel_count"]
    names = [n for n in seconds if "rsp_augment" in n]
    launches = sum(counts[n] for n in names)
    if not launches or not ctx["trace"].get("rsp_augment_launches"):
        return None
    per_launch = sum(seconds[n] for n in names) / launches
    tr = ctx["traffic"]
    return 100.0 * yardstick.rsp_augment_least_s(tr["batch"], tr["tile"]) / per_launch
