"""Shared arithmetic of the metric readers in ``port_bench/metrics/``.

Each reader is ``read(ctx) -> float | None`` over the run's context
(``run.run_cell``): ``stage``, ``window`` (steps, wall_s, feed_wait_s),
``work_per_step``, ``flops_per_step``, ``setup_s`` and, in a traced run,
``trace`` (``tracing.summarize``).  A reader that finds nothing to read, a
stage it does not measure or an untraced run, returns None.
"""

from __future__ import annotations

from port_bench import yardstick


def rate(ctx: dict, stage: str):
    """Work of every step of the window over its wall seconds."""
    if ctx["stage"] != stage:
        return None
    w = ctx["window"]
    return w["steps"] * ctx["work_per_step"] / w["wall_s"]


def mfu(ctx: dict, stage: str):
    """The window's model FLOPs (``yardstick``) over its wall, as a share
    of the bf16 peak, in %."""
    if ctx["stage"] != stage or not ctx["flops_per_step"]:
        return None
    w = ctx["window"]
    return 100.0 * w["steps"] * ctx["flops_per_step"] / w["wall_s"] / yardstick.BF16_FLOPS


def traced(ctx: dict, stage: str, key: str):
    if ctx["stage"] != stage or not ctx.get("trace"):
        return None
    return ctx["trace"].get(key)


def idle_share(ctx: dict, stage: str):
    """1 - the device's busy time over the traced stretch, in %."""
    busy, span = traced(ctx, stage, "busy_s"), traced(ctx, stage, "window_s")
    if busy is None or not span:
        return None
    return 100.0 * (1.0 - busy / span)
