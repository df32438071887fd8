"""What a ``--trace 1`` run reads from torch.profiler over a stretch of
chunks run after the measured window.

The stretch is wrapped in the benchmark's own ``bench.`` spans
(``torch.profiler.record_function``): one around the whole stretch, one
around each ``next()`` on the feed and each ``run`` of the step.  From the
trace's raw events this module takes:

- the device's busy time: the union of the intervals of its kernels and
  copies inside the stretch, and the stretch's length;
- the host's launch calls (kernels, graphs) per step;
- each kernel's total device time, by name, and per launch;
- the longest idle gaps of the device, each named by the benchmark span
  and the innermost host operation running at its middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel", "cudaGraphLaunch")
SPAN = "bench."
STRETCH = "bench.trace_stretch"


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list, at most ``width``
    characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)", "anon")
    name = name.split("(", 1)[0]
    return name if len(name) <= width else name[:width - 3] + "..."


def summarize(events, steps: int, top: int = 10) -> dict:
    """``events``: (name, on_device, start_ns, end_ns) tuples of one trace.
    Returns busy_s, window_s, launches_per_step, kernel_s (total device
    seconds by name), kernel_count, device_ops and idle_gaps (the
    ``breakdown``'s lists, at most ``top`` entries each)."""
    stretch = [e for e in events if not e[1] and e[0] == STRETCH]
    if not stretch:
        return {}
    lo, hi = stretch[0][2], stretch[0][3]
    device = [(n, max(a, lo), min(b, hi)) for n, dev, a, b in events
              if dev and not n.startswith(SPAN) and "Sync" not in n and b > lo and a < hi]
    host = [(n, a, b) for n, dev, a, b in events if not dev and lo <= a <= hi]
    kernel_s, kernel_count = defaultdict(float), defaultdict(int)
    device = [(short_name(n), a, b) for n, a, b in device]
    for n, a, b in device:
        kernel_s[n] += (b - a) / 1e9
        kernel_count[n] += 1
    busy = _union([(a, b) for _, a, b in device if b > a])
    busy_ns = sum(b - a for a, b in busy)
    gaps, prev = [], lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    spans = sorted(((a, b, n) for n, a, b in host if n.startswith(SPAN) and n != STRETCH))
    ops = sorted(((a, b, n) for n, a, b in host if not n.startswith(SPAN)))
    starts = [a for a, _, _ in ops]

    def doing(t):
        span = next((n for a, b, n in spans if a <= t <= b), "bench.other")
        inner = None
        for a, b, n in reversed(ops[:bisect.bisect_right(starts, t)][-400:]):
            if b >= t and (inner is None or b - a < inner[1] - inner[0]):
                inner = (a, b, n)
        return f"{span} / {inner[2] if inner else 'no host op'}"

    idle = defaultdict(float)
    for a, b in gaps[:top]:
        idle[doing((a + b) // 2)] += (b - a) / 1e9
    launches = sum(1 for n, _, _ in host if n in LAUNCH_CALLS)
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (hi - lo) / 1e9,
        "launches_per_step": launches / steps,
        "kernel_s": dict(kernel_s),
        "kernel_count": dict(kernel_count),
        "device_ops": sorted(([n, s] for n, s in kernel_s.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([n, s] for n, s in idle.items()), key=lambda x: -x[1])[:top],
    }


def kineto_events(prof) -> list:
    """(name, on_device, start_ns, end_ns) of every raw event of a finished
    ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    return [(e.name(), e.device_type() != DeviceType.CPU, e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()]
