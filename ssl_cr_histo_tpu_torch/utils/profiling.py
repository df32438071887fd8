"""Tracing.

Counterpart of ``ssl_cr_histo_tpu/utils/profiling.py``.  The reference's
only instrumentation is AverageMeter batch/data timers printed every
--print_freq steps (reference util.py:26-46, pretrain_BreastPathQ.py:74-87).
Here:

  * ``trace(logdir)`` -- a ``torch.profiler`` trace of a code region (the
                         card's kernels too, where CUDA is present),
                         written to ``logdir`` for TensorBoard or
                         chrome://tracing;
  * ``span(name)``    -- a ``port.<name>`` host range in whatever torch
                         profiler is recording on the calling thread
                         (``trace``'s, or any other), on the clock of the
                         device's kernels in the same trace; a shared
                         no-op when none is.

The port's counters are plain numbers kept where the work happens, always
on: the kernel wrappers' ``launches`` (``ops/rsp_augment_kernel.py``,
``ops/photometric_kernel.py``), ``parallel.steps.StepGraph.counts()`` and
the feed's ``data.pipeline.FeedCounters``.
"""

from __future__ import annotations

import contextlib

import torch

# the span outside a profiler: one object, entered and left for nothing
NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` capture of the block, CPU activity and, where CUDA
    is available, the card's; the trace is written under ``logdir`` when
    the block ends.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def span(name: str):
    """A ``port.<name>`` range while a torch profiler records on this
    thread; otherwise ``NO_SPAN``, which records nothing and allocates
    nothing: the whole cost is one call into torch to ask.

    The range is a ``cpu_op`` (torch's ``_RecordFunctionFast``), not the
    ``user_annotation`` of ``torch.profiler.record_function``: the profiler
    copies a user annotation onto the device's timeline over the kernels
    launched inside it, where a reader of the device's busy time would
    count the whole range as device work."""
    if not torch.autograd._profiler_enabled():
        return NO_SPAN
    return torch._C._profiler._RecordFunctionFast(f"port.{name}")
