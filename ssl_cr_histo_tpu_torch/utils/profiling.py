"""Tracing and throughput meters.

Counterpart of ``ssl_cr_histo_tpu/utils/profiling.py``.  The reference's
only instrumentation is AverageMeter batch/data timers printed every
--print_freq steps (reference util.py:26-46, pretrain_BreastPathQ.py:74-87).
Here:

  * ``trace(logdir)``  -- a ``torch.profiler`` trace of a code region (the
                          card's kernels too, where CUDA is present),
                          written to ``logdir`` for TensorBoard or
                          chrome://tracing;
  * ``StepTimer``      -- host wall-clock meter that synchronises through a
                          scalar of the step's outputs before reading time
                          (PyTorch's CUDA calls return before the card is
                          done);
  * ``Throughput``     -- running items/s over a sliding window of steps.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` capture of the block, CPU activity and, where CUDA
    is available, the card's; the trace is written under ``logdir`` when
    the block ends.  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


@dataclass
class StepTimer:
    """Wall-clock step timer; pass any scalar of the step's outputs to
    ``elapsed`` to synchronise with the device before reading time."""

    _start: float = field(default_factory=time.time)

    def reset(self):
        self._start = time.time()

    def elapsed(self, sync_value=None) -> float:
        if sync_value is not None:
            float(sync_value)  # device -> host fetch: waits for the step
        return time.time() - self._start


@dataclass
class Throughput:
    """Running items/sec meter over a sliding window."""

    window: int = 50
    _times: list = field(default_factory=list)
    _counts: list = field(default_factory=list)

    def update(self, n_items: int, seconds: float):
        self._times.append(seconds)
        self._counts.append(n_items)
        if len(self._times) > self.window:
            self._times.pop(0)
            self._counts.pop(0)

    @property
    def items_per_sec(self) -> float:
        total_t = sum(self._times)
        return sum(self._counts) / total_t if total_t > 0 else 0.0
