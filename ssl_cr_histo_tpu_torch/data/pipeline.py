"""Host -> device feeding.

Counterpart of the parts of ``ssl_cr_histo_tpu/data/pipeline.py`` that the
ported slices use (that module imports jax): epoch order, padding, and a
thread that runs a host iterator ahead of the consumer.  Samplers and
datasets ship raw uint8 batches; augmentation runs on the device.  Under
data parallelism every process iterates the same host batches and feeds its
own rows of each (``parallel.distributed.put_sharded``).  A feed given
``FeedCounters`` counts where its threads' time goes.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ssl_cr_histo_tpu_torch.parallel.distributed import local_rows
from ssl_cr_histo_tpu_torch.utils.profiling import span


class FeedCounters:
    """Where a feed's threads spend their time, as plain numbers that a
    caller reads before and after a stretch of steps (``snapshot``).  Each
    is written by one thread only:

    - ``starved``, ``starved_s``: the consumer's waits on its queue that
      found it empty, and the seconds it was blocked in them (``wait``);
    - ``reads[i]``: seconds the thread of source i spent in its iterator's
      ``next()`` (a sampler's reads, its tile cache's gather; ``timed``);
    - ``pins[j]``: seconds producer thread j spent stacking and pinning."""

    def __init__(self, sources: int, pinners: int):
        self.starved, self.starved_s = 0, 0.0
        self.reads, self.pins = [0.0] * sources, [0.0] * pinners

    def snapshot(self) -> dict:
        """starved, starved_s, read_s (all sources), pin_s (all producers)."""
        return {"starved": self.starved, "starved_s": self.starved_s, "read_s": sum(self.reads),
                "pin_s": sum(self.pins)}

    def wait(self, q: "queue.Queue"):
        """The consumer's ``q.get()``, inside the span ``port.feed.wait``;
        one clock pair when ``q`` is empty, none when it is not."""
        with span("feed.wait"):
            if not q.empty():
                return q.get()
            t = time.perf_counter()
            item = q.get()
            self.starved += 1
            self.starved_s += time.perf_counter() - t
            return item


def timed(it: Iterable, seconds: list, slot: int) -> Iterator:
    """``it``'s items, the seconds of each ``next()`` added to
    ``seconds[slot]`` by the thread that iterates."""
    it = iter(it)
    while True:
        t = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        seconds[slot] += time.perf_counter() - t
        yield item


def epoch_indices(n: int, batch_size: int, shuffle: bool = True, seed: int = 0,
                  drop_last: bool = True) -> Iterator[np.ndarray]:
    """Per-batch index arrays for one epoch over ``n`` items: a seeded
    shuffle, then consecutive slices; a short last batch is dropped when
    ``drop_last`` (``pipeline.py:19-34``)."""
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    end = n - (n % batch_size) if drop_last else n
    for i in range(0, end, batch_size):
        yield idx[i: i + batch_size]


def batch_iterator(arrays, batch_size: int, shuffle: bool = True, seed: int = 0,
                   drop_last: bool = True) -> Iterator:
    """Aligned batch tuples from equal-length arrays (``pipeline.py:37-46``)."""
    for sel in epoch_indices(len(arrays[0]), batch_size, shuffle, seed, drop_last):
        yield tuple(a[sel] for a in arrays)


def pad_batches(it: Iterable, batch_size: int = 0, multiple: int = 1) -> Iterator:
    """Zero-pad short batches to ``batch_size`` rows (0: their own length),
    and then to a multiple of ``multiple`` rows (the process count, so that
    every process gets equal rows, as JAX's ``pad_batches`` and
    ``put_sharded`` do, ``pipeline.py:49-73``), yielding (batch, valid) with a
    float32 validity mask.  Batches may be arrays or tuples of batch-aligned
    arrays."""
    for batch in it:
        is_tuple = isinstance(batch, tuple)
        parts = batch if is_tuple else (batch,)
        b = len(parts[0])
        rows = max(b, batch_size)
        rows += -rows % multiple
        valid = np.ones(rows, np.float32)
        if b != rows:
            pad = rows - b
            parts = tuple(
                np.concatenate([p, np.zeros((pad, *np.shape(p)[1:]), np.asarray(p).dtype)])
                for p in parts
            )
            valid[b:] = 0.0
        yield (parts if is_tuple else parts[0]), valid


def batch_groups(it: Iterable, k: int) -> Iterator[list]:
    """Lists of k consecutive batches, each a tuple, the last list shorter
    where the batches run out: the K steps a dispatch of
    ``parallel.steps.StepGraph`` (``pipeline.py:75-94``), each list
    stacked by ``stack_chunk``."""
    buf = []
    for batch in it:
        buf.append(batch if isinstance(batch, tuple) else (batch,))
        if len(buf) == k:
            yield buf
            buf = []
    if buf:
        yield buf


def stack_chunk(buf: list, k: int, out: list) -> tuple:
    """(stacked, valid) of a list of at most k batch tuples
    (``pipeline.py:97-105``), stacked into ``out``: one (k, B, ...) array
    for each array of a batch (the feed's pinned buffers), whatever they
    held.  Gives them back (a tuple when the batches hold more than one
    array) with a float32 (k,) mask.  A partial chunk is zero-padded with
    its padded steps marked invalid; the port runs only the valid steps,
    which gives the JAX scan's result (padded steps leave its state
    unchanged), so no batch is dropped."""
    n = len(buf)
    valid = np.zeros(k, np.float32)
    valid[:n] = 1.0
    for arrays, stacked in zip(zip(*buf), out, strict=True):
        np.stack(arrays, out=stacked[:n])
        stacked[n:] = 0
    return (out[0] if len(out) == 1 else tuple(out)), valid


def balanced_batch_iterator(ds, batch_size: int, seed: int = 0) -> Iterator:
    """Pool-balanced batches, the reference's Camelyon16 dual loaders
    (eval_Camelyon_SSL.py:50-75, :281-291; ``pipeline.py:198-240``):
    ``batch_size`` items from each of the two pools of
    ``datasets.grouping_key(ds)`` per step, so each batch has
    ``2 * batch_size`` rows, concatenated and then shuffled.  An epoch is
    the smaller pool's batch count.  The draws are the JAX package's
    ``np.random.default_rng(seed)`` calls in its order, so both yield the
    same batches for a seed.  Yields (images, polygon labels); a lazy
    dataset decodes each batch."""
    from ssl_cr_histo_tpu_torch.data.datasets import grouping_key  # datasets imports this module

    rng = np.random.default_rng(seed)
    key = grouping_key(ds)
    classes = np.unique(key)
    if len(classes) != 2:
        raise ValueError("balanced_batch_iterator expects two pools (binary labels or two source dirs)")
    idx_a = rng.permutation(np.where(key == classes[0])[0])
    idx_b = rng.permutation(np.where(key == classes[1])[0])
    gather = ds.decode if hasattr(ds, "decode") else (lambda sel: ds.images[sel])
    for i in range(min(len(idx_a), len(idx_b)) // batch_size):
        sel = np.concatenate([idx_a[i * batch_size: (i + 1) * batch_size],
                              idx_b[i * batch_size: (i + 1) * batch_size]])
        rng.shuffle(sel)
        yield gather(sel), ds.labels[sel]


def prefetch_iter(it: Iterable, size: int = 2, map_fn=None, counters: Optional[FeedCounters] = None) -> Iterator:
    """Run ``it`` (and ``map_fn`` on each item) on a background thread,
    ``size`` items ahead of the consumer (``pipeline.py:151-196``).  Stops
    the worker if the consumer goes away early; re-raises worker errors.
    With ``counters`` the consumer's waits are ``counters.wait``."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()
    errors = []

    def q_put(obj) -> bool:
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not q_put(item if map_fn is None else map_fn(item)):
                    return
        except BaseException as e:  # handed to the consumer, re-raised there
            errors.append(e)
        finally:
            q_put(end)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get() if counters is None else counters.wait(q)
            if item is end:
                break
            yield item
    finally:
        stop.set()
        t.join(timeout=10.0)
    if errors:
        raise errors[0]


def prefetch_to_device(it: Iterable, device: torch.device, size: int = 2,
                       counters: Optional[FeedCounters] = None, slot: int = 0) -> Iterator:
    """Device tensors of this process's rows of the array tuples ``it``
    yields, each a host-replicated global batch (``put_sharded``'s rows;
    the whole batch in one process).  A thread runs ``it`` (decoding and
    stacking a batch), keeps the rows and copies them into pinned memory
    ``size`` batches ahead; the consumer's thread starts each copy to the
    GPU without blocking (the JAX CLI's ``prefetch_to_device``).  With
    ``counters`` the consumer's waits are counted and the thread's pinning
    goes to ``counters.pins[slot]``."""
    pinned = device.type == "cuda"

    def host(batch):
        t0 = time.perf_counter()
        ts = tuple(torch.from_numpy(np.ascontiguousarray(local_rows(a))) for a in batch)
        ts = tuple(t.pin_memory() for t in ts) if pinned else ts
        if counters is not None:
            counters.pins[slot] += time.perf_counter() - t0
        return ts

    for batch in prefetch_iter(it, size=size, map_fn=host, counters=counters):
        yield tuple(t.to(device, non_blocking=pinned) for t in batch)
