"""Host -> device feeding.

Counterpart of the parts of ``ssl_cr_histo_tpu/data/pipeline.py`` that the
ported slices use (that module imports jax): epoch order, padding, and a
thread that runs a host iterator ahead of the consumer.  Samplers and
datasets ship raw uint8 batches; augmentation runs on the device.  Under
data parallelism every process iterates the same host batches and feeds its
own rows of each (``parallel.distributed.put_sharded``).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from ssl_cr_histo_tpu_torch.parallel.distributed import local_rows


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


def prefetch_iter(it: Iterable, size: int = 2, map_fn=None) -> Iterator:
    """Run ``it`` (and ``map_fn`` on each item) on a background thread,
    ``size`` items ahead of the consumer (``pipeline.py:151-196``).  Stops
    the worker if the consumer goes away early; re-raises worker errors."""
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
            item = q.get()
            if item is end:
                break
            yield item
    finally:
        stop.set()
        t.join(timeout=10.0)
    if errors:
        raise errors[0]


def prefetch_to_device(it: Iterable, device: torch.device, size: int = 2) -> Iterator:
    """Device tensors of this process's rows of the array tuples ``it``
    yields, each a host-replicated global batch (``put_sharded``'s rows;
    the whole batch in one process).  A thread runs ``it`` (decoding and
    stacking a batch), keeps the rows and copies them into pinned memory
    ``size`` batches ahead; the consumer's thread starts each copy to the
    GPU without blocking (the JAX CLI's ``prefetch_to_device``)."""
    pinned = device.type == "cuda"

    def host(batch):
        ts = tuple(torch.from_numpy(np.ascontiguousarray(local_rows(a))) for a in batch)
        return tuple(t.pin_memory() for t in ts) if pinned else ts

    for batch in prefetch_iter(it, size=size, map_fn=host):
        yield tuple(t.to(device, non_blocking=pinned) for t in batch)
