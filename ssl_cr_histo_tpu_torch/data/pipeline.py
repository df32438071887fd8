"""Host -> device feeding.

Counterpart of the parts of ``ssl_cr_histo_tpu/data/pipeline.py`` that the
pretraining slice uses (that module imports jax).  The sampler ships raw
uint8 batches; augmentation runs on the device.  A prefetch thread that
overlaps reading with the step is later work (ROADMAP.md).
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch


def pad_batches(it: Iterable, batch_size: int) -> Iterator:
    """Zero-pad trailing partial batches to ``batch_size``, yielding
    (batch, valid) with a float32 validity mask (``pipeline.py:49-73``).
    Batches may be arrays or tuples of batch-aligned arrays."""
    for batch in it:
        is_tuple = isinstance(batch, tuple)
        parts = batch if is_tuple else (batch,)
        b = len(parts[0])
        valid = np.ones(batch_size, np.float32)
        if b != batch_size:
            pad = batch_size - b
            parts = tuple(
                np.concatenate([p, np.zeros((pad, *np.shape(p)[1:]), np.asarray(p).dtype)])
                for p in parts
            )
            valid[b:] = 0.0
        yield (parts if is_tuple else parts[0]), valid


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a host array to ``device``: through pinned memory and without
    blocking the host when the device is a GPU."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
