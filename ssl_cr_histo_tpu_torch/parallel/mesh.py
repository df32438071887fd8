"""The data axis: which rows of a global batch each process takes.

Counterpart of ``ssl_cr_histo_tpu/parallel/mesh.py:34-65``
(``mesh_for_batch``).  The JAX package lays a batch over a mesh of devices;
here each process drives one device, so the data axis is the world of
processes (``parallel.distributed``) and rank r takes the r-th contiguous
block of rows, as a batch sharded over the mesh's data axis puts them.

The JAX single-process branch, a mesh shrunk to the gcd of the batch and
the device count with a warning, has no counterpart: one torch process is
one device, so an indivisible batch is always the multi-process case and
raises.  The ``model`` axis, ``chunk_sharding`` and ``shard_batch`` are not
carried (ROADMAP.md, "Do not carry").
"""

from __future__ import annotations

from typing import Tuple

from ssl_cr_histo_tpu_torch.parallel.distributed import process_count, process_index


def rows_for_batch(batch_size: int) -> Tuple[int, int]:
    """This process's rows ``[start, stop)`` of a global batch of
    ``batch_size``: all of them in one process.  Raises ValueError when the
    world does not divide the batch (``mesh.py:52-61``)."""
    n = process_count()
    if batch_size % n:
        raise ValueError(
            f"batch_size={batch_size} is not divisible by the {n}-device data axis on a {n}-process run; "
            f"choose a global batch divisible by the device count (or pad with data.pipeline.pad_batches)")
    per = batch_size // n
    start = process_index() * per
    return start, start + per
