"""Data parallelism across processes, one process a device.

Counterpart of ``ssl_cr_histo_tpu/parallel/distributed.py:1-130``, on
``torch.distributed``.  A run of N processes is launched with

    python3 -m torch.distributed.run --nproc_per_node N -m ssl_cr_histo_tpu_torch.cli.pretrain ...

which sets ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and the rendezvous
address in each process's environment.  The feed is the JAX CLIs':
host-replicated data.  Every process loads the same dataset and draws the
same seeded shuffles and random draws, so each holds the whole global batch
on the host and keeps its own contiguous rows (``put_sharded``); outputs a
caller needs whole come back through ``fetch_global``.

The model is not wrapped in ``DistributedDataParallel``: the steps call
``forward_joint`` and ``encode_single``, which bypass ``DDP.forward`` and
so would never arm its gradient reduction.  The steps average the gradients
themselves (``all_reduce_mean_``), and BatchNorm takes its training
statistics over the global batch (``models.resnet``).

Every collective here is an ``all_reduce``, a ``broadcast`` or a
``barrier``, which both backends take on CPU and CUDA tensors alike (gloo
has no ``all_gather`` of CUDA tensors).  Without an initialised world of
more than one process each function is the single-process identity, and
issues no collective.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(device: "torch.device | str" = "cuda", backend: Optional[str] = None) -> None:
    """Join the process group that ``torch.distributed.run`` describes in
    the environment (``init_method="env://"``).  A no-op without
    ``WORLD_SIZE`` and ``RANK`` in the environment, and when the group is
    already initialised (two CLI mains in one process).  ``backend``
    defaults to ``nccl`` for a CUDA ``device`` and ``gloo`` for the CPU; a
    CUDA run first makes ``cuda:LOCAL_RANK`` its current device."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if device.type == "cuda":
        device = local_device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(backend, init_method="env://", **kwargs)


def local_device(device: "torch.device | str") -> torch.device:
    """``cuda`` without an index is ``cuda:LOCAL_RANK`` under a launch; any
    other device, and any device outside a launch, is itself."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def process_count() -> int:
    """Processes in the world; 1 when none is initialised."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 when no world is initialised."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes checkpoints, logs and artifacts."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every process (a no-op in one process)."""
    if process_count() > 1:
        dist.barrier()


def local_rows(x):
    """This process's contiguous rows of a host-replicated global batch
    (a numpy array or a tensor; the batch is the leading axis), a view.
    Raises ValueError when the world does not divide the batch
    (``parallel.mesh.rows_for_batch``)."""
    from ssl_cr_histo_tpu_torch.parallel.mesh import rows_for_batch

    if process_count() == 1:
        return x
    start, stop = rows_for_batch(len(x))
    return x[start:stop]


def put_sharded(x, device: "torch.device | str", non_blocking: bool = False) -> torch.Tensor:
    """This process's rows of the host-replicated global batch ``x`` on
    ``device`` (``distributed.py:92-113``): in one process, the whole batch."""
    x = local_rows(x)
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    return t.to(device, non_blocking=non_blocking)


def fetch_global(x: torch.Tensor) -> torch.Tensor:
    """The global batch whose rows ``x`` are on this process, whole on every
    process, in rank order (``distributed.py:116-130``).  Every process
    holds equal rows.  A sum over a zero-filled (world * rows, ...) buffer
    into which each process has written its rows: adding zeros is exact,
    so the rows arrive bit for bit.  In one process, ``x`` itself."""
    world = process_count()
    if world == 1:
        return x
    rows = x.shape[0]
    # neither backend sums bool tensors
    buf = torch.zeros((world * rows, *x.shape[1:]), dtype=torch.uint8 if x.dtype == torch.bool else x.dtype,
                      device=x.device)
    rank = process_index()
    buf[rank * rows:(rank + 1) * rows] = x
    dist.all_reduce(buf)
    return buf.bool() if x.dtype == torch.bool else buf


def _bucketed_(tensors: Iterable[torch.Tensor], collective) -> None:
    """Run ``collective`` on one flat copy of the tensors of each (device,
    dtype), in order, and copy the result back into them."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_mean_(tensors: Iterable[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the processes, in place: one
    flat bucket and one ``all_reduce`` a dtype (the gradient average of
    every step).  A no-op in one process."""
    world = process_count()
    if world > 1:
        _bucketed_(tensors, lambda flat: (dist.all_reduce(flat), flat.div_(world)))


def all_reduce_sum_(tensors: Iterable[torch.Tensor]) -> None:
    """Replace each tensor by its sum over the processes, in place, as
    ``all_reduce_mean_`` does (validation sums).  A no-op in one process."""
    if process_count() > 1:
        _bucketed_(tensors, dist.all_reduce)


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with process ``src``'s, in place: one flat
    bucket and one ``broadcast`` a dtype.  A no-op in one process."""
    if process_count() > 1:
        _bucketed_(tensors, lambda flat: dist.broadcast(flat, src))
