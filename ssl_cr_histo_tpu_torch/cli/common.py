"""Shared CLI plumbing: common flags, seeding, device selection, the task
configs of record, the optimizer factory, the ``--reference_exact`` preset,
``--resume``.

Counterpart of ``ssl_cr_histo_tpu/cli/common.py:16-204``, ``:219-223`` and
``:260-286``, with these differences:
  * no ``--photometric``: the device decides (the CUDA kernel on a GPU, the
    plain PyTorch chain on the CPU), so the preset has no such key;
  * ``--device`` (default ``cuda``): a missing GPU is an error, never a
    silent run on the CPU; the CPU tests pass ``--device cpu``;
  * a resumed run's random draws continue from the generators' states saved
    in its checkpoint, where the JAX CLIs advance their key chain.

``--multi_step K`` (default 8, as in the JAX CLIs) runs K train steps a
chunk: ``chunked_feed`` stacks K batches and copies them to the card at
once, and ``parallel.steps.StepGraph`` replays one CUDA graph a step on the
card; on the CPU it runs the eager step K times.  1 is one eager step a
batch.

Every CLI runs as N processes, one a card, under ``python3 -m
torch.distributed.run --nproc_per_node N -m ssl_cr_histo_tpu_torch.cli.<name>
...`` (``parallel.distributed``): ``resolve_device`` joins the process group
and takes ``cuda:LOCAL_RANK``; every process seeds alike.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
import time

import numpy as np
import torch

from ssl_cr_histo_tpu_torch.data.pipeline import (FeedCounters, batch_groups, prefetch_iter, prefetch_to_device,
                                                  stack_chunk, timed)
from ssl_cr_histo_tpu_torch.models import MODEL_NAMES
from ssl_cr_histo_tpu_torch.ops.batch import AUG_MODES
from ssl_cr_histo_tpu_torch.parallel import distributed
from ssl_cr_histo_tpu_torch.train import optim
from ssl_cr_histo_tpu_torch.train.checkpoint import Generators, latest_checkpoint, restore_checkpoint


@dataclasses.dataclass
class TaskConfig:
    """Per-dataset fine-tune and consistency config of record (BASELINE.md)."""

    name: str
    num_classes: int
    task: str  # 'classification' | 'regression'
    image_size: int
    batch_size: int
    optimizer: str
    lr: float
    milestones: tuple = (30, 60)
    gamma: float = 0.1
    # The reference's consistency scripts default to smaller batches than
    # its fine-tune ones (eval_*_SSL_CR.py --batch_size: BPQ 4, Camelyon16
    # 8, Kather 8); 0 = the fine-tune batch.
    cr_batch_size: int = 0
    # Train batches come from two pools (tumor and normal source dirs) drawn
    # in balance, batch_size from each, as Camelyon16's zipped loaders do
    balanced: bool = False

    @property
    def cr_batch(self) -> int:
        """Labeled images per consistency step (``common.py:30-37``)."""
        return self.cr_batch_size or self.batch_size

    def rows_per_step(self, batch_size: int) -> int:
        """Rows a train step takes at this batch setting: a balanced task
        draws ``batch_size`` from each of its two pools, the other tasks
        ``batch_size`` in all (``common.py:39-45``)."""
        return 2 * batch_size if self.balanced else batch_size


TASKS = {
    # eval_BreastPathQ_SSL.py:234-241: Adam 1e-4, batch 4, MSE head; CR batch 4
    "breastpathq": TaskConfig("breastpathq", 1, "regression", 256, 4, "adam", 1e-4),
    # eval_Camelyon_SSL.py:205-211: SGD-Nesterov 5e-4, batch 16 per class, 2-way CE;
    # CR batch 8 (eval_Camelyon_SSL_CR.py:247)
    "camelyon16": TaskConfig("camelyon16", 2, "classification", 256, 16, "sgd", 5e-4, cr_batch_size=8,
                             balanced=True),
    # eval_Kather_SSL.py:231-238: Adam 1e-5, batch 64, 9-way CE; CR batch 8
    # (eval_Kather_SSL_CR.py:267)
    "kather": TaskConfig("kather", 9, "classification", 224, 64, "adam", 1e-5, cr_batch_size=8),
}


def apply_task_overrides(args, cfg: TaskConfig) -> TaskConfig:
    """Fold CLI overrides into the task config of record."""
    if getattr(args, "image_size", 0):
        cfg = dataclasses.replace(cfg, image_size=args.image_size)
    return cfg


def balanced_epoch_len(key, batch_size: int) -> int:
    """Steps per epoch of ``data.pipeline.balanced_batch_iterator`` over
    pool key ``key`` (``datasets.grouping_key``): the smaller pool's count
    of ``batch_size`` batches (``common.py:232-257``), from which
    Camelyon16's LR milestones are counted; possibly 0.  Raises SystemExit
    when the key has other than two pools, before any data is decoded."""
    _, counts = np.unique(np.asarray(key, dtype=np.int64), return_counts=True)
    if len(counts) != 2:
        raise SystemExit(
            f"Camelyon16 balanced batching needs exactly two pools (tumor + normal source dirs, or binary "
            f"polygon labels); got {len(counts)} -- for multi-dir layouts pass exactly two comma-joined patch "
            f"dirs; for single-dir layouts the polygon labels (after any --labeled_train subsample) must "
            f"contain both classes")
    return int(counts.min()) // max(batch_size, 1)


def make_optimizer(kind: str, params, lr: float, weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    """'adam' or 'sgd' (Nesterov, momentum 0.9) over ``params``, with
    ``weight_decay`` added to the gradient as the reference's torch
    optimizers do (eval_BreastPathQ_SSL.py:396-397,
    eval_Camelyon_SSL.py:371); not decoupled AdamW."""
    if kind == "sgd":
        return optim.sgd_nesterov(params, lr, momentum=0.9, weight_decay=weight_decay)
    if kind == "adam":
        return optim.adam(params, lr, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {kind}")


# what --model_path, --finetune_ckpt and --eval_ckpt take (``train.checkpoint.load_checkpoint``)
CHECKPOINT_HELP = "a .pth of the port or the reference, or a checkpoint directory of the JAX package"


def add_multi_step_arg(parser: argparse.ArgumentParser) -> None:
    """``--multi_step`` of the three stage CLIs, with the JAX CLIs' default
    (``cli/pretrain.py:103``, ``cli/finetune.py:86``,
    ``cli/consistency.py:90``)."""
    parser.add_argument("--multi_step", type=int, default=8,
                        help="train steps a dispatch: K batches go to the card as one chunk and each step "
                             "replays one captured CUDA graph (on the CPU, K eager steps); 1 = one eager "
                             "step a batch")


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--model", default="resnet18", choices=MODEL_NAMES)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--save_dir", default="./runs")
    parser.add_argument("--print_freq", type=int, default=100)
    parser.add_argument("--bf16", action="store_true", default=True,
                        help="bfloat16 autocast around backbone and heads (params and "
                             "loss stay float32)")
    parser.add_argument("--no-bf16", dest="bf16", action="store_false")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' fails when no GPU is present")
    parser.add_argument("--aug_mode", default="fused", choices=AUG_MODES,
                        help="fused = one composed warp a tile (v1 pretraining: the fused kernel); fast = "
                             "batch-shared strong op sequence (consistency); masked = each strong op once, "
                             "where drawn (consistency; v2); exact = op-by-op reference semantics.  v1 "
                             "pretraining maps fast and masked to fused")
    parser.add_argument("--image_size", type=int, default=0,
                        help="override the input resolution (0 = default)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute each backbone block in the backward pass (torch.utils.checkpoint): "
                             "more compute for less activation memory; BN statistics as without it")
    parser.add_argument("--reference_exact", action="store_true",
                        help="strict-parity preset: every deviation default with a flag back to the "
                             "reference's behaviour (per-view BN, with-replacement subsampling, eager x6 "
                             "orderings, op-by-op exact augmentation, float32; REFERENCE_EXACT_PRESET). "
                             "Overrides the individual flags")


# The strict-parity preset (``common.py:156-204``), keys argparse dests, the
# JAX package's table without its ``photometric`` entry (the port has no
# such flag: the device picks the photometric path, and the exact mode runs
# no kernel):
#   bf16=False             the reference trains in float32
#   aug_mode="exact"       op-by-op reference augmentation
#   joint_encode=False     per-view BN statistics (pretrain)
#   expand_orderings=True  every triplet under all 6 orderings an epoch
#   with_replacement=True  the reference's np.random.choice subsampling
REFERENCE_EXACT_PRESET = {
    "common": {"bf16": False, "aug_mode": "exact"},
    "pretrain": {"joint_encode": False, "expand_orderings": True},
    "finetune": {"with_replacement": True},
    "consistency": {"with_replacement": True},
}


def apply_reference_exact(args, stage: str):
    """Resolve ``--reference_exact`` for a stage CLI, straight after parsing
    (``common.py:188-204``): the preset's common and ``stage`` entries
    override the individual flags the CLI has."""
    if not getattr(args, "reference_exact", False):
        return args
    for dest, value in {**REFERENCE_EXACT_PRESET["common"], **REFERENCE_EXACT_PRESET.get(stage, {})}.items():
        if hasattr(args, dest):
            setattr(args, dest, value)
    return args


def resolve_device(args) -> torch.device:
    """The run's device: ``--device cuda`` is ``cuda:LOCAL_RANK`` under
    ``torch.distributed.run`` (``cuda:0`` outside it), after joining the
    process group it describes (``distributed.initialize``: NCCL on the
    cards, gloo for ``--device cpu``).  Raises SystemExit when CUDA is asked
    for and missing.  TF32 is switched off for matmuls and cuDNN
    convolutions alike (cuDNN's default is on): float32 math stays float32,
    and bf16 is opted into with --bf16 alone."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available on this machine")
    distributed.initialize(device)
    device = distributed.local_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def seed_everything(seed: int, device: torch.device) -> torch.Generator:
    """Seed Python, numpy and torch's global generator (model init), and
    return the run's generator on ``device`` (augmentation and ordering
    draws); the same seed on every process of a data-parallel run, whose
    draws are the global batch's (``ops.batch``)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


def resume_training(args, state, best, generators: Generators) -> tuple:
    """The stage CLIs' ``--resume`` (``common.py:260-286``): 'auto' is the
    latest ``ckpt_<N>.pth`` under ``--save_dir`` (none: a fresh start); a
    path loads that checkpoint.  Restores ``state`` in place (optimizer,
    schedule and Lookahead included), the best value into ``best`` (the
    meta's ``best_val``, else ``best``, else ``val_metric``), and each of
    the run's ``generators``, so the resumed epochs draw what the
    uninterrupted run would have.  Returns (start epoch, the checkpoint's
    path or "").  A directory (the JAX package's checkpoint) is refused:
    its optimizer, Lookahead and schedule state do not carry over, as the
    reference's stage handoff never carries them (``checkpoint.py:58-66``),
    and a resumed run without them would not be the run that stopped."""
    path = args.resume
    if path == "auto":
        path = latest_checkpoint(args.save_dir) or ""
    if not path:
        return 1, ""
    if os.path.isdir(path):
        raise SystemExit(f"--resume {path}: a directory; --resume takes the port's own .pth, since the JAX "
                         f"package's optimizer, Lookahead and schedule state do not carry over (its weights do: "
                         f"--model_path or --finetune_ckpt, or cli.convert_checkpoint)")
    if not os.path.isfile(path):
        raise SystemExit(f"--resume {path}: no such checkpoint file")
    _, meta = restore_checkpoint(path, state, generators=generators)
    start_epoch = int(meta.get("epoch", 0)) + 1
    value = meta.get("best_val", meta.get("best", meta.get("val_metric")))
    if value is not None:
        best.restore(float(value))
    print(f"==> resumed from {path} (epoch {start_epoch - 1})")
    return start_epoch, path


class Feed:
    """``chunked_feed``'s iterator of (chunk, valid steps), with the feed's
    ``counters`` (``data.pipeline.FeedCounters``): a caller reads
    ``counters.snapshot()`` before and after a stretch of steps."""

    def __init__(self, chunks, counters: FeedCounters):
        self.chunks, self.counters = chunks, counters

    def __iter__(self):
        return self

    def __next__(self):
        return next(self.chunks)

    def close(self):
        """Stop the feed's threads."""
        self.chunks.close()


def chunked_feed(device: torch.device, k: int, *its) -> Feed:
    """The stage CLIs' feed of K steps a chunk (``common.py:289-299``).

    ``its`` yield tuples of batch-aligned arrays, each a host-replicated
    global batch; their tuples are zipped into one, and each iterator runs
    on its own thread.  With ``k`` > 1 this process's rows of K consecutive
    batches are grouped and stacked (``data.pipeline.batch_groups``,
    ``stack_chunk``), pinned on a thread, and copied to
    ``device`` once a chunk.  Yields (tuple of (K, rows, ...) tensors, the
    chunk's valid steps); the rows of a partial last chunk past its valid
    steps are zeros.  ``k`` = 1 is the per-batch feed of
    ``prefetch_to_device``, each batch a chunk of one.

    The counters: source i's ``next()`` in ``reads[i]``; the stacking and
    pinning in ``pins[0]`` (``k`` > 1, the chunk thread) or ``pins[i]``
    (``k`` = 1, source i's thread); the main thread's waits for a chunk,
    each in the span ``port.feed.wait``, in ``starved``/``starved_s``."""
    if k < 1:
        raise ValueError(f"--multi_step {k}: a chunk takes at least one step")
    counters = FeedCounters(len(its), len(its) if k == 1 else 1)
    sources = [timed(it, counters.reads, i) for i, it in enumerate(its)]
    if k == 1:
        return Feed(_batch_chunks(device, sources, counters), counters)
    return Feed(_stacked_chunks(device, k, sources, counters), counters)


def _batch_chunks(device, sources, counters):
    feeds = (prefetch_to_device(it, device, counters=counters, slot=i) for i, it in enumerate(sources))
    for parts in zip(*feeds):
        yield tuple(t.unsqueeze(0) for part in parts for t in part), 1


def _stacked_chunks(device, k, sources, counters):
    pinned = device.type == "cuda"

    def host(batches):
        t0 = time.perf_counter()
        chunk, valid = stack_chunk(batches, k)
        ts = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (chunk if isinstance(chunk, tuple) else (chunk,)))
        ts = tuple(t.pin_memory() for t in ts) if pinned else ts
        counters.pins[0] += time.perf_counter() - t0
        return ts, int(valid.sum())

    batches = (tuple(distributed.local_rows(a) for part in parts for a in part)
               for parts in zip(*(prefetch_iter(it) for it in sources)))
    for ts, n in prefetch_iter(batch_groups(batches, k), map_fn=host, counters=counters):
        yield tuple(t.to(device, non_blocking=pinned) for t in ts), n


def counters_line(feed: Feed, step, before: dict, feed_before: dict | None = None) -> str:
    """The epoch line's read of the feed's counters and of the step's
    (``parallel.steps.StepGraph.counts()``), less ``before`` and
    ``feed_before``, their values at the stretch's start (a feed made for
    the stretch counts from zero)."""
    f = feed.counters.snapshot()
    f = {key: v - (feed_before or {}).get(key, 0) for key, v in f.items()}
    s = {key: v - before[key] for key, v in step.counts().items()}
    return (f"feed starved {f['starved_s']:.3f} s in {f['starved']} waits, read {f['read_s']:.3f} s, "
            f"pin {f['pin_s']:.3f} s; step {s['eager_steps']} eager, {s['replays']} replays, "
            f"{s['captures']} captures ({s['capture_s']:.3f} s)")
