"""Train and eval steps of RSP pretraining, supervised fine-tuning and
consistency training.

Counterpart of ``ssl_cr_histo_tpu/parallel/steps.py:37-421`` and
``:460-639``.  A pretrain
step: augment on the device (one kernel: each uint8 triplet read in the
order of its label, composed warp, photometric chain, clip, normalize, cast
to the compute type), one backbone pass over the B*3 views, pairwise FC, the
6-way classifier, cross-entropy, and an SGD-Nesterov step.  A fine-tune
step: the 3-view stack (PyTorch ops), one ``encode_single`` pass over the
B*3 views, the head, cross-entropy or MSE, an Adam or SGD step and one step
of the LR schedule.  A consistency step: the weak and strong views of the
unlabeled images and the labeled 3-view stack (PyTorch ops), the teacher
on the weak views in eval mode, one student pass over the labeled and strong
views, supervised plus consistency loss, an optimizer step and one step of
the LR schedule.  The steps update ``state`` in place.

K steps a dispatch (the JAX package's ``make_pretrain_multi_step`` and the
``multi=True`` steps, ``steps.py:212-268``, ``:323-408``, ``:480-624``):
``StepGraph`` runs a chunk of K stacked batches.  On the card each step
after the run's first is one replay of a CUDA graph captured from the
step's device work; on the CPU it runs the eager step.  Either way the
steps equal K calls of the single step, bit for bit.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ssl_cr_histo_tpu_torch.ops import batch as aug_batch
from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK
from ssl_cr_histo_tpu_torch.ops import rsp_augment_kernel as RK
from ssl_cr_histo_tpu_torch.ops.rsp_augment_kernel import RSP_PERMUTATIONS, permute_triplets
from ssl_cr_histo_tpu_torch.parallel import distributed as D
from ssl_cr_histo_tpu_torch.parallel.mesh import rows_for_batch
from ssl_cr_histo_tpu_torch.train.state import FinetuneState, Teacher, TrainState
from ssl_cr_histo_tpu_torch.utils.profiling import span


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy, in float32."""
    return F.cross_entropy(logits.float(), labels.long())


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error (``steps.py:47``)."""
    return torch.mean((pred - target) ** 2)


def _autocast(device: torch.device, bf16: bool):
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16)


def shard_of(b: int, global_batch: Optional[int] = None) -> tuple:
    """(offset, global batch) of this process's ``b`` rows of a global batch
    of ``global_batch`` (None: ``b`` times the process count), checked
    against ``parallel.mesh.rows_for_batch``."""
    total = b * D.process_count() if global_batch is None else global_batch
    start, stop = rows_for_batch(total)
    if stop - start != b:
        raise ValueError(f"{b} rows, but this process's share of a global batch of {total} is {stop - start}")
    return start, total


def _update(state, loss: torch.Tensor) -> None:
    """Backward pass, the gradients averaged over the processes, an
    optimizer step."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    D.all_reduce_mean_(p.grad for group in state.optimizer.param_groups for p in group["params"]
                       if p.grad is not None)
    state.optimizer.step()


def _global_means(metrics: dict) -> dict:
    """Each scalar of ``metrics`` averaged over the processes (equal rows on
    each: the global batch's mean), in one all-reduce."""
    if D.process_count() > 1:
        keys = list(metrics)
        stacked = torch.stack([metrics[k].float() for k in keys])
        D.all_reduce_mean_([stacked])
        metrics = dict(zip(keys, stacked.unbind()))
    return metrics


def pretrain_step(
    state: TrainState,
    tiles_u8: torch.Tensor,
    generator: torch.Generator,
    labels: Optional[torch.Tensor] = None,
    draws: Optional[dict] = None,
    *,
    augment: Optional[str] = "v1",
    n_aug: int = 2,
    m_aug: float = 3.0,
    aug_mode: str = "fused",
    host_gen: Optional[torch.Generator] = None,
    joint_encode: bool = True,
    bf16: bool = False,
    return_feats: bool = False,
    global_batch: Optional[int] = None,
) -> dict:
    """One RSP pretraining step on (B, 3, H, W, 3) uint8 triplets in
    [HR, LR1, LR2] order, on the device of ``tiles_u8``: this process's
    rows of a global batch of ``global_batch`` triplets (None: B times the
    process count; see the module docstring).

    labels: (B,) ordering indices in [0, 6) of these rows, checked when
    given (that reads them back from the device); sampled from
    ``generator`` for the global batch when None (one ordering per triplet
    per step, ``steps.py:121-123``).
    augment: 'v1' or 'v2' (RandAugment(``n_aug``, ``m_aug``) per tile;
    ``steps.py:121-140``), in ``aug_mode``, which ``ops.batch`` maps to
    each pool's path (``augment_rsp_batch_v1``, ``augment_rsp_batch_v2``),
    or None.  The draws' tables come from
    ``host_gen`` (a CPU generator; ``generator`` when None), noise fields
    from ``generator``.  draws: injected augmentation draws for tests
    (``ops.batch.draw_rsp_v1``'s, ``ops.randaugment.draw_pretrain_v1``'s or
    ``draw_v2``'s dict), the global batch's.
    bf16: the augmentation writes bfloat16 and the backbone and heads run
    under bfloat16 autocast; the loss is float32.
    Returns the global batch's {'loss', 'acc'} as device tensors (reading
    them synchronises); with ``return_feats`` also 'feats', the global
    batch's (B, 768) TripletNet features the classifier read, and 'labels',
    its (B,) orderings (``steps.py:74-80``, ``:170``), still on the device.
    """
    if labels is not None and bool(((labels < 0) | (labels >= len(RSP_PERMUTATIONS))).any()):
        raise ValueError(f"labels must be ordering indices in [0, {len(RSP_PERMUTATIONS)})")
    tiles, labels = _pretrain_views(tiles_u8, generator, labels, draws, augment=augment, n_aug=n_aug, m_aug=m_aug,
                                    aug_mode=aug_mode, host_gen=host_gen, bf16=bf16, global_batch=global_batch)
    out = _pretrain_update(state, tiles, labels, joint_encode=joint_encode, bf16=bf16, return_feats=return_feats)
    state.step += 1
    return out


def _pretrain_views(tiles_u8: torch.Tensor, generator: torch.Generator, labels: Optional[torch.Tensor],
                    draws: Optional[dict], *, augment: Optional[str], n_aug: int, m_aug: float, aug_mode: str,
                    host_gen: Optional[torch.Generator], bf16: bool, global_batch: Optional[int]) -> tuple:
    """``pretrain_step``'s labels (drawn from ``generator`` when None) and
    its augmented (B, 3, 3, H, W) views."""
    b = tiles_u8.shape[0]
    shard = shard_of(b, global_batch)
    if labels is None:
        labels = torch.randint(0, len(RSP_PERMUTATIONS), (shard[1],), generator=generator,
                               device=generator.device)[shard[0]:shard[0] + b]
    labels = labels.to(tiles_u8.device).long()
    # Each triplet is reordered by its label before the per-slot draws
    # apply, as in the JAX step: inside the fused kernel, where the uint8
    # tiles are read, for v1 fused; as a gather of the raw tiles otherwise.
    out_dtype = torch.bfloat16 if bf16 else torch.float32
    if augment == "v1":
        tiles = aug_batch.augment_rsp_batch_v1(generator, tiles_u8, mode=aug_mode, draws=draws, out_dtype=out_dtype,
                                               order=labels, host_gen=host_gen, shard=shard)
    elif augment == "v2":
        tiles = aug_batch.augment_rsp_batch_v2(
            generator if host_gen is None else host_gen, tiles_u8, n_aug, m_aug, mode=aug_mode, draws=draws,
            out_dtype=out_dtype, order=labels, shard=shard)
    elif augment is None:
        tiles_u8 = permute_triplets(tiles_u8, labels)
        tiles = aug_batch.normalize_batch(aug_batch.to_float(tiles_u8).permute(0, 1, 4, 2, 3),
                                          channel_axis=2)
    else:
        raise ValueError(f"unknown augment {augment!r} (v1, v2 or None)")
    return tiles, labels


def _pretrain_update(state: TrainState, tiles: torch.Tensor, labels: torch.Tensor, *, joint_encode: bool,
                     bf16: bool, return_feats: bool) -> dict:
    """``pretrain_step``'s forward, loss and update on augmented views."""
    model, clf = state.model, state.classifier
    model.train()
    clf.train()
    with _autocast(tiles.device, bf16):
        if joint_encode:
            feats = model.forward_joint(tiles)
        else:
            feats = model(tiles[:, 0], tiles[:, 1], tiles[:, 2])
        logits = clf(feats)
    loss = cross_entropy(logits, labels)
    _update(state, loss)
    acc = (logits.detach().argmax(-1) == labels).float().mean()
    out = _global_means({"loss": loss.detach(), "acc": acc})
    if return_feats:
        out.update(feats=D.fetch_global(feats.detach()), labels=D.fetch_global(labels))
    return out


@torch.no_grad()
def pretrain_eval_step(
    state: TrainState,
    tiles_u8: torch.Tensor,
    valid: torch.Tensor,
    *,
    bf16: bool = False,
    return_feats: bool = False,
) -> dict:
    """Validation: no augmentation, running BN statistics, every triplet under
    all 6 orderings (``steps.py:271-315``).  ``valid`` (B,) weights padded
    rows to zero.  Returns the global batch's weighted sums {'loss_sum',
    'correct', 'count'} (this process's rows' sums, summed over the
    processes); with ``return_feats`` also 'feats', the global batch's
    (6, B, 768) TripletNet features under each ordering.

    In eval mode each view's embedding does not depend on the ordering, so
    the backbone runs once over the B*3 views and only the pairwise head and
    the classifier run per ordering: the same numbers as six full passes.
    """
    model, clf = state.model, state.classifier
    model.eval()
    clf.eval()
    tiles = aug_batch.to_float(tiles_u8).permute(0, 1, 4, 2, 3)
    tiles = aug_batch.normalize_batch(tiles, channel_axis=2)
    b = tiles.shape[0]
    w = valid.to(tiles.device).float()
    loss_sum = torch.zeros((), device=tiles.device)
    correct = torch.zeros((), device=tiles.device)
    feats = []
    with _autocast(tiles.device, bf16):
        emb = model.model(tiles.reshape(b * 3, *tiles.shape[2:])).reshape(b, 3, -1)
        for label in range(6):
            labels = torch.full((b,), label, dtype=torch.long, device=tiles.device)
            e = permute_triplets(emb, labels)
            f = model.pair_features(e[:, 0], e[:, 1], e[:, 2])
            logits = clf(f).float()
            loss_sum += (F.cross_entropy(logits, labels, reduction="none") * w).sum()
            correct += ((logits.argmax(-1) == labels).float() * w).sum()
            feats.append(f)
    out = {"loss_sum": loss_sum, "correct": correct, "count": 6.0 * w.sum()}
    D.all_reduce_sum_(out.values())
    if return_feats:
        out["feats"] = D.fetch_global(torch.stack(feats, 1)).transpose(0, 1)
    return out


def finetune_step(
    state: FinetuneState,
    images_u8: torch.Tensor,
    labels: torch.Tensor,
    generator: torch.Generator,
    task: str = "classification",
    draws: Optional[dict] = None,
    *,
    bf16: bool = False,
    global_batch: Optional[int] = None,
) -> dict:
    """One supervised fine-tune step on (B, H, W, 3) uint8 images and their
    (B,) labels, on the device of ``images_u8`` (``steps.py:367-386``):
    this process's rows of a global batch of ``global_batch`` images (None:
    B times the process count; see the module docstring).

    The 3-view stack (``ops.batch.augment_3view_batch``; ``draws`` injects
    its draws) gives B*3 views, b-major, each with its image's label; one
    ``encode_single`` pass and the head give logits (classification, mean
    cross-entropy, metric accuracy) or a score (regression, MSE against the
    float label, metric the loss).  Then an optimizer step and one step of
    the LR schedule.  bf16: backbone and head under bfloat16 autocast; the
    loss is float32.  Returns the global batch's {'loss', 'metric'} as
    device tensors."""
    out = _finetune_update(state, images_u8, labels, generator, task, draws, bf16=bf16, global_batch=global_batch)
    _schedule(state)
    return out


def _schedule(state: FinetuneState) -> None:
    """A fine-tune or consistency step's host bookkeeping: one step of the
    LR schedule, one more step counted."""
    state.scheduler.step()
    state.step += 1


def _finetune_update(state: FinetuneState, images_u8: torch.Tensor, labels: torch.Tensor,
                     generator: torch.Generator, task: str, draws: Optional[dict], *, bf16: bool,
                     global_batch: Optional[int]) -> dict:
    """``finetune_step``'s device work: the 3-view stack, the forward, the
    loss and the optimizer step."""
    model, head = state.model, state.head
    model.train()
    head.train()
    views = aug_batch.augment_3view_batch(generator, images_u8, draws, shard=shard_of(len(images_u8), global_batch))
    b, v = views.shape[:2]
    x = aug_batch.normalize_batch(views.reshape(b * v, *views.shape[2:]), channel_axis=1)
    labels = labels.to(images_u8.device).repeat_interleave(v)
    with _autocast(x.device, bf16):
        out = head(model.encode_single(x)).float()
    if task == "regression":
        loss = mse(out.squeeze(-1), labels.float())
        metric = loss.detach()
    else:
        loss = cross_entropy(out, labels)
        metric = (out.detach().argmax(-1) == labels).float().mean()
    _update(state, loss)
    return _global_means({"loss": loss.detach(), "metric": metric})


@torch.no_grad()
def forward(state: FinetuneState, images_u8: torch.Tensor, *, bf16: bool = False) -> torch.Tensor:
    """Eval-mode forward (running BN statistics): (B, H, W, 3) uint8 images
    -> (B, num_classes) float32 head outputs (``steps.py:411-421``)."""
    state.model.eval()
    state.head.eval()
    x = aug_batch.normalize_batch(aug_batch.to_float(images_u8).permute(0, 3, 1, 2), channel_axis=1)
    with _autocast(x.device, bf16):
        return state.head(state.model.encode_single(x)).float()


# ---------------------------------------------------------------------------
# Consistency training (SSL_CR stage 3)
# ---------------------------------------------------------------------------


def expand_labeled_batch(gen: torch.Generator, x_l_u8: torch.Tensor, y_l: torch.Tensor, views: int = 3,
                         draws: Optional[dict] = None, shard: Optional[tuple] = None):
    """The labeled branch of consistency training (``steps.py:460-477``):
    with ``views`` 3, each (B, H, W, 3) uint8 image becomes its 3-view stack
    (``ops.batch.augment_3view_batch``), b-major, each view with its image's
    label; with 1, the image itself.  Returns float32 planar (views*B, 3, H,
    W) in [0, 1], not normalized, and the (views*B,) labels, on the device
    of the images.  ``shard``: ``ops.batch``'s."""
    if views == 1:
        return aug_batch.to_float(x_l_u8.permute(0, 3, 1, 2)), y_l.to(x_l_u8.device)
    if views != 3:
        raise ValueError("the reference 3-view stack supports views in {1, 3}")
    stacks = aug_batch.augment_3view_batch(gen, x_l_u8, draws, shard=shard)
    b, v = stacks.shape[:2]
    return stacks.reshape(b * v, *stacks.shape[2:]), y_l.to(stacks.device).repeat_interleave(v)


def consistency_step(
    state: FinetuneState,
    teacher: Teacher,
    x_l_u8: torch.Tensor,
    y_l: torch.Tensor,
    x_u_u8: torch.Tensor,
    gen: torch.Generator,
    task: str = "classification",
    lambda_u: float = 1.0,
    n_aug: int = 7,
    labeled_views: int = 3,
    views: Optional[tuple] = None,
    host_gen: Optional[torch.Generator] = None,
    *,
    aug_mode: str = "fused",
    bf16: bool = False,
    global_batch: Optional[int] = None,
) -> dict:
    """One teacher/student consistency step (``steps.py:480-585``; reference
    eval_Kather_SSL_CR.py:37-127) on the device of the images: this
    process's rows of a global batch of ``global_batch`` labeled images and
    of its unlabeled batch (None: B times the process count; the unlabeled
    batch's global size is always its rows times the process count; see
    the module docstring).  Each process's student pass over cat(its
    labeled views, its strong views) is the JAX step's shard-local
    ``grouped_concat`` (``steps.py:429-458``); a ResNet's BatchNorm pools
    the union.

    (B, H, W, 3) uint8 labeled images ``x_l_u8`` with their (B,) labels, and
    (mu*B, H, W, 3) uint8 unlabeled images ``x_u_u8``.  The unlabeled images
    give weak and strong views (``ops.batch.transform_fix_batch`` under
    ``aug_mode``, ``steps.py:566``: tables from ``host_gen``, noise from
    ``gen``), the labeled ones their 3-view
    stack (``expand_labeled_batch``, from ``gen``); ``views`` = (labeled
    views, weak, strong), float32 planar in [0, 1], replaces both, for tests.
    The teacher runs on the weak views in eval mode, without gradient; the
    student on cat(labeled views, strong views) in one train-mode pass, so
    a ResNet's BN statistics pool both.  Classification: cross-entropy on the
    labels plus ``lambda_u`` times cross-entropy of the strong views against
    the teacher's hard pseudo-labels (argmax of its softmax; ties to the
    first class); metric the labeled accuracy.  Regression: MSE on the
    labels plus ``lambda_u`` times the MSE between teacher and student
    outputs; metric the supervised loss.  Then an optimizer step on the
    student's trainable tensors and one step of the LR schedule.  bf16:
    teacher, student and head under bfloat16 autocast; losses in float32.
    Returns the global batch's {'loss', 'sup', 'cons', 'metric'} as device
    tensors."""
    if views is None:
        weak, strong = _strong_views(x_u_u8, gen, n_aug, aug_mode, host_gen)
        x_l, y = expand_labeled_batch(gen, x_l_u8, y_l, labeled_views, shard=shard_of(len(x_l_u8), global_batch))
    else:
        x_l, weak, strong = views
        y = y_l.to(x_l.device).repeat_interleave(x_l.shape[0] // y_l.shape[0])
    out = _consistency_update(state, teacher, x_l, y, weak, strong, task, lambda_u, bf16=bf16)
    _schedule(state)
    return out


def _strong_views(x_u_u8: torch.Tensor, gen: torch.Generator, n_aug: int, aug_mode: str,
                  host_gen: Optional[torch.Generator]) -> tuple:
    """The unlabeled images' weak and strong views (``ops.batch.
    transform_fix_batch``), this process's rows."""
    return aug_batch.transform_fix_batch(gen, x_u_u8, n_aug, mode=aug_mode, host_gen=host_gen,
                                         shard=shard_of(len(x_u_u8)))


def _consistency_update(state: FinetuneState, teacher: Teacher, x_l: torch.Tensor, y: torch.Tensor,
                        weak: torch.Tensor, strong: torch.Tensor, task: str, lambda_u: float, *,
                        bf16: bool) -> dict:
    """``consistency_step``'s teacher and student passes, losses and
    optimizer step on its views (float32 planar in [0, 1]) and the labeled
    views' labels."""
    model, head = state.model, state.head
    norm = lambda t: aug_batch.normalize_batch(t, channel_axis=1)
    x_l, weak, strong = norm(x_l), norm(weak), norm(strong)
    b_l = x_l.shape[0]

    teacher.model.eval()
    teacher.head.eval()
    with torch.no_grad(), _autocast(weak.device, bf16):
        out_w = teacher.head(teacher.model.encode_single(weak)).float()
    model.train()
    head.train()
    with _autocast(x_l.device, bf16):
        out = head(model.encode_single(torch.cat([x_l, strong]))).float()
    out_l, out_s = out[:b_l], out[b_l:]
    if task == "regression":
        sup = mse(out_l.squeeze(-1), y.float())
        cons = mse(out_w.squeeze(-1), out_s.squeeze(-1))
        metric = sup.detach()
    else:
        sup = cross_entropy(out_l, y)
        cons = cross_entropy(out_s, torch.argmax(torch.softmax(out_w, -1), -1))
        metric = (out_l.detach().argmax(-1) == y).float().mean()
    loss = sup + lambda_u * cons
    _update(state, loss)
    return _global_means({"loss": loss.detach(), "sup": sup.detach(), "cons": cons.detach(), "metric": metric})


@torch.no_grad()
def refresh_teacher(teacher: Teacher, state: FinetuneState) -> Teacher:
    """Teacher <- student, parameters and BN buffers alike, in place
    (``steps.py:627-632``; the reference's per-epoch deepcopy,
    eval_Kather_SSL_CR.py:582-583); the teacher stays in eval mode without
    gradients."""
    teacher.model.load_state_dict(state.model.state_dict())
    teacher.head.load_state_dict(state.head.state_dict())
    return teacher


@torch.no_grad()
def ema_update(teacher: Teacher, state: FinetuneState, decay: float = 0.99) -> Teacher:
    """EMA teacher (``--ema``, not the reference's semantics;
    ``steps.py:635-639``): t <- decay * t + (1 - decay) * s for every
    parameter and BN running statistic (every floating tensor of the
    state_dicts), in place."""
    for t_mod, s_mod in ((teacher.model, state.model), (teacher.head, state.head)):
        student = s_mod.state_dict()
        for k, t in t_mod.state_dict().items():
            if t.is_floating_point():
                t.mul_(decay).add_(student[k], alpha=1.0 - decay)
    return teacher


# ---------------------------------------------------------------------------
# K steps a dispatch
# ---------------------------------------------------------------------------

# The kernel wrappers that count their launches (``launches``): a capture
# records their kernels without launching them, and each replay launches
# them once
_COUNTED = (RK, PK)


class StepGraph:
    """K train steps a dispatch, the port of the JAX package's multi step
    (``lax.scan`` over K steps, ``steps.py:212-268``).

    ``run(chunk, n)`` takes the first ``n`` rows of a chunk of K stacked
    batches, in order, and returns the steps' metrics stacked into (K, ...)
    tensors (rows from ``n`` on zero): a partial last chunk trains exactly
    its own batches, as the JAX scan's masked steps leave its state
    unchanged.  ``eager(*row)`` is the single step (``pretrain_step`` and
    the others) on a row of the chunk.

    On the CPU, and with K = 1, every step is ``eager``: the plain version
    of the graph.  On the card with K > 1 the run's first step is
    ``eager`` and real (it builds the optimizer's state and the libraries'
    handles); every later step is ``prologue(*row)``, run eagerly, which
    returns the tensors the step's device work reads (None: the row
    itself), then ``body(*inputs)``, that device work, whose metrics it
    returns, then ``epilogue()``, its host bookkeeping (the step count, the
    LR schedule): together the same step.  ``body`` is captured once as a
    ``torch.cuda.CUDAGraph`` over static copies of its inputs, after the
    allocator's cached blocks are released; each step
    copies its inputs into them and replays the graph, and ``run`` copies
    the outputs into the chunk's rows before the next replay.  The graph
    registers ``generators`` (the step's CUDA generators), so replay i
    draws what eager step i would.  The learning rates are host floats
    that the optimizer's step reads when it is captured: a change of the LR
    schedule captures the graph again.  A capture that fails raises;
    nothing falls back to eager steps.  A gloo world on the card cannot be
    captured (its collectives run on the host) and raises.

    Counters, always on (``counts()``): ``eager_steps``, ``replays``,
    ``captures`` (the first and each recapture) and ``capture_s``, the
    captures' host seconds (the capture's own synchronize with the card
    included).  Each ``prologue`` call is the span ``port.step.prologue``
    (``utils.profiling.span``)."""

    def __init__(self, name: str, eager: Callable, prologue: Optional[Callable], body: Callable,
                 epilogue: Callable, k: int, device: torch.device, generators: Sequence[torch.Generator] = (),
                 optimizer: Optional[torch.optim.Optimizer] = None):
        if k < 1:
            raise ValueError(f"--multi_step {k}: a chunk takes at least one step")
        self.name, self.eager, self.prologue, self.body, self.epilogue = name, eager, prologue, body, epilogue
        self.k = k
        self.graphed = torch.device(device).type == "cuda" and k > 1
        if self.graphed and D.process_count() > 1 and dist.get_backend() != "nccl":
            raise ValueError(f"--multi_step {k} on CUDA needs an NCCL world to capture the step's collectives; "
                             f"a {dist.get_backend()} world runs --multi_step 1")
        self.generators = [g for g in generators if g.device.type == "cuda"]
        self.optimizer = optimizer
        self.warm = False
        self.graph = self.static_in = self.static_out = self.lrs = None
        self.graph_launches = [0] * len(_COUNTED)
        self.eager_steps = self.replays = self.captures = 0
        self.capture_s = 0.0

    def counts(self) -> dict:
        """The step's counters, for a caller to read before and after a
        stretch of steps."""
        return {"eager_steps": self.eager_steps, "replays": self.replays, "captures": self.captures,
                "capture_s": self.capture_s}

    def run(self, chunk: Sequence[torch.Tensor], n: int) -> dict:
        out = None
        for i in range(n):
            m = self.step(*(x[i] for x in chunk))
            if out is None:
                out = {key: v.new_zeros((self.k, *v.shape)) for key, v in m.items()}
            for key, v in m.items():
                out[key][i].copy_(v)
        return out

    def step(self, *row) -> dict:
        """One step on a row of the chunk; its metrics (on the card, the
        graph's outputs, which the next replay overwrites)."""
        if not (self.graphed and self.warm):
            self.warm = True
            self.eager_steps += 1
            return self.eager(*row)
        if self.prologue is None:
            inputs = row
        else:
            with span("step.prologue"):
                inputs = self.prologue(*row)
        out = self._replay(inputs)
        self.epilogue()
        return out

    def _replay(self, inputs) -> dict:
        lrs = () if self.optimizer is None else tuple(float(g["lr"]) for g in self.optimizer.param_groups)
        if self.graph is None or lrs != self.lrs:
            self._capture(inputs)
            self.lrs = lrs
        for static, x in zip(self.static_in, inputs):
            static.copy_(x)
        self.graph.replay()
        self.replays += 1
        for module, n in zip(_COUNTED, self.graph_launches):
            module.launches += n
        return self.static_out

    def _capture(self, inputs) -> None:
        # the previous graph, and the memory it holds, goes first; then the
        # allocator's cached blocks (the eager step's freed activations): a
        # capture allocates from a pool of its own, which cannot take them
        # over, and a large model's step has room for one set of activations
        self.graph = self.static_in = self.static_out = None
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        t0 = time.perf_counter()
        static_in = tuple(x.clone() for x in inputs)
        before = [m.launches for m in _COUNTED]
        try:
            # thread-local: the feed's threads keep pinning the next chunks
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                static_out = self.body(*static_in)
        except Exception as e:
            raise RuntimeError(f"the {self.name} step could not be captured as a CUDA graph: "
                               f"{type(e).__name__}: {e}") from e
        finally:
            self.graph_launches = [m.launches - b for m, b in zip(_COUNTED, before)]
            for m, b in zip(_COUNTED, before):
                m.launches = b
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        self.captures += 1
        self.capture_s += time.perf_counter() - t0


def make_pretrain_multi_step(state: TrainState, generator: torch.Generator, k: int, *,
                             augment: Optional[str] = "v1", n_aug: int = 2, m_aug: float = 3.0,
                             aug_mode: str = "fused", host_gen: Optional[torch.Generator] = None,
                             joint_encode: bool = True, bf16: bool = False, return_feats: bool = False,
                             global_batch: Optional[int] = None) -> StepGraph:
    """``pretrain_step`` K steps a dispatch (``steps.py:212-268``): a
    ``StepGraph`` over chunks (tiles_u8 (K, B, 3, H, W, 3)[, labels (K,
    B)]).  The v1 pool's kernel path (``aug_mode`` fused, fast or masked)
    and ``augment`` None are whole-step graphs, the orderings drawn inside;
    v1 exact and v2 group their ops on the host
    (``ops.randaugment.stage_groups``), so the graph's prologue draws their
    orderings and makes their views.  Labels a chunk carries are checked
    by the run's first step (``pretrain_step``) and then taken as they are,
    as the JAX scan takes them."""
    aug = dict(augment=augment, n_aug=n_aug, m_aug=m_aug, aug_mode=aug_mode, host_gen=host_gen, bf16=bf16)

    def eager(tiles_u8, labels=None):
        return pretrain_step(state, tiles_u8, generator, labels=labels, joint_encode=joint_encode,
                             return_feats=return_feats, global_batch=global_batch, **aug)

    def views(tiles_u8, labels=None):
        return _pretrain_views(tiles_u8, generator, labels, None, global_batch=global_batch, **aug)

    def update(tiles, labels):
        return _pretrain_update(state, tiles, labels, joint_encode=joint_encode, bf16=bf16, return_feats=return_feats)

    def epilogue():
        state.step += 1

    if augment is None or (augment == "v1" and aug_mode != "exact"):
        prologue, body = None, lambda *row: update(*views(*row))
    else:
        prologue, body = views, update
    return StepGraph("pretrain", eager, prologue, body, epilogue, k, generator.device, [generator],
                     state.optimizer)


def make_finetune_multi_step(state: FinetuneState, generator: torch.Generator, k: int,
                             task: str = "classification", *, bf16: bool = False,
                             global_batch: Optional[int] = None) -> StepGraph:
    """``finetune_step`` K steps a dispatch (``make_finetune_step(multi=
    True)``, ``steps.py:323-408``): a ``StepGraph`` over chunks (images_u8
    (K, B, H, W, 3), labels (K, B)), the 3-view stack inside the graph."""
    def eager(images_u8, labels):
        return finetune_step(state, images_u8, labels, generator, task, bf16=bf16, global_batch=global_batch)

    def body(images_u8, labels):
        return _finetune_update(state, images_u8, labels, generator, task, None, bf16=bf16, global_batch=global_batch)

    return StepGraph("finetune", eager, None, body, lambda: _schedule(state), k, generator.device, [generator],
                     state.optimizer)


def make_consistency_multi_step(state: FinetuneState, teacher: Teacher, gen: torch.Generator, k: int,
                                task: str = "classification", lambda_u: float = 1.0, n_aug: int = 7,
                                labeled_views: int = 3, host_gen: Optional[torch.Generator] = None, *,
                                aug_mode: str = "fused", bf16: bool = False, global_batch: Optional[int] = None,
                                ema: float = 0.0) -> StepGraph:
    """``consistency_step`` K steps a dispatch, then under ``ema`` > 0 the
    EMA teacher's update (``ema_update``, the JAX scan carry's;
    ``make_consistency_step(multi=True)``, ``steps.py:480-624``): a
    ``StepGraph`` over chunks (x_l_u8 (K, B, H, W, 3), y_l (K, B), x_u_u8
    (K, mu B, H, W, 3)).  The strong views' tables and composed maps are
    drawn on the host (``ops.batch.draw_transform_fix``), so the graph's
    prologue makes the weak and strong views (on the card one kernel,
    ``ops/strong_views_kernel.py``); the labeled 3-view stack, both passes,
    the update and the EMA update are the graph.  The per-epoch
    ``refresh_teacher`` stays with the caller."""
    def eager(x_l_u8, y_l, x_u_u8):
        out = consistency_step(state, teacher, x_l_u8, y_l, x_u_u8, gen, task, lambda_u, n_aug,
                               labeled_views=labeled_views, host_gen=host_gen, aug_mode=aug_mode, bf16=bf16,
                               global_batch=global_batch)
        if ema > 0:
            ema_update(teacher, state, ema)
        return out

    def prologue(x_l_u8, y_l, x_u_u8):
        return (x_l_u8, y_l, *_strong_views(x_u_u8, gen, n_aug, aug_mode, host_gen))

    def body(x_l_u8, y_l, weak, strong):
        x_l, y = expand_labeled_batch(gen, x_l_u8, y_l, labeled_views, shard=shard_of(len(x_l_u8), global_batch))
        out = _consistency_update(state, teacher, x_l, y, weak, strong, task, lambda_u, bf16=bf16)
        if ema > 0:
            ema_update(teacher, state, ema)
        return out

    return StepGraph("consistency", eager, prologue, body, lambda: _schedule(state), k, gen.device, [gen],
                     state.optimizer)
