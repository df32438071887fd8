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
the LR schedule.  PyTorch runs eagerly, so there is no jit and no multi-step
scan; the steps update ``state`` in place.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ssl_cr_histo_tpu_torch.ops import batch as aug_batch
from ssl_cr_histo_tpu_torch.ops.rsp_augment_kernel import RSP_PERMUTATIONS, permute_triplets
from ssl_cr_histo_tpu_torch.train.state import FinetuneState, Teacher, TrainState


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy, in float32."""
    return F.cross_entropy(logits.float(), labels.long())


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error (``steps.py:47``)."""
    return torch.mean((pred - target) ** 2)


def _autocast(device: torch.device, bf16: bool):
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16)


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
) -> dict:
    """One RSP pretraining step on (B, 3, H, W, 3) uint8 triplets in
    [HR, LR1, LR2] order, on the device of ``tiles_u8``.

    labels: (B,) ordering indices in [0, 6), checked when given (that reads
    them back from the device); sampled from ``generator`` when None (one
    ordering per triplet per step, ``steps.py:121-123``).
    augment: 'v1' or 'v2' (RandAugment(``n_aug``, ``m_aug``) per tile;
    ``steps.py:121-140``), in ``aug_mode``, which ``ops.batch`` maps to
    each pool's path (``augment_rsp_batch_v1``, ``augment_rsp_batch_v2``),
    or None.  The draws' tables come from
    ``host_gen`` (a CPU generator; ``generator`` when None), noise fields
    from ``generator``.  draws: injected augmentation draws for tests
    (``ops.batch.draw_rsp_v1``'s, ``ops.randaugment.draw_pretrain_v1``'s or
    ``draw_v2``'s dict).
    bf16: the augmentation writes bfloat16 and the backbone and heads run
    under bfloat16 autocast; the loss is float32.
    Returns {'loss', 'acc'} as device tensors (reading them synchronises);
    with ``return_feats`` also 'feats', the (B, 768) TripletNet features
    the classifier read, and 'labels', the (B,) orderings
    (``steps.py:74-80``, ``:170``), still on the device.
    """
    model, clf = state.model, state.classifier
    model.train()
    clf.train()
    b = tiles_u8.shape[0]
    if labels is None:
        labels = torch.randint(0, len(RSP_PERMUTATIONS), (b,), generator=generator, device=generator.device)
    elif bool(((labels < 0) | (labels >= len(RSP_PERMUTATIONS))).any()):
        raise ValueError(f"labels must be ordering indices in [0, {len(RSP_PERMUTATIONS)})")
    labels = labels.to(tiles_u8.device).long()
    # Each triplet is reordered by its label before the per-slot draws
    # apply, as in the JAX step: inside the fused kernel, where the uint8
    # tiles are read, for v1 fused; as a gather of the raw tiles otherwise.
    out_dtype = torch.bfloat16 if bf16 else torch.float32
    if augment == "v1":
        tiles = aug_batch.augment_rsp_batch_v1(generator, tiles_u8, mode=aug_mode, draws=draws, out_dtype=out_dtype,
                                               order=labels, host_gen=host_gen)
    elif augment == "v2":
        tiles = aug_batch.augment_rsp_batch_v2(
            generator if host_gen is None else host_gen, tiles_u8, n_aug, m_aug, mode=aug_mode, draws=draws,
            out_dtype=out_dtype, order=labels)
    elif augment is None:
        tiles_u8 = permute_triplets(tiles_u8, labels)
        tiles = aug_batch.normalize_batch(aug_batch.to_float(tiles_u8).permute(0, 1, 4, 2, 3),
                                          channel_axis=2)
    else:
        raise ValueError(f"unknown augment {augment!r} (v1, v2 or None)")

    with _autocast(tiles.device, bf16):
        if joint_encode:
            feats = model.forward_joint(tiles)
        else:
            feats = model(tiles[:, 0], tiles[:, 1], tiles[:, 2])
        logits = clf(feats)
    loss = cross_entropy(logits, labels)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    acc = (logits.detach().argmax(-1) == labels).float().mean()
    out = {"loss": loss.detach(), "acc": acc}
    if return_feats:
        out.update(feats=feats.detach(), labels=labels)
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
    rows to zero.  Returns weighted sums {'loss_sum', 'correct', 'count'};
    with ``return_feats`` also 'feats', the (6, B, 768) TripletNet features
    under each ordering.

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
    if return_feats:
        out["feats"] = torch.stack(feats)
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
) -> dict:
    """One supervised fine-tune step on (B, H, W, 3) uint8 images and their
    (B,) labels, on the device of ``images_u8`` (``steps.py:367-386``).

    The 3-view stack (``ops.batch.augment_3view_batch``; ``draws`` injects
    its draws) gives B*3 views, b-major, each with its image's label; one
    ``encode_single`` pass and the head give logits (classification, mean
    cross-entropy, metric accuracy) or a score (regression, MSE against the
    float label, metric the loss).  Then an optimizer step and one step of
    the LR schedule.  bf16: backbone and head under bfloat16 autocast; the
    loss is float32.  Returns {'loss', 'metric'} as device tensors."""
    model, head = state.model, state.head
    model.train()
    head.train()
    views = aug_batch.augment_3view_batch(generator, images_u8, draws)
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
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return {"loss": loss.detach(), "metric": metric}


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
                         draws: Optional[dict] = None):
    """The labeled branch of consistency training (``steps.py:460-477``):
    with ``views`` 3, each (B, H, W, 3) uint8 image becomes its 3-view stack
    (``ops.batch.augment_3view_batch``), b-major, each view with its image's
    label; with 1, the image itself.  Returns float32 planar (views*B, 3, H,
    W) in [0, 1], not normalized, and the (views*B,) labels, on the device
    of the images."""
    if views == 1:
        return aug_batch.to_float(x_l_u8.permute(0, 3, 1, 2)), y_l.to(x_l_u8.device)
    if views != 3:
        raise ValueError("the reference 3-view stack supports views in {1, 3}")
    stacks = aug_batch.augment_3view_batch(gen, x_l_u8, draws)
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
) -> dict:
    """One teacher/student consistency step (``steps.py:480-585``; reference
    eval_Kather_SSL_CR.py:37-127) on the device of the images.

    (B, H, W, 3) uint8 labeled images ``x_l_u8`` with their (B,) labels, and
    (mu*B, H, W, 3) uint8 unlabeled images ``x_u_u8``.  The unlabeled images
    give weak and strong views (``ops.batch.transform_fix_batch`` under
    ``aug_mode``, ``steps.py:566``: tables from ``host_gen``, noise from
    ``gen``), the labeled ones their 3-view
    stack (``expand_labeled_batch``, from ``gen``); ``views`` = (labeled
    views, weak, strong), float32 planar in [0, 1], replaces both, for tests.
    The teacher runs on the weak views in eval mode, without gradient; the
    student on cat(labeled views, strong views) in one train-mode pass, so
    its BN statistics pool both.  Classification: cross-entropy on the
    labels plus ``lambda_u`` times cross-entropy of the strong views against
    the teacher's hard pseudo-labels (argmax of its softmax; ties to the
    first class); metric the labeled accuracy.  Regression: MSE on the
    labels plus ``lambda_u`` times the MSE between teacher and student
    outputs; metric the supervised loss.  Then an optimizer step on the
    student's trainable tensors and one step of the LR schedule.  bf16:
    teacher, student and head under bfloat16 autocast; losses in float32.
    Returns {'loss', 'sup', 'cons', 'metric'} as device tensors."""
    model, head = state.model, state.head
    if views is None:
        weak, strong = aug_batch.transform_fix_batch(gen, x_u_u8, n_aug, mode=aug_mode, host_gen=host_gen)
        x_l, y = expand_labeled_batch(gen, x_l_u8, y_l, labeled_views)
    else:
        x_l, weak, strong = views
        y = y_l.to(x_l.device).repeat_interleave(x_l.shape[0] // y_l.shape[0])
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
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return {"loss": loss.detach(), "sup": sup.detach(), "cons": cons.detach(), "metric": metric}


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
