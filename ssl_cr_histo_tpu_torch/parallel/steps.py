"""RSP pretraining train and eval steps.

Counterpart of ``ssl_cr_histo_tpu/parallel/steps.py:37-315``.  One train
step: augment on the device (one kernel: each uint8 triplet read in the
order of its label, composed warp, photometric chain, clip, normalize, cast
to the compute type), one backbone pass over the B*3 views, pairwise FC, the 6-way
classifier, cross-entropy, and an SGD-Nesterov step.  PyTorch runs eagerly,
so there is no jit and no multi-step scan; the step updates ``state`` in
place.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ssl_cr_histo_tpu_torch.ops import batch as aug_batch
from ssl_cr_histo_tpu_torch.ops.rsp_augment_kernel import RSP_PERMUTATIONS, permute_triplets
from ssl_cr_histo_tpu_torch.train.state import TrainState


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy, in float32."""
    return F.cross_entropy(logits.float(), labels.long())


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
    joint_encode: bool = True,
    bf16: bool = False,
) -> dict:
    """One RSP pretraining step on (B, 3, H, W, 3) uint8 triplets in
    [HR, LR1, LR2] order, on the device of ``tiles_u8``.

    labels: (B,) ordering indices in [0, 6), checked when given (that reads
    them back from the device); sampled from ``generator`` when None (one
    ordering per triplet per step, ``steps.py:121-123``).  draws: injected
    augmentation draws (``ops.batch.draw_rsp_v1``'s dict) for tests.
    bf16: the augmentation writes bfloat16 and the backbone and heads run
    under bfloat16 autocast; the loss is float32.
    Returns {'loss', 'acc'} as device tensors (reading them synchronises).
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
    # The ordering commutes with v1's per-tile augmentation draws, so it is
    # applied where the uint8 tiles are read: inside the fused kernel for v1,
    # as a gather of the raw tiles otherwise.
    if augment == "v1":
        tiles = aug_batch.augment_rsp_batch_v1(
            generator, tiles_u8, draws=draws, out_dtype=torch.bfloat16 if bf16 else torch.float32,
            order=labels)
    elif augment is None:
        tiles_u8 = permute_triplets(tiles_u8, labels)
        tiles = aug_batch.normalize_batch(aug_batch.to_float(tiles_u8).permute(0, 1, 4, 2, 3),
                                          channel_axis=2)
    else:
        raise NotImplementedError(
            f"augment {augment!r} is not ported yet (ROADMAP.md Queue 1: v2 augmentation)")

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
    return {"loss": loss.detach(), "acc": acc}


@torch.no_grad()
def pretrain_eval_step(
    state: TrainState,
    tiles_u8: torch.Tensor,
    valid: torch.Tensor,
    *,
    bf16: bool = False,
) -> dict:
    """Validation: no augmentation, running BN statistics, every triplet under
    all 6 orderings (``steps.py:271-315``).  ``valid`` (B,) weights padded
    rows to zero.  Returns weighted sums {'loss_sum', 'correct', 'count'}.

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
    with _autocast(tiles.device, bf16):
        emb = model.model(tiles.reshape(b * 3, *tiles.shape[2:])).reshape(b, 3, -1)
        for label in range(6):
            labels = torch.full((b,), label, dtype=torch.long, device=tiles.device)
            e = permute_triplets(emb, labels)
            logits = clf(model.pair_features(e[:, 0], e[:, 1], e[:, 2])).float()
            loss_sum += (F.cross_entropy(logits, labels, reduction="none") * w).sum()
            correct += ((logits.argmax(-1) == labels).float() * w).sum()
    return {"loss_sum": loss_sum, "correct": correct, "count": 6.0 * w.sum()}
