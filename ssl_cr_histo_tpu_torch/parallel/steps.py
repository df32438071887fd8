"""RSP pretraining train and eval steps.

Counterpart of ``ssl_cr_histo_tpu/parallel/steps.py:37-315``.  One train
step: permute each uint8 triplet by its ordering label, augment on the
device (one composed warp per tile, then the photometric kernel), clip and
normalize, one backbone pass over the B*3 views, pairwise FC, the 6-way
classifier, cross-entropy, and an SGD-Nesterov step.  PyTorch runs eagerly,
so there is no jit and no multi-step scan; the step updates ``state`` in
place.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ssl_cr_histo_tpu_torch.ops import batch as aug_batch
from ssl_cr_histo_tpu_torch.train.state import TrainState

# The 6 resolution-sequence orderings and their class labels (reference
# dataset.py:36-38: tuple order is [HR, LR1, LR2]).  Copied from
# ssl_cr_histo_tpu/parallel/steps.py:37-40, which imports jax.
RSP_PERMUTATIONS = np.array(
    [[0, 1, 2], [0, 2, 1], [1, 2, 0], [1, 0, 2], [2, 0, 1], [2, 1, 0]],
    dtype=np.int32,
)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy, in float32."""
    return F.cross_entropy(logits.float(), labels.long())


def permute_triplets(tiles: torch.Tensor, perm_idx: torch.Tensor) -> torch.Tensor:
    """Reorder each triplet (dim 1) by its ordering index (``steps.py:51-54``)."""
    perms = torch.as_tensor(RSP_PERMUTATIONS, device=tiles.device).long()[perm_idx.long()]
    index = perms.view(perms.shape[0], 3, *([1] * (tiles.dim() - 2)))
    return torch.take_along_dim(tiles, index, dim=1)


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

    labels: (B,) ordering indices; sampled from ``generator`` when None (one
    ordering per triplet per step, ``steps.py:121-123``).  draws: injected
    augmentation draws (``ops.batch.draw_rsp_v1``'s dict) for tests.
    bf16: autocast the backbone and heads to bfloat16; the loss is float32.
    Returns {'loss', 'acc'} as device tensors (reading them synchronises).
    """
    model, clf = state.model, state.classifier
    model.train()
    clf.train()
    b = tiles_u8.shape[0]
    if labels is None:
        labels = torch.randint(0, 6, (b,), generator=generator, device=generator.device)
    labels = labels.to(tiles_u8.device).long()
    # permuting the raw uint8 tiles moves 4x fewer bytes than the floats, and
    # commutes with v1's per-tile augmentation draws
    tiles_u8 = permute_triplets(tiles_u8, labels)
    if augment == "v1":
        tiles = aug_batch.augment_rsp_batch_v1(generator, tiles_u8, draws=draws)
    elif augment is None:
        tiles = aug_batch.to_float(tiles_u8).permute(0, 1, 4, 2, 3)
    else:
        raise NotImplementedError(
            f"augment {augment!r} is not ported yet (ROADMAP.md Queue 1: v2 augmentation)")
    tiles = aug_batch.normalize_batch(tiles, channel_axis=2)

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
