"""Batched augmentation entry points on the device.

Counterpart of ``ssl_cr_histo_tpu/ops/batch.py``.  Only the main path of
RSP pretraining is ported: the v1 pool in fused mode, which on the card is
one hand-written kernel from the uint8 triplets to the normalized planar
batch (``ops/rsp_augment_kernel.py``).  The other policies raise
``NotImplementedError`` (see ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch

from ssl_cr_histo_tpu_torch.ops import fused
from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK
from ssl_cr_histo_tpu_torch.ops import rsp_augment_kernel as RK

# The reference scales by /255 only (ToTensor): mean 0, std 1.
DEFAULT_MEAN = (0.0, 0.0, 0.0)
DEFAULT_STD = (1.0, 1.0, 1.0)


def to_float(img_u8: torch.Tensor) -> torch.Tensor:
    return img_u8.to(torch.float32) / 255.0


def draw_rsp_v1(gen: torch.Generator, n: int, size: int) -> dict:
    """The per-tile draws of the fused v1 pool for ``n`` tiles: composed
    warp matrices and photometric params.  Noise is left to the kernel's
    Philox generator (``noise`` None)."""
    return {
        "geo": fused.draw_pretrain_geo_matrices(gen, n, size),
        "params": PK.draw_params(gen, n),
        "noise": None,
    }


def augment_rsp_batch_v1(gen: torch.Generator, triplets_u8: torch.Tensor, mode: str = "fused",
                         draws: Optional[dict] = None, mean=DEFAULT_MEAN, std=DEFAULT_STD,
                         out_dtype: torch.dtype = torch.float32,
                         order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """v1 RSP pretraining augmentation, clipped and normalized
    (``batch.py:40-74``, fused mode with the photometric kernel, then
    ``normalize_batch``).

    triplets_u8: (B, 3, H, W, 3) uint8, the sampler's layout.  Returns
    (B, 3, 3, H, W) ``(clip(aug(x)) - mean) / std`` in ``out_dtype``,
    channel-planar: the backbone's NCHW.  ``draws`` (see ``draw_rsp_v1``)
    injects the warp matrices, photometric params and noise; they are drawn
    from ``gen`` when None, and the Philox seeds always are.  ``order``
    (B,) reorders each triplet by ``RSP_PERMUTATIONS[order[b]]`` before the
    augmentation (the draws stay with the output slots); None keeps the
    tiles in the given order.  CUDA tensors run the fused kernel, CPU
    tensors its plain version.
    """
    if mode != "fused":
        raise NotImplementedError(
            f"aug_mode {mode!r} is not ported yet (ROADMAP.md Queue 1: v2/exact augmentation)")
    b, t, h, _, _ = triplets_u8.shape
    if draws is None:
        draws = draw_rsp_v1(gen, b * t, h)
    seeds = PK.draw_seeds(gen, b * t)
    if triplets_u8.is_cuda:
        fn = RK.rsp_augment_cuda
        if order is not None:
            order = order.to(torch.int32).contiguous()
    elif triplets_u8.device.type == "cpu":
        fn = RK.rsp_augment_plain
    else:
        raise ValueError(f"no v1 augmentation for device {triplets_u8.device}")
    return fn(triplets_u8, draws["geo"], draws["params"], seeds, draws["noise"], mean, std, out_dtype,
              order=order)


def normalize_batch(imgs: torch.Tensor, mean=DEFAULT_MEAN, std=DEFAULT_STD,
                    channel_axis: int = -1) -> torch.Tensor:
    """(x - mean) / std along ``channel_axis`` (``batch.py:163-173``)."""
    shape = [1] * imgs.ndim
    shape[channel_axis] = len(mean)
    mean_t = torch.as_tensor(mean, dtype=torch.float32, device=imgs.device).view(shape)
    std_t = torch.as_tensor(std, dtype=torch.float32, device=imgs.device).view(shape)
    return (imgs - mean_t) / std_t
