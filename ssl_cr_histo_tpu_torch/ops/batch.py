"""Batched augmentation entry points on the device.

Counterpart of ``ssl_cr_histo_tpu/ops/batch.py``.  Only the main path of
RSP pretraining is ported: the v1 pool in fused mode, with the photometric
chain in the hand-written kernel.  The other policies raise
``NotImplementedError`` (see ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch

from ssl_cr_histo_tpu_torch.ops import fused
from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK

# The reference scales by /255 only (ToTensor): mean 0, std 1.
DEFAULT_MEAN = (0.0, 0.0, 0.0)
DEFAULT_STD = (1.0, 1.0, 1.0)


def to_float(img_u8: torch.Tensor) -> torch.Tensor:
    return img_u8.to(torch.float32) / 255.0


def _clip01(img: torch.Tensor) -> torch.Tensor:
    """Final [0, 1] clamp of an augmented batch (``batch.py:32-37``)."""
    return torch.clamp(img, 0.0, 1.0)


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
                         draws: Optional[dict] = None) -> torch.Tensor:
    """v1 RSP pretraining augmentation (``batch.py:40-74``, fused mode with
    the photometric kernel).

    triplets_u8: (B, 3, H, W, 3) uint8, the sampler's layout.  Returns
    (B, 3, 3, H, W) float32 in [0, 1], channel-planar: the kernel's layout
    and the backbone's NCHW.  ``draws`` (see ``draw_rsp_v1``) injects the
    warp matrices, photometric params and noise; they are drawn from
    ``gen`` when None.
    """
    if mode != "fused":
        raise NotImplementedError(
            f"aug_mode {mode!r} is not ported yet (ROADMAP.md Queue 1: v2/exact augmentation)")
    b, t, h, w, _ = triplets_u8.shape
    imgs = to_float(triplets_u8.reshape(b * t, h, w, 3).permute(0, 3, 1, 2)).contiguous()
    if draws is None:
        draws = draw_rsp_v1(gen, b * t, h)
    warped = fused.pretrain_geo_warp_planar(imgs, draws["geo"])
    out = PK.pretrain_photometric(warped, gen, noise=draws["noise"], params=draws["params"])
    return _clip01(out).reshape(b, t, 3, h, w)


def normalize_batch(imgs: torch.Tensor, mean=DEFAULT_MEAN, std=DEFAULT_STD,
                    channel_axis: int = -1) -> torch.Tensor:
    """(x - mean) / std along ``channel_axis`` (``batch.py:163-173``)."""
    shape = [1] * imgs.ndim
    shape[channel_axis] = len(mean)
    mean_t = torch.as_tensor(mean, dtype=torch.float32, device=imgs.device).view(shape)
    std_t = torch.as_tensor(std, dtype=torch.float32, device=imgs.device).view(shape)
    return (imgs - mean_t) / std_t
