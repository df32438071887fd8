"""Histopathology stain augmentation of the v1 strong pool.

Counterpart of ``ssl_cr_histo_tpu/ops/stain.py:18-30``.
"""

from __future__ import annotations

import torch

from ssl_cr_histo_tpu_torch.ops import color


def hed_shift(img: torch.Tensor, dh, de, dd) -> torch.Tensor:
    """v1 ``colour_augmentation``: an additive per-image shift in HED space,
    ``hed2rgb(rgb2hed(img) + (dh, de, dd))`` on (N, 3, H, W) images with (N,)
    shifts.  At zero shift this is ``(img + 1) / 2``, the reference's
    legacy-skimage behaviour."""
    shift = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=img.device).reshape(-1)
                         for v in (dh, de, dd)], 1)
    return color.hed2rgb(color.rgb2hed(img) + shift.view(-1, 3, 1, 1))
