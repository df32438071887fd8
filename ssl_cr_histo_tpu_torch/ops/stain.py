"""Histopathology stain augmentation: the v1 pools' HED shift and the v2
pool's HED and HSB colour augmenters, on (N, 3, H, W) images with per-image
parameters.

Counterpart of ``ssl_cr_histo_tpu/ops/stain.py:18-72``.
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


def _rows(v, img: torch.Tensor) -> torch.Tensor:
    """(N, 3) per-image channel parameters on ``img``'s device."""
    return torch.as_tensor(v, dtype=torch.float32, device=img.device).reshape(-1, 3)


def hed_color_augment(img: torch.Tensor, sigmas, biases, cutoff_low: float = 0.15,
                      cutoff_high: float = 0.85) -> torch.Tensor:
    """v2 ``HedColorAugmenter``: per channel ``hed * (1 + sigma) + bias`` in
    HED space, with (N, 3) sigmas and biases; an image whose mean over its
    pixels and channels lies outside [cutoff_low, cutoff_high] passes
    through unchanged (``stain.py:33-49``)."""
    mean = img.mean((1, 2, 3))
    inside = ((mean >= cutoff_low) & (mean <= cutoff_high)).view(-1, 1, 1, 1)
    hed = color.rgb2hed(img) * (1.0 + _rows(sigmas, img)).view(-1, 3, 1, 1) + _rows(biases, img).view(-1, 3, 1, 1)
    return torch.where(inside, color.hed2rgb(hed), img)


def hsb_color_augment(img: torch.Tensor, sigmas) -> torch.Tensor:
    """v2 ``HsbColorAugmenter`` with (N, 3) sigmas (hue, saturation,
    brightness): hue ``(h + (s0 mod 1)) mod 1`` with floor modulo;
    saturation and brightness scaled down by a negative sigma and toward 1
    by a positive one (``stain.py:52-72``)."""
    sg = _rows(sigmas, img)
    s0, s1, s2 = (sg[:, i].view(-1, 1, 1) for i in range(3))
    h, s, v = color.rgb2hsv_planes(img[:, 0], img[:, 1], img[:, 2])
    h = torch.remainder(h + torch.remainder(s0, 1.0), 1.0)
    s = torch.where(s1 < 0.0, s * (1.0 + s1), s * (1.0 + (1.0 - s) * s1))
    v = torch.where(s2 < 0.0, v * (1.0 + s2), v + (1.0 - v) * s2)
    return torch.stack(color.hsv2rgb_planes(h, s, v), 1)
