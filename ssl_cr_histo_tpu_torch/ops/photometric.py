"""Photometric ops of the v1 strong pool on channel-planar (N, 3, H, W)
float32 images in [0, 1], with one parameter per image.

Counterpart of ``ssl_cr_histo_tpu/ops/photometric.py:27-83`` (the
albumentations-style ops): the same formulas, and each op clips where the
JAX op clips.  Per-image parameters are (N,) tensors (or Python floats),
broadcast over channels and pixels.
"""

from __future__ import annotations

import torch

from ssl_cr_histo_tpu_torch.ops import color


def _per_image(p, like: torch.Tensor) -> torch.Tensor:
    """(N,) parameters -> (N, 1, 1, 1) on ``like``'s device."""
    return torch.as_tensor(p, dtype=torch.float32, device=like.device).reshape(-1, 1, 1, 1)


def brightness_contrast(img: torch.Tensor, brightness=0.0, contrast=0.0) -> torch.Tensor:
    """albumentations ``RandomBrightnessContrast`` (brightness_by_max):
    ``clip(img * (1 + contrast) + brightness)`` (``photometric.py:27-30``)."""
    return torch.clamp(img * (1.0 + _per_image(contrast, img)) + _per_image(brightness, img), 0.0, 1.0)


def hsv_shift(img: torch.Tensor, hue_shift=0.0, sat_shift=0.0, val_shift=0.0) -> torch.Tensor:
    """albumentations ``HueSaturationValue`` on float images, shifts in its
    uint8 units: hue in OpenCV H units (180 a full turn), saturation and
    value in steps of 1/255; s and v clipped, hue wrapped
    (``photometric.py:33-44``)."""
    h, s, v = color.rgb2hsv_planes(img[:, 0], img[:, 1], img[:, 2])
    p = lambda x: _per_image(x, img).view(-1, 1, 1)
    h = torch.remainder(h + p(hue_shift) / 180.0, 1.0)
    s = torch.clamp(s + p(sat_shift) / 255.0, 0.0, 1.0)
    v = torch.clamp(v + p(val_shift) / 255.0, 0.0, 1.0)
    return torch.stack(color.hsv2rgb_planes(h, s, v), 1)


def gaussian_noise(img: torch.Tensor, noise: torch.Tensor, sigma) -> torch.Tensor:
    """``clip(img + noise * sigma)``, ``noise`` a standard normal field of
    ``img``'s shape drawn by the caller (``photometric.py:47-51``, which
    draws it from its key)."""
    return torch.clamp(img + noise * _per_image(sigma, img), 0.0, 1.0)


def _reflect101_index(size: int, r: int, device) -> torch.Tensor:
    idx = torch.arange(-r, size + r, device=device).abs()
    period = max(2 * (size - 1), 1)
    idx = idx % period
    return torch.where(idx >= size, period - idx, idx)


def box_blur_planes(x: torch.Tensor, ksize: torch.Tensor, max_k: int = 7) -> torch.Tensor:
    """Separable box blur of (N, H, W) planes with reflect101 borders and a
    per-plane odd ksize <= max_k ((N, 1, 1)) via masked taps: rows first,
    then columns, each tap sum taken in ascending offset order and divided
    by the tap count (``pallas_photometric.py:62-81``)."""
    r = max_k // 2
    offsets = torch.arange(-r, r + 1, device=x.device, dtype=x.dtype).abs()
    taps = (offsets <= (ksize - 1.0) / 2.0).to(x.dtype)  # (N, 1, 2r + 1)
    norm = taps.sum(-1, keepdim=True)
    for dim in (1, 2):
        size = x.shape[dim]
        padded = x.index_select(dim, _reflect101_index(size, r, x.device))
        acc = torch.zeros_like(x)
        for k in range(2 * r + 1):
            acc = acc + taps[..., k:k + 1] * padded.narrow(dim, k, size)
        x = acc / norm
    return x


def box_blur(img: torch.Tensor, ksize, max_ksize: int = 7) -> torch.Tensor:
    """albumentations ``Blur`` (cv2.blur, reflect101 borders) with an odd
    per-image ``ksize`` <= ``max_ksize`` (``photometric.py:76-83``; there
    the taps are weighted by 1/ksize before the sum, here the sum is divided
    by the tap count: a few ulp apart)."""
    n, c, h, w = img.shape
    k = _per_image(ksize, img).view(n, 1, 1).repeat_interleave(c, 0)
    return box_blur_planes(img.reshape(n * c, h, w), k, max_ksize).view(n, c, h, w)
