"""Photometric ops of the v1 pools and the v2 pool on channel-planar
(N, 3, H, W) float32 images in [0, 1], with one parameter per image.

Counterpart of ``ssl_cr_histo_tpu/ops/photometric.py:27-187``: the
albumentations-style ops of the v1 pools and the PIL ops of the v2 pool,
with the same formulas; each op clips where the JAX op clips.  Per-image
parameters are (N,) tensors (or Python floats), broadcast over channels and
pixels.  PIL's integer algorithms (its gray level, the contrast mean,
``equalize``) are computed in integers and equal the JAX package's exactly.
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


# ---------------------------------------------------------------------------
# PIL ImageEnhance / ImageOps ops of the v2 pool (``photometric.py:91-187``)
# ---------------------------------------------------------------------------


def pil_brightness(img: torch.Tensor, factor) -> torch.Tensor:
    """``ImageEnhance.Brightness``: ``clip(img * factor)``."""
    return torch.clamp(img * _per_image(factor, img), 0.0, 1.0)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal, an ulp away at times,
    so the divisor is a tensor on ``x``'s device (the quantized ops must
    equal the JAX package's, and the card the CPU, exactly)."""
    return x / torch.full_like(x, d)


def _pil_gray255(img: torch.Tensor) -> torch.Tensor:
    """PIL ``convert("L")`` on the uint8 grid, (N, H, W) float32 gray levels:
    the fixed-point ``(R*19595 + G*38470 + B*7471 + 0x8000) >> 16`` on
    ``round(x * 255)`` (half to even), in integers (``photometric.py:
    95-108``)."""
    q = torch.round(img * 255.0).to(torch.int64)
    return ((q[:, 0] * 19595 + q[:, 1] * 38470 + q[:, 2] * 7471 + 0x8000) >> 16).to(torch.float32)


def pil_contrast(img: torch.Tensor, factor) -> torch.Tensor:
    """``ImageEnhance.Contrast``: blend toward the image's mean gray level,
    rounded half up to an integer as PIL does (``photometric.py:111-115``).
    The gray levels' sum is an integer below 2^24, exact in float32."""
    h, w = img.shape[-2:]
    mean = _div(_pil_gray255(img).sum((-2, -1)), float(h * w))
    mean = _div(torch.floor(mean + 0.5), 255.0).view(-1, 1, 1, 1)
    return torch.clamp(mean + _per_image(factor, img) * (img - mean), 0.0, 1.0)


def pil_color(img: torch.Tensor, factor) -> torch.Tensor:
    """``ImageEnhance.Color``: blend toward each pixel's gray level
    (``photometric.py:118-121``)."""
    gray = _div(_pil_gray255(img), 255.0).unsqueeze(1)
    return torch.clamp(gray + _per_image(factor, img) * (img - gray), 0.0, 1.0)


def pil_sharpness(img: torch.Tensor, factor) -> torch.Tensor:
    """``ImageEnhance.Sharpness``: blend away from the SMOOTH-filtered copy
    ([[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13, the 3x3 box sum plus four
    times the centre); the 1-pixel border stays unfiltered, as in PIL
    (``photometric.py:124-136``)."""
    rows = img[..., :-2, :] + img[..., 1:-1, :] + img[..., 2:, :]
    box = rows[..., :-2] + rows[..., 1:-1] + rows[..., 2:]
    inner = img[..., 1:-1, 1:-1]
    smooth = (box + 4.0 * inner) / 13.0
    out = img.clone()
    out[..., 1:-1, 1:-1] = torch.clamp(smooth + _per_image(factor, img) * (inner - smooth), 0.0, 1.0)
    return out


def autocontrast(img: torch.Tensor) -> torch.Tensor:
    """``ImageOps.autocontrast`` with cutoff 0: each channel of each image
    stretched from its [min, max] to [0, 1] (``photometric.py:139-146``)."""
    lo = img.amin((-2, -1), keepdim=True)
    hi = img.amax((-2, -1), keepdim=True)
    spread = hi > lo
    scale = torch.where(spread, 1.0 / torch.where(spread, hi - lo, torch.ones_like(hi)), torch.zeros_like(hi))
    return torch.clamp(torch.where(spread, (img - lo) * scale, img), 0.0, 1.0)


def equalize(img: torch.Tensor) -> torch.Tensor:
    """``ImageOps.equalize``, PIL's integer LUT per channel of each image
    (``photometric.py:149-187``): on ``q = round(x * 255)``, a 256-bin
    histogram, ``step = (pixels - count of the last nonzero bin) // 255``,
    ``lut[i] = (step // 2 + sum of the bins below i) // step``; the
    identity where ``step`` is 0 or one bin alone is nonzero.  A histogram
    per (image, channel) by ``scatter_add_``, an exclusive cumulative sum,
    a gather through the LUT.  Levels outside 0..255 (inputs outside
    [0, 1]) are not counted and map to the LUT's end, as in JAX."""
    n, c, h, w = img.shape
    q = torch.round(img * 255.0).to(torch.int64).reshape(n * c, h * w)
    bins = q.clamp(0, 255)
    hist = torch.zeros(n * c, 256, dtype=torch.int64, device=img.device)
    hist.scatter_add_(1, bins, ((q >= 0) & (q <= 255)).to(torch.int64))
    nonzero = hist > 0
    last = 255 - nonzero.flip(1).to(torch.int64).argmax(1, keepdim=True)
    step = (h * w - hist.gather(1, last)) // 255
    levels = torch.arange(256, device=img.device).expand(n * c, 256)
    lut = ((step // 2 + torch.cumsum(hist, 1) - hist) // step.clamp_min(1)).clamp(0, 255)
    identity = (step == 0) | (nonzero.sum(1, keepdim=True) <= 1)
    lut = torch.where(identity, levels, lut)
    return _div(lut.gather(1, bins).to(torch.float32), 255.0).view(n, c, h, w)
