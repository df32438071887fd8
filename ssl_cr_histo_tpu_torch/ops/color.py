"""Colour-space conversions on channel-planar tensors.

Counterpart of ``ssl_cr_histo_tpu/ops/color.py:23-101``: the legacy
scikit-image HED transform (``rgb + 2`` offset, natural log, and the final
``clip((rgb - 1) / 2, 0, 1)`` rescale) and RGB <-> HSV with all channels in
[0, 1], the same float32 constants and the same formulas.  The JAX functions
take (..., 3) channels-last arrays; these take (..., 3, H, W).  The
``*_planes`` forms work on the three colour planes as separate tensors; the
photometric chain's plain version (``ops/photometric_kernel.py``) uses them
too.
"""

from __future__ import annotations

import numpy as np
import torch

# Ruifrok & Johnston stain vectors (rows: H, E, DAB).
RGB_FROM_HED = np.array(
    [
        [0.65, 0.70, 0.29],
        [0.07, 0.99, 0.11],
        [0.27, 0.57, 0.78],
    ],
    dtype=np.float32,
)
HED_FROM_RGB = np.linalg.inv(RGB_FROM_HED).astype(np.float32)


def _mat3(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """``x @ m`` over the channel axis (-3) of a planar tensor."""
    return torch.einsum("...ihw,ij->...jhw", x, torch.from_numpy(m).to(x.device))


def rgb2hed(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0, 1] -> HED optical density: ``-log(rgb + 2) @ HED_FROM_RGB``
    (``color.py:34-40``)."""
    return _mat3(-torch.log(rgb.float() + 2.0), HED_FROM_RGB)


def hed2rgb(hed: torch.Tensor) -> torch.Tensor:
    """HED -> RGB in [0, 1]: ``clip((exp(-hed @ RGB_FROM_HED) - 2 + 1) / 2)``
    (``color.py:43-52``).  ``hed2rgb(rgb2hed(x))`` is ``(x + 1) / 2``, the
    reference's legacy-skimage behaviour."""
    rgb2 = torch.exp(-_mat3(hed.float(), RGB_FROM_HED))
    return torch.clamp((rgb2 - 2.0 + 1.0) / 2.0, 0.0, 1.0)


def rgb2hsv_planes(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """(h, s, v) planes of (r, g, b) planes (``color.py:55-73``): hue 0 on
    gray pixels, the red sector first on ties of the channel maxima."""
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    delta = v - mn
    safe = torch.where(delta == 0.0, 1.0, delta)
    h_r = torch.remainder((g - b) / safe, 6.0)
    h_g = (b - r) / safe + 2.0
    h_b = (r - g) / safe + 4.0
    h = torch.where(v == r, h_r, torch.where(v == g, h_g, h_b))
    h = torch.where(delta == 0.0, 0.0, h / 6.0)
    s = torch.where(v == 0.0, 0.0, delta / torch.where(v == 0.0, 1.0, v))
    return h, s, v


def hsv2rgb_planes(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor):
    """(r, g, b) planes of (h, s, v) planes, hue wrapped mod 1
    (``color.py:76-101``)."""
    h6 = torch.remainder(h, 1.0) * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    sector = [i == k for k in range(5)]

    def pick(*cs):
        out = cs[5]
        for k in range(4, -1, -1):
            out = torch.where(sector[k], cs[k], out)
        return out

    return pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)


def rgb2hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) RGB -> HSV, every channel in [0, 1]."""
    rgb = rgb.float()
    return torch.stack(rgb2hsv_planes(rgb[..., 0, :, :], rgb[..., 1, :, :], rgb[..., 2, :, :]), -3)


def hsv2rgb(hsv: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) HSV -> RGB."""
    hsv = hsv.float()
    return torch.stack(hsv2rgb_planes(hsv[..., 0, :, :], hsv[..., 1, :, :], hsv[..., 2, :, :]), -3)
