"""The v1 strong-augmentation pool of consistency training: each op's
parameter law, and the photometric ops applied to a group of images.

Counterpart of ``ssl_cr_histo_tpu/ops/randaugment.py:33-176`` (reference
``models/randaugment.py:51-144``).  JAX draws each op's parameters inside
the op from its key; here ``draw_v1_params`` draws them for every (image,
stage) pair at once from a torch generator, with the same laws, into an
(..., N_PARAMS) table whose slots each op reads as listed under ``V1_POOL``.
The geometric ops' matrices are built in ``ops/fused.py``.
"""

from __future__ import annotations

import torch

from ssl_cr_histo_tpu_torch.ops import photometric, stain

# The order is the op index (``randaugment.py:166-176``).  Param slots per
# op; slot GATE holds the op's p = 0.5 gate (1 for the ops without one):
#   0 hsv                 hue, sat, val shifts (albumentations units)
#   1 noise               sigma (the field itself is drawn separately)
#   2 scale_resize_crop   crop offsets oy, ox in 0..20
#   3 shift_scale_rotate  shift_x, shift_y, scale, degrees
#   4 color               HED shifts dh, de, dd
#   5 blur                ksize in {3, 5}
#   6 brightness          brightness, contrast
#   7 contrast            brightness, contrast
#   8 rotate_crop         degrees, flip kind (0 h, 1 v, 2 both), flip gate;
#                         slot GATE gates the rotation
V1_POOL = ("hsv", "noise", "scale_resize_crop", "shift_scale_rotate", "color", "blur", "brightness",
           "contrast", "rotate_crop")
NOISE = V1_POOL.index("noise")
GEOMETRIC = tuple(V1_POOL.index(k) for k in ("scale_resize_crop", "shift_scale_rotate", "rotate_crop"))
PHOTOMETRIC = tuple(i for i in range(len(V1_POOL)) if i not in GEOMETRIC)
N_PARAMS = 6
GATE = 5
# cv2.blur's blur_limit = int(val + 5) == 5 at every magnitude
V1_MAX_BLUR = 5


def mag_v1(v: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """v1 magnitude mapping ``(v / 30) * (max - min) + min``, float32
    (``randaugment.py:43-46``)."""
    return (v.to(torch.float32) / 30.0) * (maxval - minval) + minval


def draw_v1_params(gen: torch.Generator, ops: torch.Tensor, mags: torch.Tensor) -> torch.Tensor:
    """(..., N_PARAMS) float32 parameters for op indices ``ops`` at integer
    magnitudes ``mags`` (same shape), on ``gen``'s device: every op's law is
    drawn for every entry and each entry keeps its own op's
    (``randaugment.py:55-137``, ``fused.py:203-226``).  Uniforms are
    ``lo + (hi - lo) * U[0, 1)``, gates ``U < 0.5``."""
    shape, dev = ops.shape, gen.device
    rand = lambda: torch.rand(shape, generator=gen, device=dev)
    u = lambda lo, hi: lo + (hi - lo) * rand()
    coin = lambda: (rand() < 0.5).float()
    randint = lambda lo, hi: torch.randint(lo, hi, shape, generator=gen, device=dev).float()
    zero, one = torch.zeros(shape, device=dev), torch.ones(shape, device=dev)
    v = mags.to(dev)

    def hsv():
        val = mag_v1(v, -1.0, 1.0).abs()
        return [u(-val, val), u(-val, val), u(-val, val), zero, zero, coin()]

    def noise():
        return [u(0.0, mag_v1(v, 0.0, 0.15)), zero, zero, zero, zero, coin()]

    def scale_resize_crop():
        return [randint(0, 21), randint(0, 21), zero, zero, zero, one]

    def shift_scale_rotate():
        val = mag_v1(v, 0.01, 0.1)
        return [u(-val, val), u(-val, val), u(1.0 - (val + 0.5), 1.0 + (val + 0.5)), u(-90.0, 90.0),
                zero, coin()]

    def color():
        # ``_hed_color``: sigma ~ U(-0.035, 0.035), shift ~ N(0, 1) * sigma
        sigma = [u(-0.035, 0.035) for _ in range(3)]
        return [torch.randn(shape, generator=gen, device=dev) * s for s in sigma] + [zero, zero, one]

    def blur():
        return [3.0 + 2.0 * randint(0, 2), zero, zero, zero, zero, coin()]

    def brightness():
        val = mag_v1(v, -0.2, 0.2).abs()
        return [u(-val, val), u(-0.2, 0.2), zero, zero, zero, coin()]

    def contrast():
        val = mag_v1(v, -0.2, 0.2).abs()
        return [u(-0.2, 0.2), u(-val, val), zero, zero, zero, coin()]

    def rotate_crop():
        val = mag_v1(v, -90.0, 90.0).abs()
        return [u(-val, val), randint(0, 3), coin(), zero, zero, coin()]

    laws = (hsv, noise, scale_resize_crop, shift_scale_rotate, color, blur, brightness, contrast,
            rotate_crop)
    out = torch.zeros(*shape, N_PARAMS, device=dev)
    ops = ops.to(dev)
    for i, law in enumerate(laws):
        out = torch.where((ops == i).unsqueeze(-1), torch.stack(law(), -1), out)
    return out


def apply_photometric(op: int, imgs: torch.Tensor, p: torch.Tensor,
                      noise: "torch.Tensor | None" = None) -> torch.Tensor:
    """Photometric op ``op`` of the pool on (k, 3, H, W) images with their
    (k, N_PARAMS) params, gate on (``randaugment.py:55-137`` without the
    ``_maybe``); ``noise`` (k, 3, H, W) standard normal for the noise op."""
    name = V1_POOL[op]
    if name == "hsv":
        return photometric.hsv_shift(imgs, p[:, 0], p[:, 1], p[:, 2])
    if name == "noise":
        return photometric.gaussian_noise(imgs, noise, p[:, 0])
    if name == "color":
        return stain.hed_shift(imgs, p[:, 0], p[:, 1], p[:, 2])
    if name == "blur":
        return photometric.box_blur(imgs, p[:, 0], max_ksize=V1_MAX_BLUR)
    if name in ("brightness", "contrast"):
        return photometric.brightness_contrast(imgs, p[:, 0], p[:, 1])
    raise ValueError(f"op {op} ({name}) is not photometric")
