"""Affine matrix builders, the gather warp of the op-by-op policies and the
two-pass separable warp, batched; the cv2-exact bilinear resize and the
crops of the fine-tune 3-view stack; the lattice flips and rotations.

Counterpart of ``ssl_cr_histo_tpu/ops/geometry.py``.  Every geometric op is
a 3x3 *inverse* map (output pixel -> input location, (x, y) coordinates, y
down), so a chain of ops composes into one matrix and one warp.  The
builders take tensors of any leading shape and return (..., 3, 3) float32.

The warp keeps the JAX package's two-pass (Catmull-Smith) decomposition and
its lattice fix-ups, so both packages sample the same positions.  Where the
JAX package multiplies by a dense hat-weight tensor (a TPU matrix-unit
formulation, ``geometry.py:391-417``), the port gathers: the hat weight
``max(0, 1 - |i - pos|)`` is nonzero on at most the two taps
``floor(pos)`` and ``floor(pos) + 1``, so each pass is two reads per output
pixel and channel.  A tap outside ``[0, size - 1]`` gets weight 0 (it is
masked, not clamped), exactly as the dense weights' index range does.
"""

from __future__ import annotations

import numpy as np
import torch

# Coordinate swap x <-> y (``geometry.py:270``).
_SWAP_XY = ((0.0, 1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


_CONSTANTS: dict = {}


def device_constant(values, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``torch.as_tensor(values, dtype, device)``, made once a device off
    the CPU and kept: a captured CUDA graph (``parallel.steps.StepGraph``)
    may read it, but cannot copy it from the host while it is captured.
    The caller must not write to it."""
    if torch.device(device).type == "cpu":
        return torch.as_tensor(values, dtype=dtype, device=device)
    arr = np.asarray(values)
    key = (arr.tobytes(), arr.shape, arr.dtype.str, dtype, str(device))
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.as_tensor(arr, dtype=dtype, device=device)
    return _CONSTANTS[key]


def _mat(rows, like: torch.Tensor) -> torch.Tensor:
    """Stack a 3x3 nested list of scalars / same-shaped tensors into
    (..., 3, 3)."""
    shape, device = like.shape, like.device
    full = lambda v: v if torch.is_tensor(v) else torch.full(shape, float(v), dtype=torch.float32, device=device)
    return torch.stack([torch.stack([full(v) for v in row], -1) for row in rows], -2)


def _about_center(lin: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Conjugate a linear map so that it acts about the image center."""
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    to_origin = device_constant([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], lin.device)
    back = device_constant([[1, 0, cx], [0, 1, cy], [0, 0, 1]], lin.device)
    return back @ lin @ to_origin


def rotation_matrix(degrees, h: int, w: int) -> torch.Tensor:
    """Inverse map of a counter-clockwise rotation about the image center
    (``geometry.py:42-50``)."""
    theta = torch.deg2rad(_f32(degrees))
    c, s = torch.cos(theta), torch.sin(theta)
    return _about_center(_mat([[c, -s, 0], [s, c, 0], [0, 0, 1]], theta), h, w)


def scale_matrix(scale, h: int, w: int) -> torch.Tensor:
    """Inverse map of a zoom by ``scale`` about the center (``:53-59``)."""
    inv = 1.0 / _f32(scale)
    return _about_center(_mat([[inv, 0, 0], [0, inv, 0], [0, 0, 1]], inv), h, w)


def translation_matrix(tx, ty) -> torch.Tensor:
    """Output (x, y) samples input (x + tx, y + ty) (``:62-67``)."""
    tx, ty = _f32(tx), _f32(ty)
    return _mat([[1, 0, tx], [0, 1, ty], [0, 0, 1]], tx)


def shear_x_matrix(level) -> torch.Tensor:
    """PIL ``transform(AFFINE, (1, level, 0, 0, 1, 0))``: input x = output
    x + level * output y (``geometry.py:70-75``)."""
    level = _f32(level)
    return _mat([[1, level, 0], [0, 1, 0], [0, 0, 1]], level)


def shear_y_matrix(level) -> torch.Tensor:
    """Input y = output y + level * output x (``geometry.py:78-80``)."""
    level = _f32(level)
    return _mat([[1, 0, 0], [level, 1, 0], [0, 0, 1]], level)


def compose(*mats: torch.Tensor) -> torch.Tensor:
    """``warp(compose(A, B)) == warp B then warp A`` (``:82-91``)."""
    out = mats[0]
    for m in mats[1:]:
        out = m @ out
    return out


def shift_scale_rotate_matrix(shift_x, shift_y, scale, degrees, h: int, w: int) -> torch.Tensor:
    """albumentations ShiftScaleRotate geometry (``:94-101``)."""
    rot = rotation_matrix(degrees, h, w)
    sc = scale_matrix(scale, h, w)
    tr = translation_matrix(-_f32(shift_x) * w, -_f32(shift_y) * h)
    return compose(tr, sc, rot)


def _reflect101(coord: torch.Tensor, size: int) -> torch.Tensor:
    """OpenCV BORDER_REFLECT_101 folding of integer coordinates
    (``geometry.py:109-115``)."""
    if size == 1:
        return torch.zeros_like(coord)
    period = 2 * (size - 1)
    coord = coord.abs() % period
    return torch.where(coord >= size, period - coord, coord)


def _gather_pixels(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor, pad_mode: str) -> torch.Tensor:
    """``img[n, :, yi, xi]`` of (N, C, H, W) ``img`` for (N, OH, OW) integer
    indices: folded for reflect101, clamped otherwise (constant padding
    masks afterwards) (``geometry.py:118-131``)."""
    n, c, h, w = img.shape
    if pad_mode == "reflect101":
        yi, xi = _reflect101(yi, h), _reflect101(xi, w)
    else:
        yi, xi = yi.clamp(0, h - 1), xi.clamp(0, w - 1)
    idx = (yi * w + xi).reshape(n, 1, -1).expand(n, c, -1)
    return torch.gather(img.reshape(n, c, h * w), 2, idx).view(n, c, *yi.shape[1:])


def warp_affine(imgs: torch.Tensor, inv_mats: torch.Tensor, interp: str = "bilinear", pad_mode: str = "constant",
                fill: float = 0.0) -> torch.Tensor:
    """Direct (one-pass) gather warp of (N, C, H, W) images through (N, 3, 3)
    inverse maps, ``[xi, yi, 1] = M @ [xo, yo, 1]``, to the input's shape
    (``geometry.py:134-208``):
    ``interp`` 'nearest' (round half to even, as ``jnp.round``) or
    'bilinear' (four taps); ``pad_mode`` 'constant' (``fill`` wherever the
    continuous sample position falls outside the image), 'reflect101' or
    'edge'.  The op-by-op v2 pool's PIL ops use it; the composed policies
    use ``warp_affine_planar``."""
    if pad_mode not in ("constant", "reflect101", "edge"):
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    n, c, h, w = imgs.shape
    img = imgs.float()
    m = inv_mats.float().reshape(n, 3, 3)
    xo = torch.arange(w, dtype=torch.float32, device=img.device).view(1, 1, w)
    yo = torch.arange(h, dtype=torch.float32, device=img.device).view(1, h, 1)
    coef = lambda i, j: m[:, i, j].view(n, 1, 1)
    xi = coef(0, 0) * xo + coef(0, 1) * yo + coef(0, 2)
    yi = coef(1, 0) * xo + coef(1, 1) * yo + coef(1, 2)
    if interp == "nearest":
        out = _gather_pixels(img, torch.round(yi).long(), torch.round(xi).long(), pad_mode)
    elif interp == "bilinear":
        x0, y0 = torch.floor(xi), torch.floor(yi)
        fx, fy = (xi - x0).unsqueeze(1), (yi - y0).unsqueeze(1)
        x0i, y0i = x0.long(), y0.long()
        p00 = _gather_pixels(img, y0i, x0i, pad_mode)
        p01 = _gather_pixels(img, y0i, x0i + 1, pad_mode)
        p10 = _gather_pixels(img, y0i + 1, x0i, pad_mode)
        p11 = _gather_pixels(img, y0i + 1, x0i + 1, pad_mode)
        out = p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy) + p10 * (1 - fx) * fy + p11 * fx * fy
    else:
        raise ValueError(f"unknown interp {interp!r}")
    if pad_mode == "constant":
        inside = ((xi >= 0.0) & (xi <= w - 1.0) & (yi >= 0.0) & (yi <= h - 1.0)).unsqueeze(1)
        out = torch.where(inside, out, torch.full_like(out, fill))
    return out


def _fold_coords(pos: torch.Tensor, size: int, pad_mode: str) -> torch.Tensor:
    """Fold continuous sample positions for the padding mode
    (``geometry.py:211-223``, including its 1e-6 edge).  Constant padding
    leaves positions as they are: out-of-range taps get weight 0."""
    if pad_mode == "reflect101":
        if size == 1:
            return torch.zeros_like(pos)
        period = 2.0 * (size - 1)
        pos = torch.fmod(torch.abs(pos), period)  # both operands >= 0
        return torch.where(pos >= size - 1 + 1e-6, period - pos, pos)
    if pad_mode == "constant":
        return pos
    raise ValueError(f"unknown pad_mode {pad_mode!r}")


def _rot90_matrix(h: int, w: int) -> tuple:
    """Lattice map of ``rot90(img, 1)`` (CCW): original (x, y) lives at
    rotated (y, w-1-x) (``geometry.py:273-278``)."""
    return ((0.0, 1.0, 0.0), (-1.0, 0.0, w - 1.0), (0.0, 0.0, 1.0))


def _resample_pass(img: torch.Tensor, pos: torch.Tensor, dim: int, pad_mode: str) -> torch.Tensor:
    """One 1-D linear resampling pass of (N, C, H, W) ``img`` along ``dim``
    (3 = x, 2 = y).  ``pos`` has the output's spatial shape (N, H_out, W_out)
    and holds the input coordinate along ``dim`` of each output pixel."""
    size = img.shape[dim]
    pos = _fold_coords(pos, size, pad_mode)
    i0 = torch.floor(pos)
    out = None
    for tap in (i0, i0 + 1.0):
        # the dense formulation's weight, computed the same way
        wgt = torch.clamp_min(1.0 - torch.abs(tap - pos), 0.0)
        inside = (tap >= 0) & (tap <= size - 1)
        wgt = torch.where(inside, wgt, torch.zeros_like(wgt))
        idx = tap.clamp(0, size - 1).long().unsqueeze(1).expand(-1, img.shape[1], -1, -1)
        term = torch.gather(img, dim, idx) * wgt.unsqueeze(1)
        out = term if out is None else out + term
    return out


def warp_pass_coefficients(inv_mats: torch.Tensor, size: int) -> torch.Tensor:
    """The two-pass warp's per-tile plan for (N, 3, 3) inverse maps of
    size x size tiles (``geometry.py:358-378``): (N, 8) float32 rows
    ``[ap, bp, cp, d, e, f, rot_dominant, swap]``.

    Pass 1 samples ``tmp[y, o] = img'[y, ap*o + bp*y + cp]``, pass 2
    ``out'[o, x] = tmp[d*x + e*o + f, x]``, where ``img'`` is the tile after
    the lattice fix-ups (rotated by 90 degrees where ``rot_dominant``, then
    transposed where ``swap``) and ``out = out'.T`` where ``swap``.
    ``warp_affine_planar`` reads this table; the fused augmentation kernel
    (``csrc/rsp_augment.cu::make_plan``) computes the same rows operation for
    operation, so both sample at bit-identical positions."""
    dev = inv_mats.device
    m = inv_mats.float()
    sel = lambda mask, a, b: torch.where(mask.view(-1, 1, 1), a, b)

    # Fix-up 1: pre-rotate the lattice by 90 degrees where the map is
    # dominated by its off-diagonal terms.
    rot_dominant = m[:, 0, 0].abs() + m[:, 1, 1].abs() < m[:, 0, 1].abs() + m[:, 1, 0].abs()
    m = sel(rot_dominant, device_constant(_rot90_matrix(size, size), dev) @ m, m)

    # Fix-up 2: transpose so that the horizontal-first pass is well
    # conditioned.
    swap = m[:, 0, 0].abs() > m[:, 1, 1].abs()
    sw = device_constant(_SWAP_XY, dev)
    m = sel(swap, sw @ m @ sw, m)

    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    e_safe = torch.where(e.abs() < 1e-6, torch.where(e < 0, -1e-6, 1e-6), e)
    ap = a - b * d / e_safe
    bp = b / e_safe
    cp = c - b * f / e_safe
    return torch.stack([ap, bp, cp, d, e, f, rot_dominant.float(), swap.float()], 1)


def warp_affine_planar(imgs: torch.Tensor, inv_mats: torch.Tensor, pad_mode: str = "constant") -> torch.Tensor:
    """Affine warp of square channel-planar tiles, one matrix per tile.

    imgs: (N, C, S, S) float; inv_mats: (N, 3, 3) inverse maps.  Port of
    ``warp_affine_mxu_planar`` (``geometry.py:339-388``): the same lattice
    fix-ups as per-tile selects, then a horizontal and a vertical pass.
    """
    n, c, h, w = imgs.shape
    if h != w:
        raise ValueError("warp_affine_planar requires square images")
    dev = imgs.device
    img = imgs.float()
    coef = warp_pass_coefficients(inv_mats, h)
    sel = lambda mask, a, b: torch.where(mask.view(-1, 1, 1, 1), a, b)
    swap = coef[:, 7] > 0.5
    img = sel(coef[:, 6] > 0.5, torch.rot90(img, 1, dims=(2, 3)), img)
    img = sel(swap, img.transpose(2, 3), img)

    ap, bp, cp, d, e, f = (coef[:, j].view(n, 1, 1) for j in range(6))
    ys = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    xs = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    tmp = _resample_pass(img, ap * xs + bp * ys + cp, 3, pad_mode)
    out = _resample_pass(tmp, d * xs + e * ys + f, 2, pad_mode)
    return sel(swap, out.transpose(2, 3), out).contiguous()


def flip_horizontal(imgs: torch.Tensor) -> torch.Tensor:
    """Mirror the trailing W axis (``geometry.py:425-426``)."""
    return imgs.flip(-1)


def flip_vertical(imgs: torch.Tensor) -> torch.Tensor:
    """Mirror the H axis (``geometry.py:429-430``)."""
    return imgs.flip(-2)


def rot90(imgs: torch.Tensor, k) -> torch.Tensor:
    """Rotate the trailing (H, W) dims by k * 90 degrees counter-clockwise
    (``geometry.py:433-443``); ``k`` an int, or an (N,) tensor of one k per
    image of square (N, C, S, S) images."""
    if not torch.is_tensor(k):
        return torch.rot90(imgs, int(k) % 4, dims=(-2, -1))
    k = (k.to(imgs.device).long() % 4).view(-1, *([1] * (imgs.ndim - 1)))
    out = imgs
    for j in range(1, 4):
        out = torch.where(k == j, torch.rot90(imgs, j, dims=(-2, -1)), out)
    return out


def center_crop(imgs: torch.Tensor, crop_h: int, crop_w: int) -> torch.Tensor:
    """Central crop of the trailing (H, W) dims (``geometry.py:446-452``)."""
    h, w = imgs.shape[-2:]
    y0, x0 = (h - crop_h) // 2, (w - crop_w) // 2
    return imgs[..., y0:y0 + crop_h, x0:x0 + crop_w]


def random_crop(imgs: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, crop_h: int,
                crop_w: int) -> torch.Tensor:
    """Crop each (C, H, W) image of (N, C, H, W) ``imgs`` at its own offset:
    rows ``y0[i]:y0[i] + crop_h``, columns ``x0[i]:x0[i] + crop_w``
    (``geometry.py:455-461``, with the offsets drawn by the caller)."""
    n, c = imgs.shape[:2]
    dev = imgs.device
    rows = (y0.view(n, 1).long() + torch.arange(crop_h, device=dev)).view(n, 1, crop_h, 1)
    out = torch.gather(imgs, 2, rows.expand(n, c, crop_h, imgs.shape[3]))
    cols = (x0.view(n, 1).long() + torch.arange(crop_w, device=dev)).view(n, 1, 1, crop_w)
    return torch.gather(out, 3, cols.expand(n, c, crop_h, crop_w))


def _cv2_linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) cv2.INTER_LINEAR weights: half-pixel mapping
    src = (dst + 0.5) * n_in / n_out - 0.5, two taps, edge clamp; positions
    in float64, weights cast to float32 (``geometry.py:464-475``)."""
    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(src).astype(int)
    frac = (src - i0).astype(np.float32)
    w = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(w, (rows, np.clip(i0, 0, n_in - 1)), 1.0 - frac)
    np.add.at(w, (rows, np.clip(i0 + 1, 0, n_in - 1)), frac)
    return w


def resize(imgs: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of the trailing (H, W) dims, cv2.INTER_LINEAR-exact
    (``geometry.py:478-497``, bilinear only): two products with the 2-tap
    weight matrices.  Channel-planar, float32 out."""
    x = imgs.float()
    h, w = x.shape[-2:]
    if out_h != h:
        wy = device_constant(_cv2_linear_weights(h, out_h), x.device)
        x = torch.einsum("oh,...hw->...ow", wy, x)
    if out_w != w:
        wx = device_constant(_cv2_linear_weights(w, out_w), x.device)
        x = torch.einsum("ow,...hw->...ho", wx, x)
    return x
