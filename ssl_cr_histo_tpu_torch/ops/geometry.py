"""Affine matrix builders and the two-pass separable warp, batched.

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

import torch

# Coordinate swap x <-> y (``geometry.py:270``).
_SWAP_XY = ((0.0, 1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _mat(rows, like: torch.Tensor) -> torch.Tensor:
    """Stack a 3x3 nested list of scalars / same-shaped tensors into
    (..., 3, 3)."""
    shape, device = like.shape, like.device
    full = lambda v: v if torch.is_tensor(v) else torch.full(shape, float(v), dtype=torch.float32, device=device)
    return torch.stack([torch.stack([full(v) for v in row], -1) for row in rows], -2)


def _about_center(lin: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Conjugate a linear map so that it acts about the image center."""
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    to_origin = _f32([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], lin.device)
    back = _f32([[1, 0, cx], [0, 1, cy], [0, 0, 1]], lin.device)
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
    m = sel(rot_dominant, _f32(_rot90_matrix(size, size), dev) @ m, m)

    # Fix-up 2: transpose so that the horizontal-first pass is well
    # conditioned.
    swap = m[:, 0, 0].abs() > m[:, 1, 1].abs()
    sw = _f32(_SWAP_XY, dev)
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
