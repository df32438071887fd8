"""Frozen plain-PyTorch copy of the augmentations the benchmark's cells run.

The reference works the program's views out again from the inputs the
benchmark made, so it needs the draws and the arithmetic of the v1
pretraining pool (the fused kernel's plain form: ordering, composed warp,
Philox noise, photometric chain, clip) and of the fine-tune 3-view stack.
These are copies, taken once, of the port's plain versions
(``ssl_cr_histo_tpu_torch/ops/{fused,geometry,photometric,photometric_kernel,
color,batch}.py``): the reference imports nothing of the program, and a later
change to the program's augmentation does not change this yardstick.

Every function takes and returns float32 tensors on any device; random
draws come from a ``torch.Generator`` in the order the program draws them,
so a generator seeded alike gives the same draws.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Colour (Ruifrok & Johnston stain vectors; legacy scikit-image HED)
# ---------------------------------------------------------------------------

RGB_FROM_HED = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11], [0.27, 0.57, 0.78]], dtype=np.float32)
HED_FROM_RGB = np.linalg.inv(RGB_FROM_HED).astype(np.float32)
_RGB_FROM_HED = tuple(tuple(float(v) for v in row) for row in RGB_FROM_HED)
_HED_FROM_RGB = tuple(tuple(float(v) for v in row) for row in HED_FROM_RGB)

# The six resolution-sequence orderings ([HR, LR1, LR2] slots)
RSP_PERMUTATIONS = np.array([[0, 1, 2], [0, 2, 1], [1, 2, 0], [1, 0, 2], [2, 0, 1], [2, 1, 0]], dtype=np.int64)
N_PARAMS = 16


def rgb2hsv_planes(r, g, b):
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


def hsv2rgb_planes(h, s, v):
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


# ---------------------------------------------------------------------------
# Geometry: 3x3 inverse maps (output pixel -> input location, (x, y))
# ---------------------------------------------------------------------------

_SWAP_XY = ((0.0, 1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def _const(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values), dtype=torch.float32, device=device)


def _mat(rows, like: torch.Tensor) -> torch.Tensor:
    full = lambda v: v if torch.is_tensor(v) else torch.full(like.shape, float(v), dtype=torch.float32,
                                                             device=like.device)
    return torch.stack([torch.stack([full(v) for v in row], -1) for row in rows], -2)


def _about_center(lin: torch.Tensor, h: int, w: int) -> torch.Tensor:
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    to_origin = _const([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], lin.device)
    back = _const([[1, 0, cx], [0, 1, cy], [0, 0, 1]], lin.device)
    return back @ lin @ to_origin


def rotation_matrix(degrees: torch.Tensor, h: int, w: int) -> torch.Tensor:
    theta = torch.deg2rad(degrees.float())
    c, s = torch.cos(theta), torch.sin(theta)
    return _about_center(_mat([[c, -s, 0], [s, c, 0], [0, 0, 1]], theta), h, w)


def scale_matrix(scale: torch.Tensor, h: int, w: int) -> torch.Tensor:
    inv = 1.0 / scale.float()
    return _about_center(_mat([[inv, 0, 0], [0, inv, 0], [0, 0, 1]], inv), h, w)


def translation_matrix(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    return _mat([[1, 0, tx.float()], [0, 1, ty.float()], [0, 0, 1]], tx)


def shift_scale_rotate_matrix(shift_x, shift_y, scale, degrees, h: int, w: int) -> torch.Tensor:
    rot = rotation_matrix(degrees, h, w)
    sc = scale_matrix(scale, h, w)
    tr = translation_matrix(-shift_x.float() * w, -shift_y.float() * h)
    return rot @ (sc @ tr)


def _fold_coords(pos: torch.Tensor, size: int, pad_mode: str) -> torch.Tensor:
    if pad_mode == "reflect101":
        if size == 1:
            return torch.zeros_like(pos)
        period = 2.0 * (size - 1)
        pos = torch.fmod(torch.abs(pos), period)
        return torch.where(pos >= size - 1 + 1e-6, period - pos, pos)
    return pos


def _resample_pass(img: torch.Tensor, pos: torch.Tensor, dim: int, pad_mode: str) -> torch.Tensor:
    size = img.shape[dim]
    pos = _fold_coords(pos, size, pad_mode)
    i0 = torch.floor(pos)
    out = None
    for tap in (i0, i0 + 1.0):
        wgt = torch.clamp_min(1.0 - torch.abs(tap - pos), 0.0)
        inside = (tap >= 0) & (tap <= size - 1)
        wgt = torch.where(inside, wgt, torch.zeros_like(wgt))
        idx = tap.clamp(0, size - 1).long().unsqueeze(1).expand(-1, img.shape[1], -1, -1)
        term = torch.gather(img, dim, idx) * wgt.unsqueeze(1)
        out = term if out is None else out + term
    return out


def warp_pass_coefficients(inv_mats: torch.Tensor, size: int) -> torch.Tensor:
    """The two-pass warp's per-tile plan: (N, 8) rows [ap, bp, cp, d, e, f,
    rot_dominant, swap]."""
    dev = inv_mats.device
    m = inv_mats.float()
    sel = lambda mask, a, b: torch.where(mask.view(-1, 1, 1), a, b)
    rot_dominant = m[:, 0, 0].abs() + m[:, 1, 1].abs() < m[:, 0, 1].abs() + m[:, 1, 0].abs()
    rot90 = ((0.0, 1.0, 0.0), (-1.0, 0.0, size - 1.0), (0.0, 0.0, 1.0))
    m = sel(rot_dominant, _const(rot90, dev) @ m, m)
    swap = m[:, 0, 0].abs() > m[:, 1, 1].abs()
    sw = _const(_SWAP_XY, dev)
    m = sel(swap, sw @ m @ sw, m)
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    e_safe = torch.where(e.abs() < 1e-6, torch.where(e < 0, -1e-6, 1e-6), e)
    ap = a - b * d / e_safe
    bp = b / e_safe
    cp = c - b * f / e_safe
    return torch.stack([ap, bp, cp, d, e, f, rot_dominant.float(), swap.float()], 1)


def warp_affine_planar(imgs: torch.Tensor, inv_mats: torch.Tensor, pad_mode: str = "constant") -> torch.Tensor:
    """Two-pass affine warp of square (N, C, S, S) tiles, one map a tile."""
    n, c, h, w = imgs.shape
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


def _cv2_linear_weights(n_in: int, n_out: int) -> np.ndarray:
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
    """cv2.INTER_LINEAR-exact bilinear resize of the trailing (H, W) dims."""
    x = imgs.float()
    h, w = x.shape[-2:]
    if out_h != h:
        x = torch.einsum("oh,...hw->...ow", _const(_cv2_linear_weights(h, out_h), x.device), x)
    if out_w != w:
        x = torch.einsum("ow,...hw->...ho", _const(_cv2_linear_weights(w, out_w), x.device), x)
    return x


def random_crop(imgs: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, crop_h: int, crop_w: int) -> torch.Tensor:
    n, c = imgs.shape[:2]
    dev = imgs.device
    rows = (y0.view(n, 1).long() + torch.arange(crop_h, device=dev)).view(n, 1, crop_h, 1)
    out = torch.gather(imgs, 2, rows.expand(n, c, crop_h, imgs.shape[3]))
    cols = (x0.view(n, 1).long() + torch.arange(crop_w, device=dev)).view(n, 1, 1, crop_w)
    return torch.gather(out, 3, cols.expand(n, c, crop_h, crop_w))


# ---------------------------------------------------------------------------
# The v1 pretraining pool: draws, Philox noise, the photometric chain
# ---------------------------------------------------------------------------


def _uniform(gen, n: int, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=gen.device)


def _identity(n: int, device) -> torch.Tensor:
    return torch.eye(3, dtype=torch.float32, device=device).expand(n, 3, 3)


def _maybe_mat(gen, mats: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    coin = torch.rand(mats.shape[0], generator=gen, device=gen.device) < p
    return torch.where(coin.view(-1, 1, 1), mats, _identity(mats.shape[0], mats.device))


def resize_crop_matrix(oy: torch.Tensor, ox: torch.Tensor, s: int, pad: int = 20) -> torch.Tensor:
    oy, ox = oy.float(), ox.float()
    scale = s / (s + pad)
    zero, one = torch.zeros_like(oy), torch.ones_like(oy)
    sc = torch.full_like(oy, scale)
    return torch.stack([
        torch.stack([sc, zero, (ox + 0.5) * scale - 0.5], -1),
        torch.stack([zero, sc, (oy + 0.5) * scale - 0.5], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)


def draw_pretrain_geo_matrices(gen, n: int, s: int) -> torch.Tensor:
    """(n, 3, 3) composed inverse maps of the pool's three geometric ops in
    a random order a tile."""
    dev = gen.device
    rot_a = _maybe_mat(gen, rotation_matrix(_uniform(gen, n, -90.0, 90.0), s, s))
    oy = torch.randint(0, 21, (n,), generator=gen, device=dev)
    ox = torch.randint(0, 21, (n,), generator=gen, device=dev)
    mat_a = rot_a @ resize_crop_matrix(oy, ox, s)
    hflip = _const([[-1.0, 0.0, s - 1.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dev).expand(n, 3, 3)
    flip_b = _maybe_mat(gen, hflip)
    ssr = shift_scale_rotate_matrix(_uniform(gen, n, -0.0625, 0.0625), _uniform(gen, n, -0.0625, 0.0625),
                                    _uniform(gen, n, 0.5, 1.5), _uniform(gen, n, -45.0, 45.0), s, s)
    mat_b = flip_b @ _maybe_mat(gen, ssr)
    mat_c = _maybe_mat(gen, rotation_matrix(_uniform(gen, n, -90.0, 90.0), s, s))
    mats = torch.stack([mat_a, mat_b, mat_c], 1)
    order = torch.argsort(torch.rand(n, 3, generator=gen, device=dev), dim=1)
    g = _identity(n, dev)
    rows = torch.arange(n, device=dev)
    for j in range(3):
        g = g @ mats[rows, order[:, j]]
    return g


def draw_params(gen, n: int) -> torch.Tensor:
    """(n, 16) photometric parameters: 0-3 HSV shifts and gate, 4-5 noise
    sigma and gate, 6-8 HED shifts, 9-10 blur size and gate, 11-13
    brightness, contrast and gate."""
    dev = gen.device
    u = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(n, *shape, generator=gen, device=dev)
    coin = lambda: (torch.rand(n, generator=gen, device=dev) < 0.5).float()
    p = torch.zeros(n, N_PARAMS, dtype=torch.float32, device=dev)
    p[:, 0] = u(-0.1, 0.1)
    p[:, 1] = u(-1.0, 1.0)
    p[:, 2] = u(-20.0, 20.0)
    p[:, 3] = coin()
    p[:, 4] = u(0.0, 0.1)
    p[:, 5] = coin()
    sigma = u(-0.035, 0.035, 3)
    p[:, 6:9] = torch.randn(n, 3, generator=gen, device=dev) * sigma
    p[:, 9] = 3.0 + 2.0 * torch.randint(0, 3, (n,), generator=gen, device=dev).float()
    p[:, 10] = coin()
    p[:, 11] = u(-0.2, 0.2)
    p[:, 12] = u(-0.2, 0.2)
    p[:, 13] = coin()
    return p


def draw_seeds(gen, n: int) -> torch.Tensor:
    return torch.randint(0, 2**31 - 1, (n,), generator=gen, device=gen.device, dtype=torch.int32)


_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    prod = x * m
    return (prod >> 32) & _MASK, prod & _MASK


def philox4x32(ctr, key):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors of 32-bit words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform_open(bits: torch.Tensor) -> torch.Tensor:
    return ((bits >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)


def philox_normal(seeds: torch.Tensor, shape, tile0: int = 0) -> torch.Tensor:
    """Per-pixel N(0, 1) noise of (N, 3, H, W) tiles: one Philox call a
    pixel keyed on (seed[n], 0) at counter (x, y, tile0 + n, 0), Box-Muller
    on words 0-1 (channels 0, 1) and 2-3 (channel 2)."""
    n, _, h, w = shape
    dev = seeds.device
    ar = lambda k: torch.arange(k, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    ctr = (ar(w).view(1, 1, w), ar(h).view(1, h, 1), (tile0 + ar(n)).view(n, 1, 1), zero)
    key = (seeds.to(torch.int64).view(n, 1, 1) & _MASK, zero)
    b0, b1, b2, b3 = philox4x32(ctr, key)
    two_pi = 6.283185307179586
    r01 = torch.sqrt(-2.0 * torch.log(_uniform_open(b0)))
    r2 = torch.sqrt(-2.0 * torch.log(_uniform_open(b2)))
    t01 = two_pi * _uniform_open(b1)
    return torch.stack([r01 * torch.cos(t01), r01 * torch.sin(t01), r2 * torch.cos(two_pi * _uniform_open(b3))], 1)


def _mat3_apply(c0, c1, c2, m):
    return (c0 * m[0][0] + c1 * m[1][0] + c2 * m[2][0],
            c0 * m[0][1] + c1 * m[1][1] + c2 * m[2][1],
            c0 * m[0][2] + c1 * m[1][2] + c2 * m[2][2])


def _hed_shift(r, g, b, dh, de, dd):
    lr0, lg0, lb0 = -torch.log(r + 2.0), -torch.log(g + 2.0), -torch.log(b + 2.0)
    h, e, d = _mat3_apply(lr0, lg0, lb0, _HED_FROM_RGB)
    h, e, d = h + dh, e + de, d + dd
    lr, lg, lb = _mat3_apply(-h, -e, -d, _RGB_FROM_HED)
    clip = lambda x: torch.clamp((torch.exp(x) - 1.0) / 2.0, 0.0, 1.0)
    return clip(lr), clip(lg), clip(lb)


def _reflect101_index(size: int, r: int, device) -> torch.Tensor:
    idx = torch.arange(-r, size + r, device=device).abs()
    period = max(2 * (size - 1), 1)
    idx = idx % period
    return torch.where(idx >= size, period - idx, idx)


def box_blur_planes(x: torch.Tensor, ksize: torch.Tensor, max_k: int = 7) -> torch.Tensor:
    r = max_k // 2
    offsets = torch.arange(-r, r + 1, device=x.device, dtype=x.dtype).abs()
    taps = (offsets <= (ksize - 1.0) / 2.0).to(x.dtype)
    norm = taps.sum(-1, keepdim=True)
    for dim in (1, 2):
        size = x.shape[dim]
        padded = x.index_select(dim, _reflect101_index(size, r, x.device))
        acc = torch.zeros_like(x)
        for k in range(2 * r + 1):
            acc = acc + taps[..., k:k + 1] * padded.narrow(dim, k, size)
        x = acc / norm
    return x


def photometric_chain(imgs: torch.Tensor, params: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """HSV shift -> noise -> HED shift -> box blur -> brightness/contrast on
    (N, 3, H, W) tiles, each stage behind its gate."""
    p = [params[:, j].view(-1, 1, 1) for j in range(N_PARAMS)]
    r, g, b = imgs[:, 0], imgs[:, 1], imgs[:, 2]

    def gated(gate, new, old):
        return tuple(torch.where(gate > 0.5, a, o) for a, o in zip(new, old))

    h, s, v = rgb2hsv_planes(r, g, b)
    h = torch.remainder(h + p[0] / 180.0, 1.0)
    s = torch.clamp(s + p[1] / 255.0, 0.0, 1.0)
    v = torch.clamp(v + p[2] / 255.0, 0.0, 1.0)
    r, g, b = gated(p[3], hsv2rgb_planes(h, s, v), (r, g, b))
    noisy = tuple(torch.clamp(x + nz * p[4], 0.0, 1.0) for x, nz in zip((r, g, b), noise.unbind(1)))
    r, g, b = gated(p[5], noisy, (r, g, b))
    r, g, b = _hed_shift(r, g, b, p[6], p[7], p[8])
    r, g, b = gated(p[10], tuple(box_blur_planes(x, p[9]) for x in (r, g, b)), (r, g, b))
    bc = lambda x: torch.clamp(x * (1.0 + p[12]) + p[11], 0.0, 1.0)
    return torch.stack(gated(p[13], tuple(bc(x) for x in (r, g, b)), (r, g, b)), 1)


def to_float(img_u8: torch.Tensor) -> torch.Tensor:
    return img_u8.to(torch.float32) / 255.0


def rsp_views(gen, triplets_u8: torch.Tensor) -> tuple:
    """One pretraining step's orderings and views from (B, 3, S, S, 3) uint8
    triplets in [HR, LR1, LR2] order: the (B,) orderings, then each
    triplet reordered by its ordering, warped, noised from Philox, put
    through the chain and clipped -> (labels, (B, 3, 3, S, S) float32 in
    [0, 1]).  The pool's normalization is the identity (mean 0, std 1)."""
    b, t, s = triplets_u8.shape[:3]
    dev = triplets_u8.device
    labels = torch.randint(0, 6, (b,), generator=gen, device=gen.device).to(dev)
    mats = draw_pretrain_geo_matrices(gen, b * t, s)
    params = draw_params(gen, b * t)
    seeds = draw_seeds(gen, b * t)
    perms = torch.as_tensor(RSP_PERMUTATIONS, device=dev)[labels]
    ordered = torch.take_along_dim(triplets_u8, perms.view(b, 3, 1, 1, 1), dim=1)
    imgs = to_float(ordered.reshape(b * t, s, s, 3).permute(0, 3, 1, 2)).contiguous()
    warped = warp_affine_planar(imgs, mats, pad_mode="reflect101")
    out = torch.clamp(photometric_chain(warped, params, philox_normal(seeds, warped.shape)), 0.0, 1.0)
    return labels, out.reshape(b, t, 3, s, s)


# ---------------------------------------------------------------------------
# The fine-tune 3-view stack
# ---------------------------------------------------------------------------

THREE_VIEW_PAD = 20


def three_view_stack(gen, imgs_u8: torch.Tensor) -> torch.Tensor:
    """[identity, rotated, rotated + resized to (S+20)^2 + cropped to S^2]
    of each (B, S, S, 3) uint8 image, each rotation at p = 0.5 with
    reflect-101 borders, shuffled per image and clipped -> (B, 3, 3, S, S)."""
    b, s = imgs_u8.shape[:2]
    dev = gen.device
    resized = s + THREE_VIEW_PAD
    angles = -90.0 + 180.0 * torch.rand(b, 2, generator=gen, device=dev)
    rotate = torch.rand(b, 2, generator=gen, device=dev) < 0.5
    crop = torch.randint(0, resized - s + 1, (b, 2), generator=gen, device=dev)
    perm = torch.argsort(torch.rand(b, 3, generator=gen, device=dev), dim=1)
    v1 = to_float(imgs_u8).permute(0, 3, 1, 2)

    def rot(j):
        out = warp_affine_planar(v1, rotation_matrix(angles[:, j], s, s), pad_mode="reflect101")
        return torch.where(rotate[:, j].view(b, 1, 1, 1), out, v1)

    v3 = random_crop(resize(rot(1), resized, resized), crop[:, 0], crop[:, 1], s, s)
    views = torch.stack([v1, rot(0), v3], 1)
    return torch.clamp(torch.gather(views, 1, perm.view(b, 3, 1, 1, 1).expand_as(views)), 0.0, 1.0)
