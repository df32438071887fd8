"""Frozen plain-PyTorch copy of the consistency stage's weak and strong
views (the v1 strong pool, ``--aug_mode fused``), taken from the port's
``ops/{batch,fused,randaugment,photometric,stain,color,geometry}.py``.

Draws: the tables (mirror coins, each stage's op and magnitude, each op's
parameters) from a CPU generator, the noise fields from the device's, in
the order the program draws them.  Arithmetic: as plainly as the program's
composed form allows: each stage's photometric ops are computed on every
image and kept where that image drew the op with its gate on, then every
image's geometric stages are composed into one matrix and warped once with
reflect-101 borders.
"""

from __future__ import annotations

import torch

from port_bench.reference import augment as A

V1_POOL = ("hsv", "noise", "scale_resize_crop", "shift_scale_rotate", "color", "blur", "brightness",
           "contrast", "rotate_crop")
NOISE = V1_POOL.index("noise")
GEOMETRIC = tuple(V1_POOL.index(k) for k in ("scale_resize_crop", "shift_scale_rotate", "rotate_crop"))
PHOTOMETRIC = tuple(i for i in range(len(V1_POOL)) if i not in GEOMETRIC)
N_PARAMS = 6
GATE = 5
MAX_BLUR = 5


def _mag(v, lo, hi):
    return (v.to(torch.float32) / 30.0) * (hi - lo) + lo


def draw_params(gen, ops, mags):
    """(..., 6) parameters of each entry's op at its magnitude: every op's
    law drawn for every entry, each entry keeping its own op's."""
    shape, dev = ops.shape, gen.device
    rand = lambda: torch.rand(shape, generator=gen, device=dev)
    u = lambda lo, hi: lo + (hi - lo) * rand()
    coin = lambda: (rand() < 0.5).float()
    randint = lambda lo, hi: torch.randint(lo, hi, shape, generator=gen, device=dev).float()
    zero, one = torch.zeros(shape, device=dev), torch.ones(shape, device=dev)
    v = mags.to(dev)

    def hsv():
        val = _mag(v, -1.0, 1.0).abs()
        return [u(-val, val), u(-val, val), u(-val, val), zero, zero, coin()]

    def noise():
        return [u(0.0, _mag(v, 0.0, 0.15)), zero, zero, zero, zero, coin()]

    def scale_resize_crop():
        return [randint(0, 21), randint(0, 21), zero, zero, zero, one]

    def shift_scale_rotate():
        val = _mag(v, 0.01, 0.1)
        return [u(-val, val), u(-val, val), u(1.0 - (val + 0.5), 1.0 + (val + 0.5)), u(-90.0, 90.0), zero, coin()]

    def color():
        sigma = [u(-0.035, 0.035) for _ in range(3)]
        return [torch.randn(shape, generator=gen, device=dev) * s for s in sigma] + [zero, zero, one]

    def blur():
        return [3.0 + 2.0 * randint(0, 2), zero, zero, zero, zero, coin()]

    def brightness():
        val = _mag(v, -0.2, 0.2).abs()
        return [u(-val, val), u(-0.2, 0.2), zero, zero, zero, coin()]

    def contrast():
        val = _mag(v, -0.2, 0.2).abs()
        return [u(-0.2, 0.2), u(-val, val), zero, zero, zero, coin()]

    def rotate_crop():
        val = _mag(v, -90.0, 90.0).abs()
        return [u(-val, val), randint(0, 3), coin(), zero, zero, coin()]

    out = torch.zeros(*shape, N_PARAMS, device=dev)
    ops = ops.to(dev)
    for i, law in enumerate((hsv, noise, scale_resize_crop, shift_scale_rotate, color, blur, brightness, contrast,
                             rotate_crop)):
        out = torch.where((ops == i).unsqueeze(-1), torch.stack(law(), -1), out)
    return out


def draw(gen, host_gen, b: int, size: int, n: int, m: int) -> dict:
    ops = torch.randint(0, len(V1_POOL), (b, n), generator=host_gen)
    mags = torch.randint(1, m, ops.shape, generator=host_gen)
    weak_flip = torch.rand(b, generator=host_gen) < 0.5
    strong_flip = torch.rand(b, generator=host_gen) < 0.5
    params = draw_params(host_gen, ops, mags)
    k = int((ops == NOISE).sum())
    noise = torch.randn(k, 3, size, size, generator=gen, device=gen.device)
    return {"weak_flip": weak_flip, "strong_flip": strong_flip, "ops": ops, "params": params, "noise": noise}


def _hed_shift(img, shift):
    m = lambda x, mat: torch.einsum("...ihw,ij->...jhw", x, torch.from_numpy(mat).to(x.device))
    hed = m(-torch.log(img.float() + 2.0), A.HED_FROM_RGB) + shift.view(-1, 3, 1, 1)
    return torch.clamp((torch.exp(-m(hed, A.RGB_FROM_HED)) - 2.0 + 1.0) / 2.0, 0.0, 1.0)


def _photometric(op: int, x, p, noise):
    per = lambda j: p[:, j].view(-1, 1, 1, 1)
    name = V1_POOL[op]
    if name == "hsv":
        h, s, v = A.rgb2hsv_planes(x[:, 0], x[:, 1], x[:, 2])
        q = lambda j: p[:, j].view(-1, 1, 1)
        h = torch.remainder(h + q(0) / 180.0, 1.0)
        s = torch.clamp(s + q(1) / 255.0, 0.0, 1.0)
        v = torch.clamp(v + q(2) / 255.0, 0.0, 1.0)
        return torch.stack(A.hsv2rgb_planes(h, s, v), 1)
    if name == "noise":
        return torch.clamp(x + noise * per(0), 0.0, 1.0)
    if name == "color":
        return _hed_shift(x, p[:, 0:3])
    if name == "blur":
        b, c, h, w = x.shape
        k = p[:, 0].view(b, 1, 1).repeat_interleave(c, 0)
        return A.box_blur_planes(x.reshape(b * c, h, w), k, MAX_BLUR).view(b, c, h, w)
    return torch.clamp(x * (1.0 + per(1)) + per(0), 0.0, 1.0)  # brightness, contrast


def _where_mat(mask, a, b):
    return torch.where(mask.view(-1, 1, 1), a, b)


def _flip_mat(kind, gate, s):
    n, dev = kind.shape[0], kind.device
    h = A._const([[-1.0, 0.0, s - 1.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dev).expand(n, 3, 3)
    v = A._const([[1.0, 0.0, 0.0], [0.0, -1.0, s - 1.0], [0.0, 0.0, 1.0]], dev).expand(n, 3, 3)
    mat = _where_mat(kind == 0, h, _where_mat(kind == 1, v, v @ h))
    return _where_mat(gate > 0.5, mat, A._identity(n, dev))


def strong_matrix(ops, params, s: int):
    """(b, 3, 3): I @ m_1 @ ... @ m_n over each image's geometric stages."""
    b, n = ops.shape
    dev = params.device
    src, ssr_op, rc = GEOMETRIC
    op, p = ops.reshape(-1).to(dev), params.reshape(b * n, N_PARAMS)
    eye = A._identity(b * n, dev)
    gate = p[:, GATE] > 0.5
    ssr = A.shift_scale_rotate_matrix(p[:, 0], p[:, 1], p[:, 2], p[:, 3], s, s)
    rot = _flip_mat(p[:, 1], p[:, 2], s) @ _where_mat(gate, A.rotation_matrix(p[:, 0], s, s), eye)
    mats = _where_mat(op == src, A.resize_crop_matrix(p[:, 0], p[:, 1], s), eye)
    mats = _where_mat(op == ssr_op, _where_mat(gate, ssr, eye), mats)
    mats = _where_mat(op == rc, rot, mats).view(b, n, 3, 3)
    geo = torch.isin(ops.to(dev), torch.tensor(GEOMETRIC, device=dev))
    g = A._identity(b, dev)
    for j in range(n):
        g = _where_mat(geo[:, j], g @ mats[:, j], g)
    return g


def weak_strong(gen, host_gen, imgs_u8, n: int = 7, m: int = 10) -> tuple:
    """(B, S, S, 3) uint8 images -> (weak, strong) (B, 3, S, S) float32 in
    [0, 1]: weak the image mirrored on its coin; strong the image mirrored
    on its own coin, then the n-stage strong pool."""
    b, s = imgs_u8.shape[:2]
    dev = imgs_u8.device
    d = draw(gen, host_gen, b, s, n, m)
    imgs = A.to_float(imgs_u8.permute(0, 3, 1, 2).contiguous())
    mirrored = imgs.flip(-1)
    weak = torch.where(d["weak_flip"].to(dev).view(-1, 1, 1, 1), mirrored, imgs)
    x = torch.where(d["strong_flip"].to(dev).view(-1, 1, 1, 1), mirrored, imgs)
    ops, params = d["ops"].to(dev), d["params"].to(dev)
    slot = torch.cumsum((ops == NOISE).flatten().long(), 0).view(b, n) - 1
    for j in range(n):
        on = params[:, j, GATE] > 0.5
        for op in PHOTOMETRIC:
            rows = on & (ops[:, j] == op)
            if not bool(rows.any()):
                continue
            noise = None
            if op == NOISE:
                noise = d["noise"][slot[:, j].clamp_min(0)]
            x = torch.where(rows.view(-1, 1, 1, 1), _photometric(op, x, params[:, j], noise), x)
    # the maps are composed on the host, as the program composes them
    strong = A.warp_affine_planar(x, strong_matrix(d["ops"], d["params"], s).to(dev), pad_mode="reflect101")
    return torch.clamp(weak, 0.0, 1.0), torch.clamp(strong, 0.0, 1.0)
