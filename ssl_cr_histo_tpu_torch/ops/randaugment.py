"""The augmentation pools: the v1 strong pool of consistency training, the
v1 pretraining pool and the v2 RandAugment pool, each op's parameter law,
and the op-by-op (``exact``) policies.

Counterpart of ``ssl_cr_histo_tpu/ops/randaugment.py`` (reference
``models/randaugment.py:51-144``, ``dataset.py:109-216``,
``Pretraining_v2/models/randaugment.py:38-213``).  JAX draws each op's
parameters inside the op from its key; here a ``draw_*`` function draws
them for every (image, stage) pair at once from a torch generator, with the
same laws, into an (..., N_PARAMS) table whose slots each op reads as listed
under its pool.  The composed (fused, fast, masked) policies are in
``ops/fused.py``.

Every policy runs the same way: each stage's images are grouped on the host
by their op (``stage_groups``), and each op runs once per group on the
device, on the group's rows only.
"""

from __future__ import annotations

from typing import Optional

import torch

from ssl_cr_histo_tpu_torch.ops import geometry, photometric, stain

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


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Copy a host table to ``device`` without waiting for the device."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def stage_groups(ops: torch.Tensor, active: torch.Tensor, params: torch.Tensor, n_ops: int,
                 device: torch.device, noise: Optional[torch.Tensor] = None):
    """The (stage, op) groups of a policy, in stage order: for (b, n) host op
    indices ``ops`` in [0, n_ops), the (b, n) bool ``active`` pairs that run
    and their (b, n, P) ``params``, yield ``(stage, op, rows, params,
    slots)`` for each group with an active pair; ``rows`` (k,) the group's
    images ascending and ``params`` (k, P) their rows, on ``device``.
    ``noise`` (b, n) bool marks the pairs that own a noise field, numbered
    in row-major (image, stage) order; ``slots`` (k,) is each pair's field
    (None without ``noise``).  One sort of the pairs by (stage, op) and one
    copy of the group tables to the device, none back."""
    b, n = ops.shape
    key = torch.where(active, torch.arange(n).view(1, n) * n_ops + ops, n * n_ops).flatten()
    pairs = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=n * n_ops + 1)[:-1].tolist()
    k = sum(counts)
    if not k:
        return
    pairs = pairs[:k]
    rows_d = to_device(pairs // n, device)
    table_d = to_device(params.reshape(b * n, -1)[pairs], device)
    slots_d = None if noise is None else to_device(noise_slots(noise).flatten()[pairs], device)
    start = 0
    for group, count in enumerate(counts):
        if count:
            a, e = start, start + count
            start = e
            yield (group // n_ops, group % n_ops, rows_d[a:e], table_d[a:e],
                   None if slots_d is None else slots_d[a:e])


def present_stages(draws: dict, ops: torch.Tensor) -> torch.Tensor:
    """The (b, n) stages that run: ``draws['present']`` (the masked
    policies), else every stage."""
    present = draws.get("present")
    return torch.ones(ops.shape, dtype=torch.bool) if present is None else present.cpu().bool()


def noise_slots(owner: torch.Tensor) -> torch.Tensor:
    """(b, n) int64: each (image, stage) pair's noise field where the bool
    ``owner`` marks it, numbered in row-major (image, stage) order as
    ``draws['noise']`` holds them, else -1."""
    return torch.where(owner, torch.cumsum(owner.flatten(), 0).view(owner.shape) - 1, -1)


def v1_active_stages(draws: dict, ops: torch.Tensor, params: torch.Tensor) -> tuple:
    """The composed v1 strong pool's stages, on the host, for (b, n) op
    indices and their (b, n, N_PARAMS) params: (present, active, owner),
    each (b, n) bool.  ``present``: ``present_stages``; ``active``: the
    stages that run a photometric op, a photometric op with its gate on
    that is present; ``owner``: the present noise stages, each of which owns
    a field of ``draws['noise']`` (``noise_slots``)."""
    present = present_stages(draws, ops)
    photometric = torch.zeros(len(V1_POOL), dtype=torch.bool)
    photometric[list(PHOTOMETRIC)] = True
    active = photometric[ops] & (params[..., GATE] > 0.5) & present
    return present, active, (ops == NOISE) & present


def _random_flip(imgs: torch.Tensor, kind: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """albumentations Flip (p = 0.5) on the lattice: kind 0 h, 1 v, 2 both
    (``randaugment.py:140-153``)."""
    h, v = geometry.flip_horizontal(imgs), geometry.flip_vertical(imgs)
    kind = kind.view(-1, 1, 1, 1)
    flipped = torch.where(kind == 0, h, torch.where(kind == 1, v, geometry.flip_horizontal(v)))
    return torch.where(gate.view(-1, 1, 1, 1) > 0.5, flipped, imgs)


def apply_v1_exact(op: int, imgs: torch.Tensor, p: torch.Tensor,
                   noise: "torch.Tensor | None" = None) -> torch.Tensor:
    """Op ``op`` of the v1 strong pool, op by op, on (k, 3, S, S) images with
    their (k, N_PARAMS) params (``randaugment.py:55-176``): a photometric op
    or shift_scale_rotate on images whose gate is on; scale_resize_crop's
    resize to S + 20 and crop back; rotate_crop's gated flip, then its gated
    rotation.  Each geometric op is its own reflect-101 warp."""
    name = V1_POOL[op]
    s = imgs.shape[-1]
    if op in PHOTOMETRIC:
        return apply_photometric(op, imgs, p, noise)
    if name == "scale_resize_crop":
        return geometry.random_crop(geometry.resize(imgs, s + 20, s + 20), p[:, 0], p[:, 1], s, s)
    if name == "shift_scale_rotate":
        mats = geometry.shift_scale_rotate_matrix(p[:, 0], p[:, 1], p[:, 2], p[:, 3], s, s)
        return geometry.warp_affine_planar(imgs, mats, pad_mode="reflect101")
    x = _random_flip(imgs, p[:, 1], p[:, 2])
    rot = geometry.warp_affine_planar(x, geometry.rotation_matrix(p[:, 0], s, s), pad_mode="reflect101")
    return torch.where(p[:, GATE].view(-1, 1, 1, 1) > 0.5, rot, x)


def randaugment_v1(imgs: torch.Tensor, draws: dict) -> torch.Tensor:
    """v1 RandAugment op by op (``randaugment.py:179-204``, the ``exact``
    mode) on (b, 3, S, S) float32 images with the draws of
    ``ops.batch.draw_transform_fix``: each image's n stages in order, every
    geometric op its own warp.  The draws are the fused mode's, key for
    key in the JAX package."""
    ops, params = draws["ops"].cpu(), draws["params"].cpu()
    present = present_stages(draws, ops)
    active = present & ((params[..., GATE] > 0.5) | (ops == V1_POOL.index("rotate_crop")))
    x = imgs.clone()
    for _, op, rows, p, slots in stage_groups(ops, active, params, len(V1_POOL), imgs.device,
                                              noise=(ops == NOISE) & present):
        nz = draws["noise"].index_select(0, slots) if op == NOISE else None
        x.index_copy_(0, rows, apply_v1_exact(op, x.index_select(0, rows), p, nz))
    return x


# ---------------------------------------------------------------------------
# v1 pretraining pool (``randaugment.py:213-322``; reference dataset.py:
# 109-216): all 8 ops in one random order shared by a triplet's 3 tiles,
# each op's parameters drawn per tile
# ---------------------------------------------------------------------------

# Param slots per op, GATE the op's p = 0.5 gate (1 for color):
#   0 hsv                  hue, sat, val shifts
#   1 noise                sigma
#   2 scale_resize_crop    degrees, crop offsets oy, ox; GATE gates the rotation
#   3 shift_scale_rotate   shift_x, shift_y, scale, degrees, hflip coin
#   4 color                HED shifts dh, de, dd
#   5 blur                 ksize in {3, 5, 7}
#   6 brightness_contrast  brightness, contrast
#   7 rotate_crop          degrees
PRETRAIN_POOL_V1 = ("hsv", "noise", "scale_resize_crop", "shift_scale_rotate", "color", "blur",
                    "brightness_contrast", "rotate_crop")
PRETRAIN_MAX_BLUR = 7


def draw_pretrain_v1_params(gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, 8, N_PARAMS) float32: every op's parameters for each of ``n``
    tiles, with the pool's laws (``randaugment.py:213-297``), on ``gen``'s
    device."""
    dev = gen.device
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)
    coin = lambda: (torch.rand(n, generator=gen, device=dev) < 0.5).float()
    randint = lambda lo, hi: torch.randint(lo, hi, (n,), generator=gen, device=dev).float()
    zero, one = torch.zeros(n, device=dev), torch.ones(n, device=dev)
    rows = [
        [u(-0.1, 0.1), u(-1.0, 1.0), u(-20.0, 20.0), zero, zero, coin()],
        [u(0.0, 0.1), zero, zero, zero, zero, coin()],
        [u(-90.0, 90.0), randint(0, 21), randint(0, 21), zero, zero, coin()],
        [u(-0.0625, 0.0625), u(-0.0625, 0.0625), u(0.5, 1.5), u(-45.0, 45.0), coin(), coin()],
        [torch.randn(n, generator=gen, device=dev) * u(-0.035, 0.035) for _ in range(3)] + [zero, zero, one],
        [3.0 + 2.0 * randint(0, 3), zero, zero, zero, zero, coin()],
        [u(-0.2, 0.2), u(-0.2, 0.2), zero, zero, zero, coin()],
        [u(-90.0, 90.0), zero, zero, zero, zero, coin()],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], 1)


def apply_pretrain_v1(op: int, imgs: torch.Tensor, p: torch.Tensor,
                      noise: "torch.Tensor | None" = None) -> torch.Tensor:
    """Op ``op`` of the v1 pretraining pool on (k, 3, S, S) tiles with their
    (k, N_PARAMS) params (``randaugment.py:213-297``); a gated op gets only
    tiles whose gate is on, except scale_resize_crop (its gate is the
    rotation's, the crop always runs) and shift_scale_rotate (its flip has
    its own coin)."""
    name = PRETRAIN_POOL_V1[op]
    s = imgs.shape[-1]
    warp = lambda x, mats: geometry.warp_affine_planar(x, mats, pad_mode="reflect101")
    gated = lambda out, x: torch.where(p[:, GATE].view(-1, 1, 1, 1) > 0.5, out, x)
    if name == "hsv":
        return photometric.hsv_shift(imgs, p[:, 0], p[:, 1], p[:, 2])
    if name == "noise":
        return photometric.gaussian_noise(imgs, noise, p[:, 0])
    if name == "scale_resize_crop":
        x = gated(warp(imgs, geometry.rotation_matrix(p[:, 0], s, s)), imgs)
        return geometry.random_crop(geometry.resize(x, s + 20, s + 20), p[:, 1], p[:, 2], s, s)
    if name == "shift_scale_rotate":
        x = torch.where(p[:, 4].view(-1, 1, 1, 1) > 0.5, geometry.flip_horizontal(imgs), imgs)
        return gated(warp(x, geometry.shift_scale_rotate_matrix(p[:, 0], p[:, 1], p[:, 2], p[:, 3], s, s)), x)
    if name == "color":
        return stain.hed_shift(imgs, p[:, 0], p[:, 1], p[:, 2])
    if name == "blur":
        return photometric.box_blur(imgs, p[:, 0], max_ksize=PRETRAIN_MAX_BLUR)
    if name == "brightness_contrast":
        return photometric.brightness_contrast(imgs, p[:, 0], p[:, 1])
    return warp(imgs, geometry.rotation_matrix(p[:, 0], s, s))


def draw_pretrain_v1(gen: torch.Generator, b: int, size: int, host_gen: Optional[torch.Generator] = None,
                     tiles: int = 3) -> dict:
    """The draws of the op-by-op v1 pretraining pool for ``b`` triplets of
    ``tiles`` tiles of ``size``^2: ``order`` (b, 8) int64, each triplet's op
    order; ``params`` (b * tiles, 8, N_PARAMS), every op's parameters per
    tile (``draw_pretrain_v1_params``), both from ``host_gen`` (a CPU
    generator; ``gen`` when None); ``noise`` (b * tiles, 3, size, size)
    standard normal, one field per tile, from ``gen`` on its device."""
    tg = gen if host_gen is None else host_gen
    if tg.device.type != "cpu":
        raise ValueError("the pool's tables are drawn on the host: pass a CPU host_gen")
    order = torch.argsort(torch.rand(b, len(PRETRAIN_POOL_V1), generator=tg), dim=1)
    return {"order": order, "params": draw_pretrain_v1_params(tg, b * tiles),
            "noise": torch.randn(b * tiles, 3, size, size, generator=gen, device=gen.device)}


def pretrain_augment_v1(imgs: torch.Tensor, draws: dict) -> torch.Tensor:
    """The v1 pretraining pool op by op (``randaugment.py:300-322``, the
    ``exact`` mode) on (B * T, 3, S, S) float32 tiles, T tiles a triplet,
    with the draws of ``draw_pretrain_v1``: each tile runs all 8 ops in its
    triplet's order, with its own parameters."""
    order, params = draws["order"].cpu(), draws["params"].cpu()
    tiles = imgs.shape[0] // order.shape[0]
    order = order.repeat_interleave(tiles, 0)
    stage = params.gather(1, order.unsqueeze(-1).expand(-1, -1, params.shape[-1]))
    always = (order == PRETRAIN_POOL_V1.index("scale_resize_crop")) | (
        order == PRETRAIN_POOL_V1.index("shift_scale_rotate"))
    active = (stage[..., GATE] > 0.5) | always
    x = imgs.clone()
    for _, op, rows, p, slots in stage_groups(order, active, stage, len(PRETRAIN_POOL_V1), imgs.device,
                                              noise=order == PRETRAIN_POOL_V1.index("noise")):
        nz = draws["noise"].index_select(0, slots) if op == PRETRAIN_POOL_V1.index("noise") else None
        x.index_copy_(0, rows, apply_pretrain_v1(op, x.index_select(0, rows), p, nz))
    return x


# ---------------------------------------------------------------------------
# v2 pool (``randaugment.py:328-449``; reference Pretraining_v2/models/
# randaugment.py:38-213): 14 ops, n drawn without replacement, magnitudes
# uniform on [1, m)
# ---------------------------------------------------------------------------

# Param slots per op:
#   contrast, brightness, sharpness, color   the enhance factor
#   rotate, translate_x/y, shear_x/y         the signed degrees, pixels, level
#   hed                                      sigmas (3), biases (3)
#   hsv                                      hue, saturation, brightness sigmas
#   identity, autocontrast, equalize         none
V2_POOL = ("identity", "contrast", "brightness", "sharpness", "rotate", "translate_x", "translate_y",
           "shear_x", "shear_y", "hed", "hsv", "autocontrast", "color", "equalize")
V2_GEOMETRIC = tuple(V2_POOL.index(k) for k in ("rotate", "translate_x", "translate_y", "shear_x", "shear_y"))
V2_PHOTOMETRIC = tuple(i for i in range(1, len(V2_POOL)) if i not in V2_GEOMETRIC)
V2_MAX_LEVEL = 10.0


def enh_factor(v: torch.Tensor) -> torch.Tensor:
    """PIL enhance factor of magnitude v: ``(v / 10) * 1.8 + 0.1``
    (``randaugment.py:331-332``)."""
    return (v / V2_MAX_LEVEL) * 1.8 + 0.1


def draw_v2_params(gen: torch.Generator, ops: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """(..., N_PARAMS) float32 parameters for v2 op indices ``ops`` at
    float magnitudes ``vals`` (same shape), on ``gen``'s device: every op's
    law drawn for every entry, each entry keeping its own op's
    (``randaugment.py:335-411``); a sign flip is ``+`` at U < 0.5."""
    shape, dev = ops.shape, gen.device
    rand = lambda: torch.rand(shape, generator=gen, device=dev)
    sign = lambda x: torch.where(rand() < 0.5, x, -x)
    zero = torch.zeros(shape, device=dev)
    v = vals.to(dev).float()
    f = v * 0.03
    u = lambda: -f + (f + f) * rand()
    level = lambda scale: [sign((v / V2_MAX_LEVEL) * scale)] + [zero] * 5
    enh = [enh_factor(v)] + [zero] * 5
    laws = {
        "contrast": lambda: enh, "brightness": lambda: enh, "sharpness": lambda: enh, "color": lambda: enh,
        "rotate": lambda: level(30.0), "translate_x": lambda: level(10.0), "translate_y": lambda: level(10.0),
        "shear_x": lambda: level(0.3), "shear_y": lambda: level(0.3),
        "hed": lambda: [u() for _ in range(6)],
        "hsv": lambda: [u(), u(), zero, zero, zero, zero],
    }
    out = torch.zeros(*shape, N_PARAMS, device=dev)
    ops = ops.to(dev)
    for i, name in enumerate(V2_POOL):
        if name in laws:
            out = torch.where((ops == i).unsqueeze(-1), torch.stack(laws[name](), -1), out)
    return out


def draw_v2(gen: torch.Generator, n_tiles: int, n: int, m: float, masked: bool = False) -> dict:
    """The draws of the v2 pool for ``n_tiles`` tiles, from ``gen`` (a CPU
    generator: the op groups are formed on the host):

      ops     (n_tiles, n) int64, n distinct ops in a random order
              (``randaugment.py:433-434``); with ``masked``, the whole pool
              (n_tiles, 14) in pool order
      present with ``masked`` only: (n_tiles, 14) bool, exactly n True, the
              ops of a uniformly drawn n-subset (rank < n of a random
              permutation, ``fused.py:588-590``)
      vals    magnitudes uniform on [1, m), one per entry of ``ops``
      params  (..., N_PARAMS) float32 (``draw_v2_params``)"""
    if gen.device.type != "cpu":
        raise ValueError("the v2 pool's tables are drawn on the host: pass a CPU generator")
    k = len(V2_POOL)
    ranks = torch.argsort(torch.rand(n_tiles, k, generator=gen), dim=1)
    out = {}
    if masked:
        out["ops"] = torch.arange(k).expand(n_tiles, k).clone()
        out["present"] = ranks < n
    else:
        out["ops"] = ranks[:, :n].contiguous()
    out["vals"] = 1.0 + (float(m) - 1.0) * torch.rand(out["ops"].shape, generator=gen)
    out["params"] = draw_v2_params(gen, out["ops"], out["vals"])
    return out


def apply_v2_photometric(op: int, imgs: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Photometric op ``op`` of the v2 pool on (k, 3, H, W) images with
    their (k, N_PARAMS) params (``randaugment.py:338-426``)."""
    name = V2_POOL[op]
    if name == "identity":
        return imgs
    if name in ("contrast", "brightness", "sharpness", "color"):
        return getattr(photometric, f"pil_{name}")(imgs, p[:, 0])
    if name == "hed":
        return stain.hed_color_augment(imgs, p[:, 0:3], p[:, 3:6], 0.15, 0.85)
    if name == "hsv":
        return stain.hsb_color_augment(imgs, p[:, 0:3])
    if name == "autocontrast":
        return photometric.autocontrast(imgs)
    if name == "equalize":
        return photometric.equalize(imgs)
    raise ValueError(f"op {op} ({name}) is not photometric")


def v2_matrix(op: int, p: torch.Tensor, s: int) -> torch.Tensor:
    """(k, 3, 3) inverse maps of geometric v2 op ``op`` for (k, N_PARAMS)
    params on s x s tiles (``randaugment.py:351-382``)."""
    name, level = V2_POOL[op], p[:, 0]
    if name == "rotate":
        return geometry.rotation_matrix(level, s, s)
    if name == "translate_x":
        return geometry.translation_matrix(level, torch.zeros_like(level))
    if name == "translate_y":
        return geometry.translation_matrix(torch.zeros_like(level), level)
    if name == "shear_x":
        return geometry.shear_x_matrix(level)
    if name == "shear_y":
        return geometry.shear_y_matrix(level)
    raise ValueError(f"op {op} ({name}) is not geometric")


def randaugment_v2(imgs: torch.Tensor, draws: dict) -> torch.Tensor:
    """v2 RandAugment op by op (``randaugment.py:430-449``, the ``exact``
    mode) on (N, 3, S, S) float32 tiles with the draws of ``draw_v2``:
    each tile's n ops in its drawn order; rotate and translate as PIL's
    nearest-neighbour warps with black fill, the shears bilinear with black
    fill (``geometry.warp_affine``).  The draws are the fused mode's, key
    for key in the JAX package."""
    ops, params = draws["ops"].cpu(), draws["params"].cpu()
    s = imgs.shape[-1]
    x = imgs.clone()
    for _, op, rows, p, _ in stage_groups(ops, ops != 0, params, len(V2_POOL), imgs.device):
        src = x.index_select(0, rows)
        if op in V2_GEOMETRIC:
            interp = "bilinear" if V2_POOL[op].startswith("shear") else "nearest"
            out = geometry.warp_affine(src, v2_matrix(op, p, s), interp=interp, pad_mode="constant")
        else:
            out = apply_v2_photometric(op, src, p)
        x.index_copy_(0, rows, out)
    return x
