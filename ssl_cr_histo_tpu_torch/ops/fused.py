"""Fused augmentation policies: one composed matrix and one warp per tile.
The geometric half of the v1 pretraining pool, and the v1 strong pool of
consistency training with its weak and strong views.

Counterpart of ``ssl_cr_histo_tpu/ops/fused.py:38-125``, ``:189-195`` and
``:203-301``.
The draw step and the apply step are separate functions so that tests can
inject the matrices: ``torch.Generator`` streams differ from ``jax.random``
ones, so the two packages are compared on the same matrices and their draw
laws are compared by distribution.
"""

from __future__ import annotations

import torch

from ssl_cr_histo_tpu_torch.ops import geometry
from ssl_cr_histo_tpu_torch.ops import randaugment as RA


def _uniform(gen: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=gen.device)


def _coin(gen: torch.Generator, n: int, p: float = 0.5) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=gen.device) < p


def _identity(n: int, device) -> torch.Tensor:
    return torch.eye(3, dtype=torch.float32, device=device).expand(n, 3, 3)


def _where_mat(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.view(-1, 1, 1), a, b)


def _maybe_mat(gen: torch.Generator, mats: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    """Each tile's matrix with probability p, else the identity
    (``fused.py:38-39``)."""
    return _where_mat(_coin(gen, mats.shape[0], p), mats, _identity(mats.shape[0], mats.device))


def _hflip_mat(w: int, n: int, device) -> torch.Tensor:
    m = torch.tensor([[-1.0, 0.0, w - 1.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], device=device)
    return m.expand(n, 3, 3)


def resize_crop_matrix(oy: torch.Tensor, ox: torch.Tensor, s: int, pad: int = 20) -> torch.Tensor:
    """Resize S -> S+pad (half-pixel centers) then a crop back to S at
    offsets (oy, ox) (``fused.py:66-76``); (n,) offsets -> (n, 3, 3)."""
    oy, ox = oy.float(), ox.float()
    scale = s / (s + pad)
    zero, one = torch.zeros_like(oy), torch.ones_like(oy)
    sc = torch.full_like(oy, scale)
    return torch.stack([
        torch.stack([sc, zero, (ox + 0.5) * scale - 0.5], -1),
        torch.stack([zero, sc, (oy + 0.5) * scale - 0.5], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)


def _resize_crop_mat(gen: torch.Generator, n: int, s: int, pad: int = 20) -> torch.Tensor:
    """``resize_crop_matrix`` at offsets drawn uniform on 0..pad."""
    dev = gen.device
    oy = torch.randint(0, pad + 1, (n,), generator=gen, device=dev)
    ox = torch.randint(0, pad + 1, (n,), generator=gen, device=dev)
    return resize_crop_matrix(oy, ox, s, pad)


def draw_pretrain_geo_matrices(gen: torch.Generator, n: int, s: int) -> torch.Tensor:
    """(n, 3, 3) composed inverse maps of the pretraining pool's three
    geometric ops, in a random order per tile (``fused.py:84-125``)."""
    dev = gen.device
    # op A: Scale_Resize_Crop -- rotate(+-90, p=.5) then resize + random crop
    rot_a = _maybe_mat(gen, geometry.rotation_matrix(_uniform(gen, n, -90.0, 90.0), s, s))
    mat_a = rot_a @ _resize_crop_mat(gen, n, s)
    # op B: Shift_Scale_Rotate -- hflip(p=.5) then SSR(p=.5)
    flip_b = _maybe_mat(gen, _hflip_mat(s, n, dev))
    ssr = geometry.shift_scale_rotate_matrix(
        shift_x=_uniform(gen, n, -0.0625, 0.0625),
        shift_y=_uniform(gen, n, -0.0625, 0.0625),
        scale=_uniform(gen, n, 0.5, 1.5),
        degrees=_uniform(gen, n, -45.0, 45.0),
        h=s, w=s,
    )
    mat_b = flip_b @ _maybe_mat(gen, ssr)
    # op C: Rotate_Crop -- rotate(+-90, p=.5); no flip in the pretrain pool
    mat_c = _maybe_mat(gen, geometry.rotation_matrix(_uniform(gen, n, -90.0, 90.0), s, s))

    mats = torch.stack([mat_a, mat_b, mat_c], 1)  # (n, 3 ops, 3, 3)
    order = torch.argsort(torch.rand(n, 3, generator=gen, device=dev), dim=1)
    g = _identity(n, dev)
    rows = torch.arange(n, device=dev)
    for j in range(3):
        g = g @ mats[rows, order[:, j]]
    return g


def pretrain_geo_warp_planar(imgs: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """Apply the composed pretraining warps to (N, 3, S, S) tiles with
    reflect101 borders (``fused.py:189-195``, batched)."""
    return geometry.warp_affine_planar(imgs, mats, pad_mode="reflect101")


# ---------------------------------------------------------------------------
# v1 strong pool, fused (``fused.py:47-63``, ``:203-301``): the photometric
# ops apply in stage order on the unwarped image, the geometric ops compose
# one matrix per image, warped once at the end
# ---------------------------------------------------------------------------


def _vflip_mat(h: int, n: int, device) -> torch.Tensor:
    m = torch.tensor([[1.0, 0.0, 0.0], [0.0, -1.0, h - 1.0], [0.0, 0.0, 1.0]], device=device)
    return m.expand(n, 3, 3)


def _random_flip_mat(kind: torch.Tensor, gate: torch.Tensor, s: int) -> torch.Tensor:
    """albumentations Flip (p = 0.5) as a matrix: kind 0 h, 1 v, 2 both
    (``fused.py:51-63``)."""
    n, dev = kind.shape[0], kind.device
    h, v = _hflip_mat(s, n, dev), _vflip_mat(s, n, dev)
    mat = _where_mat(kind == 0, h, _where_mat(kind == 1, v, v @ h))
    return _where_mat(gate > 0.5, mat, _identity(n, dev))


def strong_pool_matrix(ops: torch.Tensor, params: torch.Tensor, s: int) -> torch.Tensor:
    """(b, 3, 3) composed inverse maps of the strong pool's geometric stages
    for (b, n) op indices and their (b, n, N_PARAMS) params, at tile edge
    ``s``: ``g = I @ m_1 @ ... @ m_n`` over the stages whose op is geometric
    (``fused.py:203-287``): scale_resize_crop's resize + crop,
    shift_scale_rotate's gated SSR, rotate_crop's gated flip times its gated
    rotation.  Each stage matrix is built for all (image, stage) pairs at
    once; the products run stage by stage, in JAX's order."""
    b, n = ops.shape
    dev = params.device
    src, ssr_op, rc = (RA.V1_POOL.index(k) for k in ("scale_resize_crop", "shift_scale_rotate", "rotate_crop"))
    op, p = ops.reshape(-1), params.reshape(b * n, RA.N_PARAMS)
    eye = _identity(b * n, dev)
    gate = p[:, RA.GATE] > 0.5
    ssr = geometry.shift_scale_rotate_matrix(p[:, 0], p[:, 1], p[:, 2], p[:, 3], s, s)
    rot = _random_flip_mat(p[:, 1], p[:, 2], s) @ _where_mat(gate, geometry.rotation_matrix(p[:, 0], s, s), eye)
    mats = _where_mat(op == src, resize_crop_matrix(p[:, 0], p[:, 1], s), eye)
    mats = _where_mat(op == ssr_op, _where_mat(gate, ssr, eye), mats)
    mats = _where_mat(op == rc, rot, mats).view(b, n, 3, 3)
    geo = ((ops == src) | (ops == ssr_op) | (ops == rc))
    g = _identity(b, dev)
    for j in range(n):
        g = _where_mat(geo[:, j], g @ mats[:, j], g)
    return g


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Copy a host table to ``device`` without waiting for the device."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def randaugment_v1_fused(imgs: torch.Tensor, draws: dict) -> torch.Tensor:
    """The fused v1 strong pool on (b, 3, S, S) float32 images
    (``fused.py:229-287``) with the draws of ``ops.batch.draw_transform_fix``
    (its ``ops`` and ``params`` tables on the host, ``noise`` on the
    images' device).

    Each image has its own op at each stage.  Rather than computing every
    op on every image and selecting (nine times the work), the images are
    grouped on the host by (stage, photometric op with its gate on) and each
    op runs on its group: one copy of the group tables to the device per
    batch, no copy back.  The geometric stages compose each image's matrix
    on the host (``strong_pool_matrix``), warped once at the end with
    reflect-101 borders."""
    dev = imgs.device
    ops, params = draws["ops"].cpu(), draws["params"].cpu()
    b, n = ops.shape
    n_ops = len(RA.V1_POOL)
    # one sort of the (image, stage) pairs by (stage, op): each group is a
    # run of that order, images ascending; gated-off and geometric pairs last
    photometric = torch.zeros(n_ops, dtype=torch.bool)
    photometric[list(RA.PHOTOMETRIC)] = True
    active = photometric[ops] & (params[..., RA.GATE] > 0.5)
    key = torch.where(active, torch.arange(n).view(1, n) * n_ops + ops, n * n_ops).flatten()
    pairs = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=n * n_ops + 1)[:-1].tolist()
    noise_slot = torch.cumsum((ops == RA.NOISE).flatten(), 0) - 1
    k = sum(counts)
    x = imgs.clone()
    if k:
        rows_d = _to_device(pairs[:k] // n, dev)
        table_d = _to_device(params.reshape(b * n, RA.N_PARAMS)[pairs[:k]], dev)
        slots_d = _to_device(noise_slot[pairs[:k]], dev)
        noise = draws["noise"]
        start = 0
        for group, count in enumerate(counts):
            if not count:
                continue
            op, a, e = group % n_ops, start, start + count
            start = e
            idx = rows_d[a:e]
            nz = noise.index_select(0, slots_d[a:e]) if op == RA.NOISE else None
            x.index_copy_(0, idx, RA.apply_photometric(op, x.index_select(0, idx), table_d[a:e], nz))
    g = _to_device(strong_pool_matrix(ops, params, imgs.shape[-1]), dev)
    return geometry.warp_affine_planar(x, g, pad_mode="reflect101")


def transform_fix_fused(imgs: torch.Tensor, draws: dict):
    """Weak and strong views of (b, 3, S, S) float32 images
    (``fused.py:290-301``): weak = the image, mirrored where ``weak_flip``;
    strong = the image mirrored where ``strong_flip``, then the fused v1
    strong pool."""
    dev = imgs.device
    mirrored = geometry.flip_horizontal(imgs)
    flip = lambda k: torch.where(_to_device(draws[k].cpu(), dev).view(-1, 1, 1, 1), mirrored, imgs)
    return flip("weak_flip"), randaugment_v1_fused(flip("strong_flip"), draws)
