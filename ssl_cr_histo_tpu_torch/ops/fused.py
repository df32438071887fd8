"""Composed augmentation policies: one composed matrix and one warp per
tile.  The geometric half of the v1 pretraining pool; the v1 strong pool of
consistency training (fused, fast and masked) with its weak and strong
views; the v2 pool (fused and masked).

Counterpart of ``ssl_cr_histo_tpu/ops/fused.py``.
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
    m = geometry.device_constant([[-1.0, 0.0, w - 1.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], device)
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


def _compose_stages(mats: torch.Tensor, geo: torch.Tensor, present: "torch.Tensor | None") -> torch.Tensor:
    """(b, 3, 3) ``g = I @ m_1 @ ... @ m_n`` of (b, n, 3, 3) stage matrices
    over the (b, n) stages that are geometric and, with ``present``,
    present, stage by stage in the drawn order (JAX's)."""
    if present is not None:
        geo = geo & present
    g = _identity(mats.shape[0], mats.device)
    for j in range(mats.shape[1]):
        g = _where_mat(geo[:, j], g @ mats[:, j], g)
    return g


def _random_flip_mat(kind: torch.Tensor, gate: torch.Tensor, s: int) -> torch.Tensor:
    """albumentations Flip (p = 0.5) as a matrix: kind 0 h, 1 v, 2 both
    (``fused.py:51-63``)."""
    n, dev = kind.shape[0], kind.device
    h, v = _hflip_mat(s, n, dev), _vflip_mat(s, n, dev)
    mat = _where_mat(kind == 0, h, _where_mat(kind == 1, v, v @ h))
    return _where_mat(gate > 0.5, mat, _identity(n, dev))


def strong_pool_matrix(ops: torch.Tensor, params: torch.Tensor, s: int,
                       present: "torch.Tensor | None" = None) -> torch.Tensor:
    """(b, 3, 3) composed inverse maps of the strong pool's geometric stages
    for (b, n) op indices and their (b, n, N_PARAMS) params, at tile edge
    ``s``: ``g = I @ m_1 @ ... @ m_n`` over the stages whose op is geometric
    (``fused.py:203-287``) and, with a (b, n) bool ``present``, present:
    scale_resize_crop's resize + crop, shift_scale_rotate's gated SSR,
    rotate_crop's gated flip times its gated rotation.  Each stage matrix is
    built for all (image, stage) pairs at once; ``_compose_stages``
    multiplies them."""
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
    return _compose_stages(mats, (ops == src) | (ops == ssr_op) | (ops == rc), present)


def randaugment_v1_fused(imgs: torch.Tensor, draws: dict) -> torch.Tensor:
    """The composed v1 strong pool on (b, 3, S, S) float32 images with the
    draws of ``ops.batch.draw_transform_fix`` (its ``ops`` and ``params``
    tables on the host, ``noise`` on the images' device): the photometric
    ops in stage order on the unwarped image, the geometric ops composed
    into one matrix per image, warped once at the end with reflect-101
    borders.  The three composed modes differ only in their draws:

      fused   each image its own op at each stage (``fused.py:229-287``)
      fast    one op sequence for the whole batch, each image's magnitudes,
              params and gates its own (``randaugment_v1_shared_batch``,
              ``fused.py:304-382``): one group a stage
      masked  the 9 ops once each in pool order, each where the image drew
              it (``draws['present']``; ``randaugment_v1_masked``,
              ``fused.py:385-440``)

    Rather than computing every op on every image and selecting (nine times
    the work), the images of each stage are grouped on the host by their
    photometric op with its gate on (``RA.stage_groups``) and each op runs
    on its group; the geometric stages compose each image's matrix on the
    host (``strong_pool_matrix``).  This is the plain version of the
    strong views kernel (``ops/strong_views_kernel.py``), which
    ``ops.batch.transform_fix_batch`` launches on CUDA images."""
    dev = imgs.device
    ops, params = draws["ops"].cpu(), draws["params"].cpu()
    present, active, owner = RA.v1_active_stages(draws, ops, params)
    x = imgs.clone()
    for _, op, rows, p, slots in RA.stage_groups(ops, active, params, len(RA.V1_POOL), dev, noise=owner):
        nz = draws["noise"].index_select(0, slots) if op == RA.NOISE else None
        x.index_copy_(0, rows, RA.apply_photometric(op, x.index_select(0, rows), p, nz))
    g = RA.to_device(strong_pool_matrix(ops, params, imgs.shape[-1], present), dev)
    return geometry.warp_affine_planar(x, g, pad_mode="reflect101")


def transform_fix_fused(imgs: torch.Tensor, draws: dict, pool=randaugment_v1_fused):
    """Weak and strong views of (b, 3, S, S) float32 images
    (``fused.py:290-301``, ``:443-476``; ``randaugment.py:457-466``): weak =
    the image, mirrored where ``weak_flip``; strong = the image mirrored
    where ``strong_flip``, then the v1 strong pool ``pool``: composed
    (``randaugment_v1_fused``), or op by op (``RA.randaugment_v1``)."""
    dev = imgs.device
    mirrored = geometry.flip_horizontal(imgs)
    flip = lambda k: torch.where(RA.to_device(draws[k].cpu(), dev).view(-1, 1, 1, 1), mirrored, imgs)
    return flip("weak_flip"), pool(flip("strong_flip"), draws)


# ---------------------------------------------------------------------------
# v2 pool, composed (``fused.py:480-627``): the photometric ops in stage
# order, the geometric ops composed into one matrix, one constant-padded
# two-pass warp at the end
# ---------------------------------------------------------------------------


def v2_pool_matrix(ops: torch.Tensor, params: torch.Tensor, s: int,
                   present: "torch.Tensor | None" = None) -> torch.Tensor:
    """(b, 3, 3) composed inverse maps ``g = I @ m_1 @ ... @ m_n`` of the v2
    pool's geometric stages (and, with ``present``, present ones) for (b, n)
    op indices and their (b, n, N_PARAMS) params at tile edge ``s``."""
    b, n = ops.shape
    op, p = ops.reshape(-1), params.reshape(b * n, RA.N_PARAMS)
    mats = _identity(b * n, params.device)
    for k in RA.V2_GEOMETRIC:
        mats = _where_mat(op == k, RA.v2_matrix(k, p, s), mats)
    return _compose_stages(mats.view(b, n, 3, 3), torch.isin(ops, torch.tensor(RA.V2_GEOMETRIC)), present)


def randaugment_v2_fused(imgs: torch.Tensor, draws: dict) -> torch.Tensor:
    """The composed v2 pool on (N, 3, S, S) float32 tiles with the draws of
    ``RA.draw_v2``, its tables on the host.  Without ``present``
    (``randaugment_v2_fused``, ``fused.py:480-560``) each tile's n ops
    apply in their drawn order; with it (``masked``,
    ``randaugment_v2_masked``, ``fused.py:562-627``) each of the 14 ops
    applies once, in pool order, where the tile drew it.  Photometric ops
    run on their (stage, op) groups; the geometric ones compose one matrix
    per tile, warped once with zero padding (``warp_affine_planar``)."""
    dev = imgs.device
    ops, params = draws["ops"].cpu(), draws["params"].cpu()
    present = RA.present_stages(draws, ops)
    photometric = torch.zeros(len(RA.V2_POOL), dtype=torch.bool)
    photometric[list(RA.V2_PHOTOMETRIC)] = True
    x = imgs.clone()
    for _, op, rows, p, _ in RA.stage_groups(ops, photometric[ops] & present, params, len(RA.V2_POOL), dev):
        x.index_copy_(0, rows, RA.apply_v2_photometric(op, x.index_select(0, rows), p))
    g = RA.to_device(v2_pool_matrix(ops, params, imgs.shape[-1], present), dev)
    return geometry.warp_affine_planar(x, g, pad_mode="constant")
