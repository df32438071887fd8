"""Fused geometric half of the v1 pretraining pool: one composed matrix and
one warp per tile.

Counterpart of ``ssl_cr_histo_tpu/ops/fused.py:38-125`` and ``:189-195``.
The draw step and the apply step are separate functions so that tests can
inject the matrices: ``torch.Generator`` streams differ from ``jax.random``
ones, so the two packages are compared on the same matrices and their draw
laws are compared by distribution.
"""

from __future__ import annotations

import torch

from ssl_cr_histo_tpu_torch.ops import geometry


def _uniform(gen: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=gen.device)


def _coin(gen: torch.Generator, n: int, p: float = 0.5) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=gen.device) < p


def _identity(n: int, device) -> torch.Tensor:
    return torch.eye(3, dtype=torch.float32, device=device).expand(n, 3, 3)


def _maybe_mat(gen: torch.Generator, mats: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    """Each tile's matrix with probability p, else the identity
    (``fused.py:38-39``)."""
    keep = _coin(gen, mats.shape[0], p).view(-1, 1, 1)
    return torch.where(keep, mats, _identity(mats.shape[0], mats.device))


def _hflip_mat(w: int, n: int, device) -> torch.Tensor:
    m = torch.tensor([[-1.0, 0.0, w - 1.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], device=device)
    return m.expand(n, 3, 3)


def _resize_crop_mat(gen: torch.Generator, n: int, s: int, pad: int = 20) -> torch.Tensor:
    """Resize S -> S+pad (half-pixel centers) then a random crop back to S
    (``fused.py:66-76``)."""
    dev = gen.device
    oy = torch.randint(0, pad + 1, (n,), generator=gen, device=dev).float()
    ox = torch.randint(0, pad + 1, (n,), generator=gen, device=dev).float()
    scale = s / (s + pad)
    zero, one = torch.zeros(n, device=dev), torch.ones(n, device=dev)
    sc = torch.full((n,), scale, dtype=torch.float32, device=dev)
    return torch.stack([
        torch.stack([sc, zero, (ox + 0.5) * scale - 0.5], -1),
        torch.stack([zero, sc, (oy + 0.5) * scale - 0.5], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)


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
