"""Batched augmentation entry points on the device.

Counterpart of ``ssl_cr_histo_tpu/ops/batch.py``, every policy and mode:
the v1 RSP pretraining pool in fused mode, which on the card is one
hand-written kernel from the uint8 triplets to the normalized planar batch
(``ops/rsp_augment_kernel.py``), and in exact mode (op by op); the v2 pool
(fused, masked, exact); the fine-tune 3-view stack; the weak/strong
consistency views (fused, fast, masked, exact).  All but the fused v1 pool
are PyTorch ops, as they are XLA ops in the JAX package.

Data parallelism: every entry point takes ``shard`` = (offset, total), which
says that its images are rows [offset, offset + b) of a global batch of
``total`` (``parallel.mesh.rows_for_batch``).  It then draws for the whole
global batch, from generators whose states are equal on every process, and
keeps the draws of its own rows (``take_rows``), so each process's views are
the rows of the views one process would make of the global batch, and the
generators stay equal everywhere.  Injected ``draws`` are the global
batch's too.  Where a draw is a device noise field, each process draws the
whole batch's fields and keeps its own: N processes each draw N times
their rows' normals (at v1 exact pretraining's 64 triplets of 256^2, the
whole batch's 151 MB of float32 normals a step on every process).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ssl_cr_histo_tpu_torch.ops import fused, geometry
from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK
from ssl_cr_histo_tpu_torch.ops import randaugment as RA
from ssl_cr_histo_tpu_torch.ops import rsp_augment_kernel as RK

# ``--aug_mode``'s values (``cli/common.py``)
AUG_MODES = ("fused", "fast", "masked", "exact")
# The reference scales by /255 only (ToTensor): mean 0, std 1.
DEFAULT_MEAN = (0.0, 0.0, 0.0)
DEFAULT_STD = (1.0, 1.0, 1.0)


def take_rows(draws: dict, start: int, stop: int, keys: Sequence[str]) -> dict:
    """``draws`` with each of ``keys`` (where present and not None) cut to
    rows [start, stop); the other entries as they are."""
    return {k: (v[start:stop] if k in keys and v is not None else v) for k, v in draws.items()}


def _shard(shard: "Tuple[int, int] | None", b: int) -> Tuple[int, int]:
    """(offset, total) of ``b`` local rows; the whole batch when None."""
    if shard is None:
        return 0, b
    offset, total = shard
    if not 0 <= offset <= total - b:
        raise ValueError(f"rows [{offset}, {offset + b}) outside a global batch of {total}")
    return offset, total


def to_float(img_u8: torch.Tensor) -> torch.Tensor:
    return img_u8.to(torch.float32) / 255.0


def draw_rsp_v1(gen: torch.Generator, n: int, size: int) -> dict:
    """The per-tile draws of the fused v1 pool for ``n`` tiles: composed
    warp matrices and photometric params.  Noise is left to the kernel's
    Philox generator (``noise`` None)."""
    return {
        "geo": fused.draw_pretrain_geo_matrices(gen, n, size),
        "params": PK.draw_params(gen, n),
        "noise": None,
    }


def _planar_tiles(triplets_u8: torch.Tensor, order: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 triplets, each reordered by
    ``RSP_PERMUTATIONS[order[b]]`` when ``order`` is given -> (B * T, 3, H, W)
    float32 in [0, 1]."""
    if order is not None:
        triplets_u8 = RK.permute_triplets(triplets_u8, order.to(triplets_u8.device))
    b, t, h, w, c = triplets_u8.shape
    return to_float(triplets_u8.reshape(b * t, h, w, c).permute(0, 3, 1, 2))


def _finish(tiles: torch.Tensor, b: int, mean, std, out_dtype: torch.dtype) -> torch.Tensor:
    """(B * T, 3, H, W) augmented tiles -> (B, T, 3, H, W) clipped,
    normalized, in ``out_dtype``."""
    out = normalize_batch(torch.clamp(tiles, 0.0, 1.0), mean, std, channel_axis=1)
    return out.reshape(b, -1, *out.shape[1:]).to(out_dtype)


def augment_rsp_batch_v1(gen: torch.Generator, triplets_u8: torch.Tensor, mode: str = "fused",
                         draws: Optional[dict] = None, mean=DEFAULT_MEAN, std=DEFAULT_STD,
                         out_dtype: torch.dtype = torch.float32,
                         order: Optional[torch.Tensor] = None,
                         host_gen: Optional[torch.Generator] = None,
                         shard: "Tuple[int, int] | None" = None) -> torch.Tensor:
    """v1 RSP pretraining augmentation, clipped and normalized
    (``batch.py:40-74``, then ``normalize_batch``): mode 'fused', the
    composed warp and the photometric chain in one kernel, and 'fast' and
    'masked' with it (the JAX step maps both to 'fused' for this pool,
    ``steps.py:126-128``); 'exact', the pool op by op
    (``RA.pretrain_augment_v1``; draws of ``RA.draw_pretrain_v1``, tables
    from ``host_gen``, noise from ``gen``).

    triplets_u8: (B, 3, H, W, 3) uint8, the sampler's layout.  Returns
    (B, 3, 3, H, W) ``(clip(aug(x)) - mean) / std`` in ``out_dtype``,
    channel-planar: the backbone's NCHW.  ``draws`` (see ``draw_rsp_v1``)
    injects the warp matrices, photometric params and noise; they are drawn
    from ``gen`` when None, and the Philox seeds always are.  ``order``
    (B,) reorders each triplet by ``RSP_PERMUTATIONS[order[b]]`` before the
    augmentation (the draws stay with the output slots); None keeps the
    tiles in the given order.  ``shard``: see the module docstring; the
    seeds too are the global batch's.  In fused mode CUDA tensors run the
    fused kernel, CPU tensors its plain version.
    """
    if mode not in AUG_MODES:
        raise ValueError(f"unknown aug mode {mode!r}")
    b, t, h, _, _ = triplets_u8.shape
    offset, total = _shard(shard, b)
    a, e = offset * t, (offset + b) * t
    if mode == "exact":
        if draws is None:
            draws = RA.draw_pretrain_v1(gen, total, h, host_gen=host_gen, tiles=t)
        draws = take_rows(take_rows(draws, offset, offset + b, ("order",)), a, e, ("params", "noise"))
        return _finish(RA.pretrain_augment_v1(_planar_tiles(triplets_u8, order), draws), b, mean, std, out_dtype)
    if draws is None:
        draws = draw_rsp_v1(gen, total * t, h)
    draws = take_rows(draws, a, e, ("geo", "params", "noise"))
    seeds = PK.draw_seeds(gen, total * t)[a:e]
    if triplets_u8.is_cuda:
        fn = RK.rsp_augment_cuda
        if order is not None:
            order = order.to(torch.int32).contiguous()
    elif triplets_u8.device.type == "cpu":
        fn = RK.rsp_augment_plain
    else:
        raise ValueError(f"no v1 augmentation for device {triplets_u8.device}")
    return fn(triplets_u8, draws["geo"], draws["params"], seeds, draws["noise"], mean, std, out_dtype,
              order=order, tile0=a)


def augment_rsp_batch_v2(gen: torch.Generator, triplets_u8: torch.Tensor, n: int = 2, m: float = 3.0,
                         mode: str = "fused", draws: Optional[dict] = None, mean=DEFAULT_MEAN, std=DEFAULT_STD,
                         out_dtype: torch.dtype = torch.float32,
                         order: Optional[torch.Tensor] = None,
                         shard: "Tuple[int, int] | None" = None) -> torch.Tensor:
    """v2 RSP pretraining augmentation, RandAugment(n, m) drawn per tile,
    clipped and normalized (``batch.py:83-102``): mode 'fused', the
    composed policy (``fused.randaugment_v2_fused``); 'fast' and 'masked',
    its masked form, each op once in pool order; 'exact', op by op
    (``RA.randaugment_v2``).  (B, T, H, W, 3) uint8 triplets, reordered by
    ``order`` first as in ``augment_rsp_batch_v1`` (the draws stay with the
    output slots), -> (B, T, 3, H, W) in ``out_dtype``.  ``draws`` (see
    ``RA.draw_v2``) injects the draws; they are drawn from ``gen``, a CPU
    generator, when None; ``shard``: see the module docstring.  PyTorch
    ops on any device."""
    if mode not in AUG_MODES:
        raise ValueError(f"unknown aug mode {mode!r}")
    b, t = triplets_u8.shape[:2]
    offset, total = _shard(shard, b)
    if draws is None:
        draws = RA.draw_v2(gen, total * t, n, m, masked=mode in ("fast", "masked"))
    draws = take_rows(draws, offset * t, (offset + b) * t, ("ops", "present", "vals", "params"))
    pool = RA.randaugment_v2 if mode == "exact" else fused.randaugment_v2_fused
    return _finish(pool(_planar_tiles(triplets_u8, order), draws), b, mean, std, out_dtype)


# The third view is resized to (S + 20)^2 and cropped back to S^2
# (``batch.py:121-122``).
THREE_VIEW_PAD = 20


def draw_3view(gen: torch.Generator, b: int, size: int) -> dict:
    """Per-image draws of the fine-tune 3-view stack (``batch.py:110-124``)
    for ``b`` images of ``size``^2: ``angles`` (b, 2) in [-90, 90) and
    ``rotate`` (b, 2) coins at p = 0.5 for views 2 and 3, ``crop`` (b, 2)
    offsets (y0, x0) into the (size + 20)^2 third view, and ``perm`` (b, 3),
    a permutation of the three views."""
    dev = gen.device
    resized = size + THREE_VIEW_PAD
    return {
        "angles": -90.0 + 180.0 * torch.rand(b, 2, generator=gen, device=dev),
        "rotate": torch.rand(b, 2, generator=gen, device=dev) < 0.5,
        "crop": torch.randint(0, resized - size + 1, (b, 2), generator=gen, device=dev),
        "perm": torch.argsort(torch.rand(b, 3, generator=gen, device=dev), dim=1),
    }


def augment_3view_batch(gen: torch.Generator, imgs_u8: torch.Tensor,
                        draws: Optional[dict] = None, shard: "Tuple[int, int] | None" = None) -> torch.Tensor:
    """The supervised fine-tune 3-view stack (``batch.py:105-133``):
    [identity, rotated, rotated + resized to (S+20)^2 + cropped to S^2] per
    image, each rotation applied at p = 0.5 with reflect-101 borders, the
    three views shuffled per image and clipped to [0, 1].

    imgs_u8: (B, H, W, 3) uint8 with H == W.  Returns (B, 3, 3, H, W)
    float32, channel-planar.  ``draws`` (see ``draw_3view``) injects the
    angles, coins, crop offsets and permutations; they are drawn from
    ``gen`` when None; ``shard``: see the module docstring.  Framework ops
    on any device: the JAX package runs this with XLA ops too, no Pallas
    kernel."""
    b, s = imgs_u8.shape[0], imgs_u8.shape[1]
    offset, total = _shard(shard, b)
    if draws is None:
        draws = draw_3view(gen, total, s)
    draws = take_rows(draws, offset, offset + b, ("angles", "rotate", "crop", "perm"))
    dev = imgs_u8.device
    d = {k: v.to(dev) for k, v in draws.items()}
    v1 = to_float(imgs_u8).permute(0, 3, 1, 2)

    def rot(j):
        mats = geometry.rotation_matrix(d["angles"][:, j], s, s)
        out = geometry.warp_affine_planar(v1, mats, pad_mode="reflect101")
        return torch.where(d["rotate"][:, j].view(b, 1, 1, 1), out, v1)

    v3 = geometry.resize(rot(1), s + THREE_VIEW_PAD, s + THREE_VIEW_PAD)
    v3 = geometry.random_crop(v3, d["crop"][:, 0], d["crop"][:, 1], s, s)
    views = torch.stack([v1, rot(0), v3], 1)
    perm = d["perm"].long().view(b, 3, 1, 1, 1).expand_as(views)
    return torch.clamp(torch.gather(views, 1, perm), 0.0, 1.0)


def draw_transform_fix(gen: torch.Generator, b: int, size: int, n: int = 7, m: int = 10,
                       host_gen: Optional[torch.Generator] = None, mode: str = "fused") -> dict:
    """Per-image draws of the consistency views (``batch.py:136-160``) for
    ``b`` images of ``size``^2 with ``n`` strong stages at magnitudes in
    [1, m):

      weak_flip, strong_flip  (b,) bool, the p = 0.5 mirror coins
      ops                     (b, n) int64 op index in [0, 9) per stage
                              (``ops.randaugment.V1_POOL`` order); 'fast':
                              one row drawn for the whole batch; 'masked':
                              (b, 9), the pool in order
      present                 'masked' only: (b, 9) bool, the ops among the
                              image's n draws with replacement
      mags                    int64 magnitude in [1, m), one per entry of ops
      params                  (..., N_PARAMS) float32, each entry's op's
                              parameters and gate (``draw_v1_params``)
      noise                   (K, 3, size, size) float32 standard normal, one
                              field per (image, stage) pair whose op is noise
                              (and present), in row-major (image, stage) order

    'fused' and 'exact' draw alike, as they do in the JAX package.

    Which generator draws what: the small tables (coins, ops, magnitudes,
    params) come from ``host_gen``, a CPU generator, so that the op groups
    of ``fused.randaugment_v1_fused`` are known on the host without a copy
    back from the device; the noise fields come from ``gen`` on its device.
    ``host_gen`` None draws everything from ``gen``, which must then be a CPU
    generator."""
    tg = gen if host_gen is None else host_gen
    if tg.device.type != "cpu":
        raise ValueError("draw_transform_fix draws its tables on the host: pass a CPU host_gen")
    k = len(RA.V1_POOL)
    out = {}
    if mode == "fast":
        ops = torch.randint(0, k, (n,), generator=tg).expand(b, n).clone()
    elif mode == "masked":
        drawn = torch.randint(0, k, (b, n), generator=tg)
        out["present"] = (drawn.unsqueeze(-1) == torch.arange(k)).any(1)
        ops = torch.arange(k).expand(b, k).clone()
    elif mode in AUG_MODES:
        ops = torch.randint(0, k, (b, n), generator=tg)
    else:
        raise ValueError(f"unknown aug mode {mode!r}")
    mags = torch.randint(1, m, ops.shape, generator=tg)
    has_noise = (ops == RA.NOISE) & out.get("present", True)
    out.update({
        "weak_flip": torch.rand(b, generator=tg) < 0.5,
        "strong_flip": torch.rand(b, generator=tg) < 0.5,
        "ops": ops,
        "mags": mags,
        "params": RA.draw_v1_params(tg, ops, mags),
        "noise": torch.randn(int(has_noise.sum()), 3, size, size, generator=gen, device=gen.device),
    })
    return out


def transform_fix_batch(gen: torch.Generator, imgs_u8: torch.Tensor, n: int = 7, m: int = 10,
                        mode: str = "fused", draws: Optional[dict] = None,
                        host_gen: Optional[torch.Generator] = None,
                        shard: "Tuple[int, int] | None" = None):
    """Weak and strong views for consistency training (``batch.py:136-160``):
    (B, H, W, 3) uint8 with H == W -> (weak, strong), each float32
    channel-planar (B, 3, H, W) clipped to [0, 1], on the device of
    ``imgs_u8``.  ``draws`` (see ``draw_transform_fix``) injects the draws;
    they are drawn from ``gen`` and ``host_gen`` for ``mode`` when None;
    ``shard``: see the module docstring (the noise fields kept are those of
    the rows' noise stages).  The strong pool by mode: 'fused', 'fast' and 'masked' composed
    (``fused.randaugment_v1_fused``, their laws differ in the draws),
    'exact' op by op (``RA.randaugment_v1``).  PyTorch ops on any device,
    as the JAX package uses XLA ops: no Pallas kernel."""
    if mode not in AUG_MODES:
        raise ValueError(f"unknown aug mode {mode!r}")
    b, s = imgs_u8.shape[0], imgs_u8.shape[1]
    offset, total = _shard(shard, b)
    if draws is None:
        draws = draw_transform_fix(gen, total, s, n, m, host_gen=host_gen, mode=mode)
    if (offset, total) != (0, b):
        # the fields are numbered in row-major (image, stage) order
        owners = ((draws["ops"] == RA.NOISE) & draws.get("present", True)).sum(1)
        k0 = int(owners[:offset].sum())
        draws = take_rows(draws, k0, k0 + int(owners[offset:offset + b].sum()), ("noise",))
        draws = take_rows(draws, offset, offset + b,
                          ("weak_flip", "strong_flip", "ops", "present", "mags", "params"))
    imgs = to_float(imgs_u8.permute(0, 3, 1, 2).contiguous())
    pool = RA.randaugment_v1 if mode == "exact" else fused.randaugment_v1_fused
    weak, strong = fused.transform_fix_fused(imgs, draws, pool)
    return torch.clamp(weak, 0.0, 1.0), torch.clamp(strong, 0.0, 1.0)


def normalize_batch(imgs: torch.Tensor, mean=DEFAULT_MEAN, std=DEFAULT_STD,
                    channel_axis: int = -1) -> torch.Tensor:
    """(x - mean) / std along ``channel_axis`` (``batch.py:163-173``)."""
    shape = [1] * imgs.ndim
    shape[channel_axis] = len(mean)
    mean_t = torch.as_tensor(mean, dtype=torch.float32, device=imgs.device).view(shape)
    std_t = torch.as_tensor(std, dtype=torch.float32, device=imgs.device).view(shape)
    return (imgs - mean_t) / std_t
