"""The whole v1 pretraining augmentation in one hand-written CUDA kernel for
Hopper, and its plain PyTorch version.

Counterpart of the JAX package's triplet permutation
(``ssl_cr_histo_tpu/parallel/steps.py:51``) followed by its fused + Pallas
augmentation (``ssl_cr_histo_tpu/ops/batch.py:59-74``): uint8 triplets ->
ordering -> float -> composed affine warp with reflect101 borders
(``geometry.py:339``) -> the photometric chain (``pallas_photometric.py``)
-> clip -> normalize, here with the cast to the step's compute type at the
end.

``rsp_augment_cuda`` launches ``csrc/rsp_augment.cu`` on CUDA tensors and
raises on anything else; the kernel computes each tile's warp plan itself,
bit-identical to ``geometry.warp_pass_coefficients``.  ``rsp_augment_plain``
is the same function as the composition of the port's plain pieces
(``permute_triplets`` below, ``fused.pretrain_geo_warp_planar``,
``photometric_kernel.reference_chain``).  Both draw the noise from ``noise``
or, when it is None, from the Philox stream of
``photometric_kernel.philox_normal``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ssl_cr_histo_tpu_torch.ops import fused
from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK

# Kernel launches made by ``rsp_augment_cuda`` (incremented only where the
# CUDA kernel is launched).
launches = 0

OUT_DTYPES = (torch.float32, torch.bfloat16)
PLAN_WIDTH = 8  # warp_pass_coefficients' row
_HED_FLAT = tuple(PK._hed_mats())

# The 6 resolution-sequence orderings and their class labels (reference
# dataset.py:36-38: tuple order is [HR, LR1, LR2]).  Copied from
# ssl_cr_histo_tpu/parallel/steps.py:37-40, which imports jax.  The kernel
# takes them as constants and reads output slot (b, t) from tile
# (b, RSP_PERMUTATIONS[order[b]][t]).
RSP_PERMUTATIONS = np.array(
    [[0, 1, 2], [0, 2, 1], [1, 2, 0], [1, 0, 2], [2, 0, 1], [2, 1, 0]],
    dtype=np.int32,
)


def permute_triplets(tiles: torch.Tensor, perm_idx: torch.Tensor) -> torch.Tensor:
    """Reorder each triplet (dim 1) by its ordering index (``steps.py:51-54``)."""
    perms = torch.as_tensor(RSP_PERMUTATIONS, device=tiles.device).long()[perm_idx.long()]
    index = perms.view(perms.shape[0], 3, *([1] * (tiles.dim() - 2)))
    return torch.take_along_dim(tiles, index, dim=1)


def rsp_augment_plain(triplets_u8: torch.Tensor, mats: torch.Tensor, params: torch.Tensor,
                      seeds: torch.Tensor, noise: "torch.Tensor | None", mean, std,
                      out_dtype: torch.dtype = torch.float32,
                      order: "torch.Tensor | None" = None, tile0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device.

    triplets_u8: (B, 3, S, S, 3) uint8 in the sampler's order; mats: (N, 3, 3)
    inverse maps; params: (N, N_PARAMS); seeds: (N,) int32; noise: (N, 3, S,
    S) standard normal or None (Philox noise from ``seeds``), with N = 3 B;
    order: (B,) ordering indices in [0, 6) (``RSP_PERMUTATIONS`` rows) or
    None for the tiles as given.  Output slot (b, t) augments tile
    ``(b, PERM[order[b]][t])`` with slot 3 b + t's draws.  ``tile0``: the
    index of tile 0 in the global batch these rows belong to, which the
    Philox noise's counter adds to each tile's index.  Returns (B, 3, 3, S,
    S) planar in ``out_dtype``.
    """
    from ssl_cr_histo_tpu_torch.ops import batch

    b, t, h, w, _ = triplets_u8.shape
    if order is not None:
        if tuple(order.shape) != (b,):
            raise ValueError(f"order has shape {tuple(order.shape)}, expected ({b},)")
        if bool(((order < 0) | (order >= len(RSP_PERMUTATIONS))).any()):
            raise ValueError(f"order holds values outside [0, {len(RSP_PERMUTATIONS)})")
        triplets_u8 = permute_triplets(triplets_u8, order)
    imgs = batch.to_float(triplets_u8.reshape(b * t, h, w, 3).permute(0, 3, 1, 2)).contiguous()
    warped = fused.pretrain_geo_warp_planar(imgs, mats)
    if noise is None:
        noise = PK.philox_normal(seeds, warped.shape, tile0)
    out = torch.clamp(PK.reference_chain(warped, params, noise), 0.0, 1.0)
    out = batch.normalize_batch(out, mean, std, channel_axis=1)
    return out.to(out_dtype).reshape(b, t, 3, h, w)


def _library():
    from ssl_cr_histo_tpu_torch.csrc import build

    fn = build.load_library("rsp_augment").launch_rsp_augment
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=8)
def _host_consts(mean: tuple, std: tuple):
    """The kernel's host-side constants: the HED matrices, mean and std (24
    float32), and the six orderings (18 int32)."""
    consts = (ctypes.c_float * 24)(*_HED_FLAT, *mean, *std)
    perms = (ctypes.c_int32 * 18)(*(int(v) for v in RSP_PERMUTATIONS.reshape(-1)))
    return consts, perms


def rsp_augment_cuda(triplets_u8: torch.Tensor, mats: torch.Tensor, params: torch.Tensor,
                     seeds: torch.Tensor, noise: "torch.Tensor | None", mean, std,
                     out_dtype: torch.dtype = torch.float32, order: "torch.Tensor | None" = None,
                     plan_out: "torch.Tensor | None" = None, tile0: int = 0) -> torch.Tensor:
    """Launch the fused kernel on CUDA tensors; arguments and result as
    ``rsp_augment_plain``'s, with ``order`` (B,) int32 in [0, 6).  The range
    of ``order`` is not checked here, since that would wait on the card: a
    value outside it reads its triplet in the given order, where the plain
    version raises (``pretrain_step`` checks the labels a caller passes it).
    The tiles must be square and every tensor contiguous.  ``plan_out``, an (N, 8)
    float32 tensor, receives the warp plan the kernel computed for each tile
    (``geometry.warp_pass_coefficients``' rows)."""
    global launches
    if not triplets_u8.is_cuda:
        raise ValueError("rsp_augment_cuda needs CUDA tensors")
    if triplets_u8.dim() != 5 or triplets_u8.shape[1] != 3 or triplets_u8.shape[4] != 3:
        raise ValueError(f"expected (B, 3, S, S, 3) triplets, got {tuple(triplets_u8.shape)}")
    b, t, h, w, _ = triplets_u8.shape
    if h != w:
        raise ValueError(f"rsp_augment_cuda requires square tiles, got {h}x{w}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {OUT_DTYPES}, got {out_dtype}")
    if len(mean) != 3 or len(std) != 3:
        raise ValueError("mean and std take one value per channel")
    n, dev = b * t, triplets_u8.device
    PK._check(triplets_u8, "triplets_u8", torch.uint8, triplets_u8.shape, dev)
    PK._check(mats, "mats", torch.float32, (n, 3, 3), dev)
    PK._check(params, "params", torch.float32, (n, PK.N_PARAMS), dev)
    PK._check(seeds, "seeds", torch.int32, (n,), dev)
    if noise is not None:
        PK._check(noise, "noise", torch.float32, (n, 3, h, w), dev)
    if order is not None:
        PK._check(order, "order", torch.int32, (b,), dev)
    if plan_out is not None:
        PK._check(plan_out, "plan_out", torch.float32, (n, PLAN_WIDTH), dev)
    fn = _library()
    out = torch.empty((b, t, 3, h, w), dtype=out_dtype, device=dev)
    consts, perms = _host_consts(tuple(float(v) for v in mean), tuple(float(v) for v in std))
    ptr = lambda x: 0 if x is None else x.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(triplets_u8.data_ptr(), mats.data_ptr(), ptr(order), ptr(noise), seeds.data_ptr(),
                params.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16), n, h, int(tile0),
                ctypes.addressof(consts), ctypes.addressof(perms), ptr(plan_out), stream)
    if rc != 0:
        raise RuntimeError(f"rsp_augment kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
