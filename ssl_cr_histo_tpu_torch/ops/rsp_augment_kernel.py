"""The whole v1 pretraining augmentation in one hand-written CUDA kernel for
Hopper, and its plain PyTorch version.

Counterpart of the JAX package's fused + Pallas augmentation
(``ssl_cr_histo_tpu/ops/batch.py:59-74``): uint8 triplets -> float ->
composed affine warp with reflect101 borders (``geometry.py:339``) -> the
photometric chain (``pallas_photometric.py``) -> clip -> normalize, here
with the cast to the step's compute type at the end.

``rsp_augment_cuda`` launches ``csrc/rsp_augment.cu`` on CUDA tensors and
raises on anything else; ``rsp_augment_plain`` is the same function as the
composition of the port's plain pieces (``fused.pretrain_geo_warp_planar``,
``photometric_kernel.reference_chain``).  Both read the warp plan from
``geometry.warp_pass_coefficients`` and the noise from ``noise`` or, when
it is None, from the Philox stream of ``photometric_kernel.philox_normal``.
"""

from __future__ import annotations

import ctypes

import torch

from ssl_cr_histo_tpu_torch.ops import fused, geometry
from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK

# Kernel launches made by ``rsp_augment_cuda`` (incremented only where the
# CUDA kernel is launched).
launches = 0

OUT_DTYPES = (torch.float32, torch.bfloat16)
_HED_FLAT = tuple(PK._hed_mats())


def rsp_augment_plain(triplets_u8: torch.Tensor, mats: torch.Tensor, params: torch.Tensor,
                      seeds: torch.Tensor, noise: "torch.Tensor | None", mean, std,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device.

    triplets_u8: (B, 3, S, S, 3) uint8; mats: (N, 3, 3) inverse maps;
    params: (N, N_PARAMS); seeds: (N,) int32; noise: (N, 3, S, S) standard
    normal or None (Philox noise from ``seeds``), with N = 3 B.  Returns
    (B, 3, 3, S, S) planar in ``out_dtype``.
    """
    from ssl_cr_histo_tpu_torch.ops import batch

    b, t, h, w, _ = triplets_u8.shape
    imgs = batch.to_float(triplets_u8.reshape(b * t, h, w, 3).permute(0, 3, 1, 2)).contiguous()
    warped = fused.pretrain_geo_warp_planar(imgs, mats)
    if noise is None:
        noise = PK.philox_normal(seeds, warped.shape)
    out = torch.clamp(PK.reference_chain(warped, params, noise), 0.0, 1.0)
    out = batch.normalize_batch(out, mean, std, channel_axis=1)
    return out.to(out_dtype).reshape(b, t, 3, h, w)


def _library():
    from ssl_cr_histo_tpu_torch.csrc import build

    fn = build.load_library("rsp_augment").launch_rsp_augment
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return fn


def rsp_augment_cuda(triplets_u8: torch.Tensor, mats: torch.Tensor, params: torch.Tensor,
                     seeds: torch.Tensor, noise: "torch.Tensor | None", mean, std,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the fused kernel on CUDA tensors; arguments and result as
    ``rsp_augment_plain``'s.  The tiles must be square and contiguous."""
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
    fn = _library()
    coefs = geometry.warp_pass_coefficients(mats, h).contiguous()
    out = torch.empty((b, t, 3, h, w), dtype=out_dtype, device=dev)
    consts = (ctypes.c_float * 24)(*_HED_FLAT, *(float(v) for v in mean), *(float(v) for v in std))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(triplets_u8.data_ptr(), coefs.data_ptr(), 0 if noise is None else noise.data_ptr(),
                seeds.data_ptr(), params.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
                n, h, ctypes.addressof(consts), stream)
    if rc != 0:
        raise RuntimeError(f"rsp_augment kernel launch failed: CUDA error {rc}")
    launches += 1
    return out

