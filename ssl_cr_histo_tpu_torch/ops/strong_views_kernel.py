"""The consistency step's weak and strong views in one hand-written CUDA
kernel for Hopper (``csrc/strong_views.cu``): uint8 images in, each image's
photometric stages of the composed v1 strong pool in its drawn order, one
reflect-101 two-pass warp by its composed map, weak and strong out.

No TPU kernel stands behind it: the JAX package computes these views with
XLA ops (``ssl_cr_histo_tpu/ops/batch.py::transform_fix_batch``).  The plain
version is ``ops/fused.py::transform_fix_fused`` with
``randaugment_v1_fused`` on the same draws; ``ops.batch.transform_fix_batch``
runs it on CPU tensors and this kernel on CUDA tensors, under ``fused``,
``fast`` and ``masked`` alike, since the three modes differ only in their
draws, which the table carries.

The draws are ``ops.batch.draw_transform_fix``'s, unchanged: the tables from
the host generator, the noise fields from the device's, the composed maps
from ``fused.strong_pool_matrix`` on the host.  ``pack_table`` packs an
image's share of them into one float32 row, so one copy from pinned memory
takes them all to the card:

    [0]       weak_flip (0 or 1)
    [1]       strong_flip
    [2:11]    the composed 3x3 inverse map, row-major
    then for each of the n stages, STAGE_WIDTH floats:
      op      the stage's index in ``RA.V1_POOL``
      active  1 where the stage runs: a photometric op, its gate on and, under
              ``masked``, present
      params  its ``RA.N_PARAMS`` parameters
      slot    its noise field's index in ``draws['noise']`` where its op is
              noise (and present), else -1
"""

from __future__ import annotations

import ctypes

import torch

from ssl_cr_histo_tpu_torch.ops import fused
from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK
from ssl_cr_histo_tpu_torch.ops import randaugment as RA

# Kernel launches made by ``strong_views_cuda`` (incremented only where the
# CUDA kernel is launched).
launches = 0

TABLE_HEAD = 11
STAGE_WIDTH = 3 + RA.N_PARAMS
PLAN_WIDTH = 8  # warp_pass_coefficients' row

# The kernel's limits (csrc/strong_views.cu): a cluster of at most 8 CTAs an
# image, rows of at most 256 pixels, at most 32 stages, blur half-widths up
# to 2 kept as halo rows and columns, and 227 KB of shared memory a CTA less
# 4 KB for its static part.
MAX_CLUSTER = 8
MAX_WIDTH = 256
MAX_STAGES = 32
MAX_HALF = RA.V1_MAX_BLUR // 2
MAX_SMEM = 232448 - 4096


def pack_table(draws: dict, s: int) -> torch.Tensor:
    """(b, TABLE_HEAD + STAGE_WIDTH n) float32 host table of the draws of
    ``ops.batch.draw_transform_fix`` for b images of ``s``^2 with n stages
    (layout: the module docstring).  ``active`` and ``slot`` come from
    ``RA.v1_active_stages`` and ``RA.noise_slots``, as the groups of
    ``fused.randaugment_v1_fused`` do."""
    ops, params = draws["ops"].cpu(), draws["params"].cpu().float()
    b, n = ops.shape
    present, active, owner = RA.v1_active_stages(draws, ops, params)
    stages = torch.cat([ops.unsqueeze(-1).float(), active.unsqueeze(-1).float(), params,
                        RA.noise_slots(owner).unsqueeze(-1).float()], -1)
    flips = [draws[k].cpu().float().view(b, 1) for k in ("weak_flip", "strong_flip")]
    g = fused.strong_pool_matrix(ops, params, s, present).reshape(b, 9)
    return torch.cat([*flips, g, stages.reshape(b, n * STAGE_WIDTH)], 1).contiguous()


def launch_plan(h: int, w: int, n_stages: int) -> tuple:
    """The kernel's launch for (h, w) images with ``n_stages`` stages:
    (cluster, rows, smem).  A cluster of ``cluster`` CTAs covers an image,
    CTA q owning rows [q rows, q rows + rows), each holding its rows' three
    float32 planes with MAX_HALF halo rows above and below and MAX_HALF halo
    columns on each side in ``smem`` bytes; every CTA owns at least one row.
    Raises ValueError, naming the shape, for images the kernel does not
    take."""
    if h != w or w < 1 or w > MAX_WIDTH:
        raise ValueError(f"the strong views kernel takes square images of 1 to {MAX_WIDTH} pixels a row, "
                         f"not ({h}, {w}, 3)")
    if not 0 <= n_stages <= MAX_STAGES:
        raise ValueError(f"the strong views kernel takes at most {MAX_STAGES} stages, not {n_stages}")
    cluster = min(MAX_CLUSTER, h)
    rows = -(-h // cluster)
    cluster = -(-h // rows)
    smem = 3 * (rows + 2 * MAX_HALF) * (w + 2 * MAX_HALF) * 4
    if smem > MAX_SMEM:
        raise ValueError(f"the strong views kernel cannot take ({h}, {w}, 3) images: {rows} rows a CTA need "
                         f"{smem} bytes of shared memory, more than {MAX_SMEM}")
    return cluster, rows, smem


def _library():
    from ssl_cr_histo_tpu_torch.csrc import build

    fn = build.load_library("strong_views").launch_strong_views
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return fn


def strong_views_cuda(imgs_u8: torch.Tensor, table: torch.Tensor, noise: torch.Tensor,
                      plan_out: "torch.Tensor | None" = None) -> tuple:
    """Launch the kernel: (b, S, S, 3) uint8 CUDA images, their (b, TABLE_HEAD
    + STAGE_WIDTH n) float32 host table (``pack_table``), copied to the card
    here in one non-blocking copy from pinned memory, and the (K, 3, S, S)
    float32 noise fields on the images' card -> (weak, strong), each (b, 3,
    S, S) float32 in [0, 1].  ``plan_out``, an (b, 8) float32 CUDA tensor,
    receives each image's warp plan (``geometry.warp_pass_coefficients``'
    rows).  Raises ValueError or TypeError for what the kernel does not take;
    nothing waits on the card."""
    global launches
    if not imgs_u8.is_cuda:
        raise ValueError("strong_views_cuda needs CUDA images")
    if imgs_u8.dim() != 4 or imgs_u8.shape[3] != 3:
        raise ValueError(f"expected (B, S, S, 3) images, got {tuple(imgs_u8.shape)}")
    b, h, w, _ = imgs_u8.shape
    dev = imgs_u8.device
    PK._check(imgs_u8, "imgs_u8", torch.uint8, imgs_u8.shape, dev)
    if table.dim() != 2 or (table.shape[1] - TABLE_HEAD) % STAGE_WIDTH:
        raise ValueError(f"table has shape {tuple(table.shape)}, expected (B, {TABLE_HEAD} + {STAGE_WIDTH} n)")
    n_stages = (table.shape[1] - TABLE_HEAD) // STAGE_WIDTH
    PK._check(table, "table", torch.float32, (b, table.shape[1]), torch.device("cpu"))
    k = noise.shape[0] if noise.dim() == 4 else -1
    PK._check(noise, "noise", torch.float32, (k, 3, h, w), dev)
    slots = table[:, TABLE_HEAD:].view(b, n_stages, STAGE_WIDTH)[..., -1]
    if n_stages and int(slots.max()) >= k:
        raise ValueError(f"the table's noise slots reach {int(slots.max())}, beyond the {k} fields given")
    if plan_out is not None:
        PK._check(plan_out, "plan_out", torch.float32, (b, PLAN_WIDTH), dev)
    plan = launch_plan(h, w, n_stages)
    fn = _library()
    table_d = RA.to_device(table, dev)
    weak = torch.empty((b, 3, h, w), dtype=torch.float32, device=dev)
    strong = torch.empty_like(weak)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(imgs_u8.data_ptr(), table_d.data_ptr(), n_stages, noise.data_ptr() if k else None,
                weak.data_ptr(), strong.data_ptr(), None if plan_out is None else plan_out.data_ptr(),
                b, h, *plan, ctypes.addressof(PK._HED_MATS), stream)
    if rc != 0:
        raise RuntimeError(f"strong_views kernel launch failed for images of shape {tuple(imgs_u8.shape)} "
                           f"(cluster, rows, smem {plan}): CUDA error {rc}")
    launches += 1
    return weak, strong
