"""The packed per-image stage table of the consistency views' CUDA kernel
(``ops/strong_views_kernel.py``), on the CPU: a plain reading of it, each
image's stages walked from its row in order with the pool's PyTorch ops,
equals the composed strong pool (``fused.randaugment_v1_fused`` through
``transform_fix_batch``) under fused, fast and masked; the kernel's launch
plan; the wrapper's refusals that need no card.  The kernel itself is held
to the plain version on the card (``tests/test_torch_cuda_kernels.py``)."""

import numpy as np
import pytest
import torch

from ssl_cr_histo_tpu_torch.ops import batch as TB
from ssl_cr_histo_tpu_torch.ops import geometry as TG
from ssl_cr_histo_tpu_torch.ops import randaugment as RA
from ssl_cr_histo_tpu_torch.ops import strong_views_kernel as SV


def views_from_table(imgs_u8: torch.Tensor, table: torch.Tensor, noise: torch.Tensor) -> tuple:
    """The kernel's function read plainly from its table: per image, the
    weak view mirrored by column 0; the strong view mirrored by column 1,
    then each active stage's op on the image alone, in stage order, then the
    reflect-101 warp by columns 2-10; both clipped."""
    b = imgs_u8.shape[0]
    n = (table.shape[1] - SV.TABLE_HEAD) // SV.STAGE_WIDTH
    imgs = TB.to_float(imgs_u8.permute(0, 3, 1, 2).contiguous())
    weak, strong = [], []
    for i in range(b):
        row, x = table[i], imgs[i:i + 1]
        weak.append(TG.flip_horizontal(x) if row[0] > 0.5 else x)
        x = TG.flip_horizontal(x) if row[1] > 0.5 else x
        for stage in row[SV.TABLE_HEAD:].view(n, SV.STAGE_WIDTH):
            op, active, params, slot = int(stage[0]), stage[1] > 0.5, stage[2:-1], int(stage[-1])
            if active:
                nz = noise[slot:slot + 1] if op == RA.NOISE else None
                x = RA.apply_photometric(op, x, params.view(1, -1), nz)
        strong.append(TG.warp_affine_planar(x, row[2:SV.TABLE_HEAD].view(1, 3, 3), pad_mode="reflect101"))
    return torch.clamp(torch.cat(weak), 0.0, 1.0), torch.clamp(torch.cat(strong), 0.0, 1.0)


def _draws(mode: str, b: int, s: int, seed: int, all_on: bool) -> dict:
    """``draw_transform_fix``'s draws; with ``all_on`` every gate on and
    images 0-2 given two blurs in a row and several noise stages."""
    g = torch.Generator().manual_seed(seed)
    d = TB.draw_transform_fix(g, b, s, mode=mode)
    if all_on:
        if mode != "masked":
            ops = d["ops"]
            blur = RA.V1_POOL.index("blur")
            ops[:3, :2] = blur
            ops[:3, 2:5] = RA.NOISE
            if mode == "fast":
                ops[:] = ops[0]
            d["params"] = RA.draw_v1_params(g, ops, d["mags"])
        d["params"][..., RA.GATE] = 1.0
        has_noise = (d["ops"] == RA.NOISE) & d.get("present", True)
        d["noise"] = torch.randn(int(has_noise.sum()), 3, s, s, generator=g)
    return d


@pytest.mark.parametrize("all_on", [False, True], ids=["drawn", "all-on"])
@pytest.mark.parametrize("mode", ["fused", "fast", "masked"])
def test_plain_reading_of_the_table_equals_the_composed_pool(mode, all_on):
    b, s = 9, 21
    d = _draws(mode, b, s, 3, all_on)
    imgs = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (b, s, s, 3), dtype=np.uint8))
    table = SV.pack_table(d, s)
    n = d["ops"].shape[1]
    assert table.dtype == torch.float32 and table.shape == (b, SV.TABLE_HEAD + SV.STAGE_WIDTH * n)
    stages = table[:, SV.TABLE_HEAD:].view(b, n, SV.STAGE_WIDTH)
    assert torch.equal(stages[..., 0].long(), d["ops"])
    noise_slots = stages[..., -1][stages[..., -1] >= 0]
    assert torch.equal(noise_slots, torch.arange(len(d["noise"]), dtype=torch.float32))
    if all_on:
        assert int(stages[..., 1].sum()) == int(sum(((d["ops"] == op) & d.get("present", True)).sum()
                                                    for op in RA.PHOTOMETRIC))
    want = TB.transform_fix_batch(None, imgs, n, mode=mode, draws=d)
    got = views_from_table(imgs, table, d["noise"])
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("s, plan", [(256, (8, 32, 112320)), (224, (8, 28, 87552)), (37, (8, 5, 4428)),
                                     (3, (3, 1, 420)), (1, (1, 1, 300))])
def test_launch_plan(s, plan):
    """A cluster of up to 8 CTAs an image, each with at least one row;
    3 planes of (rows + 4) rows of (s + 4) float32 a CTA."""
    assert SV.launch_plan(s, s, 7) == plan
    cluster, rows, _ = plan
    assert (cluster - 1) * rows < s <= cluster * rows


@pytest.mark.parametrize("h, w, n", [(16, 260, 7), (32, 31, 7), (64, 64, 33)])
def test_launch_plan_refuses(h, w, n):
    with pytest.raises(ValueError, match="strong views kernel"):
        SV.launch_plan(h, w, n)


def test_wrapper_refuses_cpu_images_and_cpu_views_launch_nothing():
    d = _draws("fused", 2, 8, 5, False)
    imgs = torch.zeros(2, 8, 8, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        SV.strong_views_cuda(imgs, SV.pack_table(d, 8), d["noise"])
    before = SV.launches
    TB.transform_fix_batch(None, imgs, draws=d)
    assert SV.launches == before
