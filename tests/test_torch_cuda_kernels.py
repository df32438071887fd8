"""The port's CUDA kernels against their plain PyTorch versions, on the GPU:
the photometric chain (``csrc/photometric_chain.cu``) and the fused v1
augmentation (``csrc/rsp_augment.cu``); and the consistency views and step
and the serving map, which launch no kernel, on the card against the CPU.

Every test here needs a card (marker ``cuda``) and skips where
``torch.cuda.is_available()`` is False.  The file imports nothing of JAX, so
that it runs on a GPU machine without JAX, bypassing tests/conftest.py (which
imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance 1e-4 absolute on outputs in [0, 1]: the kernel and PyTorch's CUDA
ops differ by a few ulp in log/exp/division (the special-function forms of
``csrc/photometric_common.cuh``, whose header states their error budget) and
in FMA contraction.  After a normalize by std the same bound reads 1e-4 / std.
A bf16 output is held to the plain float32 result cast to bf16: within one
bf16 ulp, or within 1e-4 where one ulp is smaller than that.
"""

import re

import numpy as np
import pytest
import torch

from ssl_cr_histo_tpu_torch.ops import batch as TB
from ssl_cr_histo_tpu_torch.ops import fused as TF
from ssl_cr_histo_tpu_torch.ops import geometry as TG
from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK
from ssl_cr_histo_tpu_torch.ops import rsp_augment_kernel as RK

GATES = (3, 5, 10, 13)  # hsv, noise, blur, brightness/contrast
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
IDENTITY = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _cases(device, seed):
    """One tile per case: params drawn with draw_params' law, then all
    gates off, all on, each gate alone, and the blur alone at k = 3, 5, 7."""
    rows = [(), GATES] + [(g,) for g in GATES] + [(10,)] * 3
    p = PK.draw_params(torch.Generator(device=device).manual_seed(seed), len(rows))
    p[:, list(GATES)] = 0.0
    for i, on in enumerate(rows):
        p[i, list(on)] = 1.0
    p[-3:, 9] = torch.tensor([3.0, 5.0, 7.0], device=device)
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(32, 32), (37, 37), (256, 256)])
def test_kernel_matches_plain_noise_input(cuda, hw):
    rng = np.random.default_rng(1)
    params = _cases(cuda, 1)
    n = params.shape[0]
    imgs = torch.from_numpy(rng.random((n, 3, *hw)).astype(np.float32)).to(cuda)
    noise = torch.from_numpy(rng.normal(size=(n, 3, *hw)).astype(np.float32)).to(cuda)
    seeds = torch.arange(n, dtype=torch.int32, device=cuda)
    before = PK.launches
    got = PK.photometric_chain_cuda(imgs, seeds, params, noise)
    assert PK.launches == before + 1
    want = PK.reference_chain(imgs, params, noise)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_kernel_prng_matches_plain_philox(cuda):
    rng = np.random.default_rng(2)
    params = _cases(cuda, 2)
    n = params.shape[0]
    imgs = torch.from_numpy(rng.random((n, 3, 40, 40)).astype(np.float32)).to(cuda)
    seeds = torch.arange(7, 7 + n, dtype=torch.int32, device=cuda)
    got = PK.photometric_chain_cuda(imgs, seeds, params)
    assert torch.equal(got, PK.photometric_chain_cuda(imgs, seeds, params))
    assert not torch.equal(got, PK.photometric_chain_cuda(imgs, seeds + 1, params))
    want = PK.reference_chain(imgs, params, PK.philox_normal(seeds, imgs.shape))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


# Tile shapes the chain kernel's launch covers unevenly: heights that are not
# a multiple of the rows a CTA owns (50 = 7 x 7 + 1, 13, 37) or that need
# fewer CTAs than a full cluster (3, 2, 1), rows that are not a multiple of 4
# pixels (20 is, 5 and 37 are not), and tiles smaller than the k = 7 blur's
# halo, where reflect101 folds more than once (3 x 3, 2 x 5, 1 x 1).
EDGE_SHAPES = [(50, 64), (13, 20), (37, 37), (9, 256), (224, 224), (3, 3), (2, 5), (1, 1)]


def _chain_case(device, hw, philox, seed, n=None):
    """Tiles, seeds, params (_cases, then drawn gates up to n tiles) and the
    noise (None in Philox mode) for one chain comparison."""
    rng = np.random.default_rng(seed)
    params = _cases(device, seed)
    if n is not None:
        extra = PK.draw_params(torch.Generator(device=device).manual_seed(seed), n - params.shape[0])
        params = torch.cat([params, extra])
    n = params.shape[0]
    imgs = torch.from_numpy(rng.random((n, 3, *hw)).astype(np.float32)).to(device)
    noise = None if philox else torch.from_numpy(rng.normal(size=(n, 3, *hw)).astype(np.float32)).to(device)
    seeds = torch.arange(seed, seed + n, dtype=torch.int32, device=device)
    return imgs, seeds, params, noise


def _chain_want(imgs, seeds, params, noise):
    return PK.reference_chain(imgs, params, PK.philox_normal(seeds, imgs.shape) if noise is None else noise)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", EDGE_SHAPES)
@pytest.mark.parametrize("philox", [False, True], ids=["host-noise", "philox"])
def test_chain_kernel_edges_match_plain(cuda, hw, philox):
    """All gates off, all on, each gate alone and the blur alone at k = 3, 5,
    7, in both noise modes, at shapes the launch covers unevenly; Philox mode
    bit-equal for equal seeds and different for other seeds."""
    imgs, seeds, params, noise = _chain_case(cuda, hw, philox, seed=hw[0] * 1000 + hw[1])
    got = PK.photometric_chain_cuda(imgs, seeds, params, noise)
    torch.testing.assert_close(got, _chain_want(imgs, seeds, params, noise), rtol=0, atol=1e-4)
    if philox:
        assert torch.equal(got, PK.photometric_chain_cuda(imgs, seeds.clone(), params))
        assert not torch.equal(got, PK.photometric_chain_cuda(imgs, seeds + 1, params))


@pytest.mark.cuda
@pytest.mark.parametrize("philox", [False, True], ids=["host-noise", "philox"])
def test_chain_kernel_partial_last_wave(cuda, philox):
    """One 256^2 tile more than the card runs clusters at once, so the last
    wave holds a single cluster."""
    n = PK.max_active_clusters(256, 256) + 1
    imgs, seeds, params, noise = _chain_case(cuda, (256, 256), philox, seed=11, n=n)
    got = PK.photometric_chain_cuda(imgs, seeds, params, noise)
    torch.testing.assert_close(got, _chain_want(imgs, seeds, params, noise), rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("philox", [False, True], ids=["host-noise", "philox"])
def test_chain_kernel_unaligned_tensors(cuda, philox):
    """Tiles 4 bytes past a 16-byte boundary (rows a multiple of 4 pixels):
    the kernel reads and writes them with scalar accesses, same numbers."""
    imgs, seeds, params, noise = _chain_case(cuda, (32, 32), philox, seed=5)
    shift = lambda t: torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
    imgs = shift(imgs)
    noise = None if noise is None else shift(noise)
    assert imgs.data_ptr() % 16 != 0
    got = PK.photometric_chain_cuda(imgs, seeds, params, noise)
    torch.testing.assert_close(got, _chain_want(imgs, seeds, params, noise), rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(16, 260), (1024, 256)])
def test_chain_wrapper_raises_for_shapes_the_launch_cannot_take(cuda, hw):
    """Rows wider than 256 pixels, or more rows a CTA than shared memory
    holds: ValueError naming the shape, and no launch."""
    imgs = torch.rand(1, 3, *hw, device=cuda)
    seeds = torch.zeros(1, dtype=torch.int32, device=cuda)
    params = torch.zeros(1, PK.N_PARAMS, device=cuda)
    before = PK.launches
    with pytest.raises(ValueError, match=re.escape(f"(3, {hw[0]}, {hw[1]})")):
        PK.photometric_chain_cuda(imgs, seeds, params)
    assert PK.launches == before


@pytest.mark.cuda
def test_wrapper_dispatches_cuda_tensors_to_the_kernel(cuda):
    imgs = torch.rand(2, 3, 16, 16, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = PK.launches
    out = PK.pretrain_photometric(imgs, gen)
    assert PK.launches == before + 1 and out.shape == imgs.shape and out.is_cuda


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda):
    imgs = torch.rand(2, 3, 16, 16, device=cuda)
    seeds = torch.zeros(2, dtype=torch.int32, device=cuda)
    params = torch.zeros(2, PK.N_PARAMS, device=cuda)
    with pytest.raises(TypeError):
        PK.photometric_chain_cuda(imgs.double(), seeds, params)
    with pytest.raises(ValueError):
        PK.photometric_chain_cuda(imgs.transpose(2, 3), seeds, params)
    with pytest.raises(ValueError):
        PK.photometric_chain_cuda(imgs, seeds[:1], params)
    with pytest.raises(ValueError):
        PK.photometric_chain_cuda(imgs, seeds.cpu(), params)


def _fused_inputs(device, s, seed):
    """Four triplets of s x s uint8 tiles; warp matrices with the
    pretraining law plus a rot90-and-transpose map; params as _cases, the
    remaining tiles with drawn gates."""
    rng = np.random.default_rng(seed)
    n = 12
    mats = TF.draw_pretrain_geo_matrices(torch.Generator().manual_seed(seed), n, s)
    mats[-1] = torch.tensor([[0.1, 0.6, 2.0], [1.4, 0.2, -1.0], [0.0, 0.0, 1.0]])
    params = PK.draw_params(torch.Generator().manual_seed(seed), n)
    params[:9] = _cases(torch.device("cpu"), seed)
    return {
        "tiles": torch.from_numpy(rng.integers(0, 256, (n // 3, 3, s, s, 3), dtype=np.uint8)).to(device),
        "mats": mats.to(device),
        "params": params.to(device),
        "seeds": torch.arange(3, 3 + n, dtype=torch.int32, device=device),
        "noise": torch.from_numpy(rng.normal(size=(n, 3, s, s)).astype(np.float32)).to(device),
    }


def _fused(fn, d, philox, norm, out_dtype):
    return fn(d["tiles"], d["mats"], d["params"], d["seeds"], None if philox else d["noise"],
              *norm, out_dtype)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values (8 significant bits) at |x|."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [32, 37, 256])
@pytest.mark.parametrize("philox", [False, True], ids=["host-noise", "philox"])
@pytest.mark.parametrize("norm", [IDENTITY, IMAGENET], ids=["identity", "imagenet"])
def test_fused_kernel_matches_plain(cuda, s, philox, norm):
    d = _fused_inputs(cuda, s, seed=s)
    before = RK.launches
    got = _fused(RK.rsp_augment_cuda, d, philox, norm, torch.float32)
    assert RK.launches == before + 1
    want = _fused(RK.rsp_augment_plain, d, philox, norm, torch.float32)
    assert got.shape == want.shape == (4, 3, 3, s, s) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 / min(norm[1]))

    got16 = _fused(RK.rsp_augment_cuda, d, philox, norm, torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    want16 = want.to(torch.bfloat16)
    err = (got16.float() - want16.float()).abs()
    assert (err <= torch.clamp_min(_bf16_ulp(want16), 1e-4 / min(norm[1]))).all(), err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("s", [32, 37, 256])
@pytest.mark.parametrize("philox", [False, True], ids=["host-noise", "philox"])
def test_fused_kernel_with_order_matches_plain(cuda, s, philox):
    """The kernel reads each output slot's tile through the ordering; the
    plain version permutes the uint8 triplets first.  Orderings cover all
    six permutations over the four triplets' slots (tiles 0-11)."""
    d = _fused_inputs(cuda, s, seed=s + 1)
    order = torch.tensor([1, 2, 4, 5], dtype=torch.int32, device=cuda)
    got = RK.rsp_augment_cuda(d["tiles"], d["mats"], d["params"], d["seeds"], None if philox else d["noise"],
                              *IMAGENET, torch.float32, order=order)
    want = RK.rsp_augment_plain(d["tiles"], d["mats"], d["params"], d["seeds"], None if philox else d["noise"],
                                *IMAGENET, torch.float32, order=order)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 / min(IMAGENET[1]))
    unordered = _fused(RK.rsp_augment_cuda, d, philox, IMAGENET, torch.float32)
    assert not torch.equal(got, unordered)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [37, 256])
def test_fused_kernel_plan_equals_warp_pass_coefficients(cuda, s):
    """The warp plan the kernel computes in each block's prologue, read
    through plan_out, equals warp_pass_coefficients on the same matrices
    (drawn with the pretraining law, plus the transpose fix-up alone and
    after the 90-degree one), on the card and on the CPU."""
    d = _fused_inputs(cuda, s, seed=5)
    d["mats"][-2] = torch.tensor([[1.4, 0.2, -3.0], [0.1, 0.7, 2.0], [0.0, 0.0, 1.0]], device=cuda)
    plan = torch.full((12, RK.PLAN_WIDTH), float("nan"), device=cuda)
    RK.rsp_augment_cuda(d["tiles"], d["mats"], d["params"], d["seeds"], None, *IDENTITY, torch.bfloat16,
                        plan_out=plan)
    for want in (TG.warp_pass_coefficients(d["mats"], s), TG.warp_pass_coefficients(d["mats"].cpu(), s)):
        assert torch.equal(plan.cpu(), want.cpu())
    assert plan[:, 6].any() and plan[:, 7].any() and not plan[:, 7].all()


@pytest.mark.cuda
def test_chain_philox_at_the_main_shape_is_finite(cuda):
    """Philox mode at (192, 3, 256, 256), noise gate on in every tile: no
    NaN or Inf (about two dozen uniforms fall within 2^-20 of 1, where the
    Box-Muller log is smallest), and within 1e-4 of the plain Philox chain."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    shape = (192, 3, 256, 256)
    imgs = torch.rand(shape, generator=gen, device=cuda)
    params = PK.draw_params(gen, shape[0])
    params[:, 5] = 1.0
    seeds = PK.draw_seeds(gen, shape[0])
    got = PK.photometric_chain_cuda(imgs, seeds, params)
    assert torch.isfinite(got).all()
    want = PK.reference_chain(imgs, params, PK.philox_normal(seeds, shape))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_fused_kernel_philox_is_deterministic(cuda):
    d = _fused_inputs(cuda, 64, seed=1)
    d["params"][:, 5] = 1.0
    a = _fused(RK.rsp_augment_cuda, d, True, IDENTITY, torch.float32)
    assert torch.equal(a, _fused(RK.rsp_augment_cuda, d, True, IDENTITY, torch.float32))
    d["seeds"] = d["seeds"] + 1
    assert not torch.equal(a, _fused(RK.rsp_augment_cuda, d, True, IDENTITY, torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("philox", [False, True], ids=["host-noise", "philox"])
def test_fused_kernel_rows_with_tile0_equal_the_whole_launch(cuda, philox):
    """A process's rows of a data-parallel batch: the kernel on triplets
    [r, r + 2) with their draws and ``tile0`` 3 r gives rows [r, r + 2) of
    the launch over all four triplets bit for bit (the Philox counter's
    tile word is tile0 + n), and agrees with the plain version given the
    same ``tile0``."""
    d = _fused_inputs(cuda, 64, seed=3)
    d["params"][:, 5] = 1.0
    order = torch.tensor([1, 2, 4, 5], dtype=torch.int32, device=cuda)
    noise = None if philox else d["noise"]
    whole = RK.rsp_augment_cuda(d["tiles"], d["mats"], d["params"], d["seeds"], noise, *IDENTITY, torch.float32,
                                order=order)
    for r in (0, 2):
        a, e = 3 * r, 3 * r + 6
        args = (d["tiles"][r:r + 2], d["mats"][a:e], d["params"][a:e], d["seeds"][a:e],
                None if philox else d["noise"][a:e], *IDENTITY, torch.float32)
        got = RK.rsp_augment_cuda(*args, order=order[r:r + 2], tile0=a)
        assert torch.equal(got, whole[r:r + 2])
        want = RK.rsp_augment_plain(*args, order=order[r:r + 2].long(), tile0=a)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_augment_dispatches_cuda_tensors_to_the_fused_kernel(cuda):
    tiles = torch.randint(0, 256, (2, 3, 64, 64, 3), dtype=torch.uint8, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    before, chain_before = RK.launches, PK.launches
    out = TB.augment_rsp_batch_v1(gen, tiles, out_dtype=torch.bfloat16)
    assert RK.launches == before + 1 and PK.launches == chain_before
    assert out.shape == (2, 3, 3, 64, 64) and out.dtype == torch.bfloat16 and out.is_cuda


@pytest.mark.cuda
def test_fused_wrapper_rejects_bad_inputs(cuda):
    d = _fused_inputs(cuda, 32, seed=0)
    call = lambda **kw: RK.rsp_augment_cuda(*[kw.get(k, d[k]) for k in ("tiles", "mats", "params", "seeds")],
                                            kw.get("noise"), *IDENTITY, kw.get("out_dtype", torch.float32),
                                            order=kw.get("order"), plan_out=kw.get("plan_out"))
    with pytest.raises(TypeError):
        call(order=torch.zeros(4, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        call(order=torch.zeros(12, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        call(plan_out=torch.zeros(12, 6, device=cuda))
    with pytest.raises(TypeError):
        call(tiles=d["tiles"].float())
    with pytest.raises(TypeError):
        call(out_dtype=torch.float16)
    with pytest.raises(ValueError):
        call(tiles=d["tiles"][:, :, :, :31].contiguous())  # not square
    with pytest.raises(ValueError):
        call(tiles=d["tiles"].transpose(2, 3))  # not contiguous
    with pytest.raises(ValueError):
        call(seeds=d["seeds"][:5])
    with pytest.raises(ValueError):
        call(mats=d["mats"].cpu())
    with pytest.raises(ValueError):
        call(noise=d["noise"][:, :, :16])


@pytest.mark.cuda
@pytest.mark.parametrize("s", [37, 224])
def test_consistency_views_card_match_cpu(cuda, s):
    """The weak/strong consistency views (PyTorch ops, no kernel) on the card
    against the CPU on the same draws, every op of the strong pool on, within
    1e-5; both kernels stay unlaunched."""
    from ssl_cr_histo_tpu_torch.ops import randaugment as RA

    g = torch.Generator().manual_seed(s)
    b = 18
    d = TB.draw_transform_fix(g, b, s)
    d["ops"][:9, 0] = torch.arange(9)
    d["params"] = RA.draw_v1_params(g, d["ops"], d["mags"])
    d["params"][..., RA.GATE] = 1.0
    d["noise"] = torch.randn(int((d["ops"] == RA.NOISE).sum()), 3, s, s, generator=g)
    imgs = torch.randint(0, 256, (b, s, s, 3), dtype=torch.uint8, generator=g)
    launched = (RK.launches, PK.launches)
    want = TB.transform_fix_batch(None, imgs, draws=d)
    got = TB.transform_fix_batch(None, imgs.to(cuda), draws=dict(d, noise=d["noise"].to(cuda)))
    assert (RK.launches, PK.launches) == launched
    for a, w in zip(got, want):
        assert a.is_cuda and a.shape == (b, 3, s, s)
        np.testing.assert_allclose(a.cpu().numpy(), w.numpy(), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_consistency_step_card_matches_cpu(cuda, monkeypatch):
    """One float32 consistency step (Kather's head, Adam, batch 2 + 4
    unlabeled at 32^2, the views drawn on the host) on the card and on the
    CPU from the same weights, TF32 off as the CLIs run it: losses rtol
    1e-4, the student within 1e-4, the teacher unchanged."""
    from ssl_cr_histo_tpu_torch.cli.common import TASKS, make_optimizer
    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train.init import init_finetune_state, init_teacher

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = TASKS["kather"]
    g = torch.Generator().manual_seed(3)
    x_l = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8, generator=g)
    x_u = torch.randint(0, 256, (4, 32, 32, 3), dtype=torch.uint8, generator=g)
    y_l = torch.tensor([1, 7])
    views = (S.expand_labeled_batch(g, x_l, y_l)[0], *TB.transform_fix_batch(g, x_u))
    out = {}
    for dev in ("cpu", cuda):
        torch.manual_seed(0)
        state = init_finetune_state("resnet18", cfg.num_classes, torch.device(dev),
                                    lambda ps: make_optimizer(cfg.optimizer, ps, cfg.lr))
        teacher = init_teacher(state)
        t0 = {k: v.clone() for k, v in teacher.model.state_dict().items()}
        m = S.consistency_step(state, teacher, x_l.to(dev), y_l.to(dev), x_u.to(dev), None, cfg.task,
                               views=tuple(v.to(dev) for v in views))
        assert all(torch.equal(v, t0[k]) for k, v in teacher.model.state_dict().items())
        out[str(dev)] = ({k: float(m[k]) for k in ("loss", "sup", "cons")},
                         {k: v.detach().cpu() for k, v in state.model.state_dict().items() if v.is_floating_point()})
    (l_cpu, sd_cpu), (l_gpu, sd_gpu) = out["cpu"], out[str(cuda)]
    for k in l_cpu:
        np.testing.assert_allclose(l_gpu[k], l_cpu[k], rtol=1e-4)
    assert max((sd_gpu[k] - sd_cpu[k]).abs().max().item() for k in sd_cpu) <= 1e-4


@pytest.mark.cuda
def test_serving_map_card_matches_cpu(cuda, monkeypatch, tmp_path):
    """The serving loop (pinned reads, non-blocking copies both ways, each
    batch drained one forward late) on the card against the CPU, float32,
    TF32 off, from one 2-way checkpoint: a 512^2 slide, a 16 x 16 mask,
    64^2 patches, batch 24 (the last batch short); maps within 1e-5, 0 off
    the mask; no kernel launches."""
    from ssl_cr_histo_tpu_torch.cli.common import make_optimizer
    from ssl_cr_histo_tpu_torch.data.wsi import ArrayPyramid
    from ssl_cr_histo_tpu_torch.eval import heatmap as H
    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train.checkpoint import save_checkpoint
    from ssl_cr_histo_tpu_torch.train.init import init_finetune_state, init_serving_state

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.default_rng(4)
    slide = ArrayPyramid(rng.integers(0, 256, (512, 512, 3), dtype=np.uint8), levels=1)
    mask = (rng.random((16, 16)) < 0.5).astype(np.uint8)
    torch.manual_seed(0)
    path = str(tmp_path / "best.pth")
    save_checkpoint(path, init_finetune_state("resnet18", 2, torch.device("cpu"),
                                              lambda ps: make_optimizer("sgd", ps, 5e-4)), {"epoch": 1})
    PK.launches = RK.launches = 0
    maps = {}
    for dev in (torch.device("cpu"), cuda):
        state = init_serving_state("resnet18", 2, dev, path)
        maps[dev.type] = H.compute_probs_map(slide, mask, lambda x, s=state: S.forward(s, x), dev,
                                             image_size=64, batch_size=24)
    np.testing.assert_allclose(maps["cuda"], maps["cpu"], rtol=0, atol=1e-5)
    assert not maps["cuda"][mask == 0].any() and (maps["cuda"][mask > 0] > 0).all()
    assert PK.launches == RK.launches == 0


@pytest.mark.cuda
def test_evaluation_logits_card_match_cpu(cuda, monkeypatch, tmp_path):
    """--mode evaluation's predict_all on the card against the CPU, float32,
    TF32 off, from one 9-way checkpoint: 70 images of 64^2 at batch 32 (the
    last batch short), logits within 1e-4, in order; no kernel launches."""
    from ssl_cr_histo_tpu_torch.cli import finetune
    from ssl_cr_histo_tpu_torch.cli.common import TASKS, make_optimizer
    from ssl_cr_histo_tpu_torch.data.datasets import ArrayDataset
    from ssl_cr_histo_tpu_torch.train.checkpoint import save_checkpoint
    from ssl_cr_histo_tpu_torch.train.init import init_finetune_state, init_serving_state

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.default_rng(6)
    ds = ArrayDataset(rng.integers(0, 256, (70, 64, 64, 3), dtype=np.uint8), rng.integers(0, 9, 70))
    torch.manual_seed(0)
    path = str(tmp_path / "best.pth")
    save_checkpoint(path, init_finetune_state("resnet18", 9, torch.device("cpu"),
                                              lambda ps: make_optimizer("adam", ps, 1e-5)), {"epoch": 1})
    PK.launches = RK.launches = 0
    out = {dev.type: finetune.predict_all(init_serving_state("resnet18", 9, dev, path), ds, TASKS["kather"], dev,
                                          batch_size=32)
           for dev in (torch.device("cpu"), cuda)}
    assert out["cuda"].shape == (70, 9)
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0, atol=1e-4)
    assert PK.launches == RK.launches == 0
