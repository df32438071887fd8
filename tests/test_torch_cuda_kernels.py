"""The port's CUDA kernels against their plain PyTorch versions, on the GPU:
the photometric chain (``csrc/photometric_chain.cu``) and the fused v1
augmentation (``csrc/rsp_augment.cu``).

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
