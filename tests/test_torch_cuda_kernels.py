"""The port's CUDA kernel against its plain PyTorch version, on the GPU.

Every test here needs a card (marker ``cuda``) and skips where
``torch.cuda.is_available()`` is False.  The file imports nothing of JAX, so
that it runs on a GPU machine without JAX, bypassing tests/conftest.py (which
imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance 1e-4 absolute on outputs in [0, 1]: the kernel and PyTorch's CUDA
ops differ by a few ulp in logf/expf/division (no fast math) and in FMA
contraction.
"""

import numpy as np
import pytest
import torch

from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK

GATES = (3, 5, 10, 13)  # hsv, noise, blur, brightness/contrast


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
