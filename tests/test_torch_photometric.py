"""The port's photometric chain against the JAX package's Pallas kernel.

Inputs are made from a numpy seed and fed to both sides.  The JAX side runs
``pretrain_photometric_pallas`` in interpret mode with host-supplied noise,
as tests/test_pallas_photometric.py runs it on the CPU.  The CUDA kernel
against this plain chain is tests/test_torch_cuda_kernels.py (GPU only) and
phases 3-4 of chip_smoke.py.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssl_cr_histo_tpu.ops import pallas_photometric as PP
from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK


def _base_params(rng, n):
    """Params drawn with the law of draw_params, numpy side."""
    p = np.zeros((n, PK.N_PARAMS), np.float32)
    p[:, 0] = rng.uniform(-0.1, 0.1, n)
    p[:, 1] = rng.uniform(-1, 1, n)
    p[:, 2] = rng.uniform(-20, 20, n)
    p[:, 4] = rng.uniform(0, 0.1, n)
    p[:, 6:9] = rng.normal(size=(n, 3)) * rng.uniform(-0.035, 0.035, (n, 3))
    p[:, 9] = 3.0 + 2.0 * rng.integers(0, 3, n)
    p[:, 11] = rng.uniform(-0.2, 0.2, n)
    p[:, 12] = rng.uniform(-0.2, 0.2, n)
    return p


GATES = (3, 5, 10, 13)  # hsv, noise, blur, brightness/contrast


def _cases(rng):
    """One tile per case: all gates off, all on, each gate alone, and the
    blur alone at each k in {3, 5, 7}."""
    rows = [(), GATES] + [(g,) for g in GATES] + [(10,)] * 3
    p = _base_params(rng, len(rows))
    for i, on in enumerate(rows):
        p[i, list(on)] = 1.0
    p[-3:, 9] = (3.0, 5.0, 7.0)
    return p


@pytest.mark.parametrize("hw", [(32, 32), (17, 17)])
def test_plain_chain_matches_pallas_interpret(hw):
    """Tolerance 1e-5 absolute on outputs in [0, 1]: both sides are float32
    with the same operation order; what remains is libm/XLA ulp differences
    in log/exp/division and FMA contraction."""
    rng = np.random.default_rng(0)
    params = _cases(rng)
    n = len(params)
    imgs = rng.random((n, 3, *hw)).astype(np.float32)
    noise = rng.normal(size=(n, 3, *hw)).astype(np.float32)
    want = PP.pretrain_photometric_pallas(
        jnp.asarray(imgs), jax.random.PRNGKey(0), interpret=True,
        noise=jnp.asarray(noise), params=jnp.asarray(params), planar_io=True)
    got = PK.reference_chain(torch.from_numpy(imgs), torch.from_numpy(params), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_wrapper_on_cpu_runs_the_plain_chain():
    """A CPU tensor goes to the plain chain: with noise None that is the chain
    on the kernel's Philox noise, drawn from the generator's seeds.  Exact:
    the same function on the same inputs."""
    imgs = torch.rand(3, 3, 16, 16, generator=torch.Generator().manual_seed(1))
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    before = PK.launches
    out = PK.pretrain_photometric(imgs, g1)
    params = PK.draw_params(g2, 3)
    seeds = PK.draw_seeds(g2, 3)
    want = PK.reference_chain(imgs, params, PK.philox_normal(seeds, imgs.shape))
    assert torch.equal(out, want)
    assert PK.launches == before  # the counter moves only where the kernel launches


def test_draw_params_law_matches_jax():
    """The port's draw_params against the JAX law by distribution: ranges,
    the blur size set, Bernoulli(0.5) gate rates, and the HED shift's
    spread.  n = 4096: a gate rate's std is 0.008, so +-0.04 is 5 sigma."""
    n = 4096
    got = PK.draw_params(torch.Generator().manual_seed(0), n).numpy()
    want = np.asarray(PP.draw_params(jax.random.PRNGKey(0), n))
    assert got.shape == want.shape == (n, PK.N_PARAMS)
    for col, lo, hi in ((0, -0.1, 0.1), (1, -1, 1), (2, -20, 20), (4, 0, 0.1),
                        (11, -0.2, 0.2), (12, -0.2, 0.2)):
        assert lo <= got[:, col].min() and got[:, col].max() <= hi
        np.testing.assert_allclose(got[:, col].mean(), want[:, col].mean(), atol=0.05 * (hi - lo))
    assert set(np.unique(got[:, 9])) == set(np.unique(want[:, 9])) == {3.0, 5.0, 7.0}
    for col in GATES:
        assert set(np.unique(got[:, col])) == {0.0, 1.0}
        assert abs(got[:, col].mean() - 0.5) < 0.04 and abs(want[:, col].mean() - 0.5) < 0.04
    # HED shifts: N(0,1) * U(-.035,.035) -> std 0.035/sqrt(3) = 0.0202
    np.testing.assert_allclose(got[:, 6:9].std(), want[:, 6:9].std(), rtol=0.1)
    assert np.all(got[:, 14:] == 0.0)


def test_philox_known_answers():
    """Philox4x32-10 against the Random123 known-answer vectors."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        got = PK.philox4x32([t(c) for c in ctr], [t(k) for k in key])
        assert tuple(int(w) for w in got) == want


def test_philox_noise_deterministic_and_normal():
    """Same seeds -> bitwise-equal noise; other seeds -> other noise; the
    values are N(0, 1) (n = 49152: mean within 0.02, std within 2%)."""
    seeds = torch.tensor([3, 4], dtype=torch.int32)
    a = PK.philox_normal(seeds, (2, 3, 64, 128))
    b = PK.philox_normal(seeds.clone(), (2, 3, 64, 128))
    c = PK.philox_normal(seeds + 1, (2, 3, 64, 128))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])  # tiles differ
    assert abs(a.mean().item()) < 0.02 and abs(a.std().item() - 1.0) < 0.02
    assert torch.isfinite(a).all()


@pytest.mark.parametrize("hw, want", [
    ((256, 256), (8, 32, 101376)),  # the main path: 8 CTAs of 32 rows, 99 KB each
    ((224, 224), (8, 28, 77952)),
    ((37, 37), (8, 5, 2880)),      # 7 x 5 + 2 rows; rows padded to 40 pixels
    ((50, 64), (8, 7, 6048)),      # the last CTA holds one row
    ((3, 3), (3, 1, 144)),         # fewer rows than a cluster: one CTA a row
    ((1, 1), (1, 1, 144)),
])
def test_chain_launch_plan(hw, want):
    assert PK.chain_launch_plan(*hw) == want


def test_chain_launch_plan_covers_every_row_once():
    """Every CTA of the cluster owns at least one row, the CTAs together own
    all of them, and the shared bytes hold three planes of the CTA's rows at
    a pitch of ceil(w / 4) * 4 floats and 4 halo floats on each side."""
    for h in range(1, 300):
        for w in (1, 3, 4, 37, 256):
            cluster, rows, smem = PK.chain_launch_plan(h, w)
            assert 1 <= cluster <= PK.MAX_CLUSTER
            assert (cluster - 1) * rows < h <= cluster * rows
            assert smem == 3 * rows * (-(-w // 4) * 4 + 8) * 4 <= PK.MAX_SMEM


@pytest.mark.parametrize("hw", [(16, 257), (1024, 256), (0, 8)])
def test_chain_launch_plan_refuses_and_names_the_shape(hw):
    """Rows wider than 256 pixels, more rows a CTA than shared memory holds,
    or no rows: ValueError naming the tile shape."""
    with pytest.raises(ValueError, match=re.escape(f"(3, {hw[0]}, {hw[1]})")):
        PK.chain_launch_plan(*hw)
