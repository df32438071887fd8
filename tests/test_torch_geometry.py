"""The port's matrix builders, warp and geometric draw law against the JAX
package's (``ssl_cr_histo_tpu/ops/geometry.py``, ``ops/fused.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssl_cr_histo_tpu.ops import fused as JF
from ssl_cr_histo_tpu.ops import geometry as JG
from ssl_cr_histo_tpu_torch.ops import fused as TF
from ssl_cr_histo_tpu_torch.ops import geometry as TG


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_a_file():
    """One intra-op thread for the file's torch work (restored after): at
    the tests' sizes more threads buy nothing, and under the six-worker run
    every worker's spinning thread pool contends with the others' for the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def test_matrix_builders_match_jax():
    """Builders at fixed scalars, one batch on the port's side.  Tolerance
    atol 1e-6 plus rtol 1e-6: entries reach ~S (the centering
    translations), where one float32 ulp is already ~4e-6."""
    s = 64
    deg = [0.0, 30.0, -45.0, 89.0, -91.0, 179.5]
    got = TG.rotation_matrix(torch.tensor(deg), s, s).numpy()
    want = np.stack([_np(JG.rotation_matrix(jnp.float32(d), s, s)) for d in deg])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    scales = [0.5, 0.75, 1.5]
    got = TG.scale_matrix(torch.tensor(scales), s, s).numpy()
    want = np.stack([_np(JG.scale_matrix(jnp.float32(v), s, s)) for v in scales])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    got = TG.translation_matrix(torch.tensor([1.5, -3.0]), torch.tensor([0.25, 7.0])).numpy()
    want = np.stack([_np(JG.translation_matrix(jnp.float32(a), jnp.float32(b)))
                     for a, b in ((1.5, 0.25), (-3.0, 7.0))])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    args = [(0.05, -0.03, 1.2, 30.0), (-0.0625, 0.0625, 0.5, -45.0)]
    got = TG.shift_scale_rotate_matrix(*[torch.tensor(c) for c in zip(*args)], h=s, w=s).numpy()
    want = np.stack([_np(JG.shift_scale_rotate_matrix(*map(jnp.float32, a), h=s, w=s)) for a in args])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    a, b = TG.rotation_matrix(torch.tensor(20.0), s, s), TG.scale_matrix(torch.tensor(1.3), s, s)
    ja, jb = JG.rotation_matrix(jnp.float32(20.0), s, s), JG.scale_matrix(jnp.float32(1.3), s, s)
    np.testing.assert_allclose(TG.compose(a, b).numpy(), _np(JG.compose(ja, jb)), rtol=1e-6, atol=1e-6)


def _warp_matrices(s):
    hflip = np.array([[-1, 0, s - 1], [0, 1, 0], [0, 0, 1]], np.float32)
    mats = [np.eye(3, dtype=np.float32), hflip]
    mats += [_np(JG.rotation_matrix(jnp.float32(d), s, s)) for d in (45.0, -45.0, 89.0, -89.0, 91.0, -91.0)]
    mats += [_np(JG.scale_matrix(jnp.float32(v), s, s)) for v in (0.5, 1.5)]
    # anisotropic: |a| > |e| (transpose fix-up) with and without rotation
    mats.append(np.array([[1.4, 0.2, -3.0], [0.1, 0.7, 2.0], [0, 0, 1]], np.float32))
    mats.append(_np(JG.compose(jnp.asarray(mats[-1]), JG.rotation_matrix(jnp.float32(80.0), s, s))))
    return np.stack(mats)


@pytest.mark.parametrize("pad_mode", ["reflect101", "constant"])
@pytest.mark.parametrize("s", [32, 48])
def test_warp_matches_jax(pad_mode, s):
    """The port's 2-tap gather warp against warp_affine_mxu_planar on the
    CPU (float32 dot operands there, geometry.py:264-267).  atol 1e-5: both
    form the same two nonzero hat weights; only summation order and FMA
    contraction of the sample positions differ."""
    mats = _warp_matrices(s)
    m = mats[:, :2, :2]
    rot_dominant = np.abs(m[:, 0, 0]) + np.abs(m[:, 1, 1]) < np.abs(m[:, 0, 1]) + np.abs(m[:, 1, 0])
    assert rot_dominant.any() and (~rot_dominant).any()
    rng = np.random.default_rng(s)
    imgs = rng.random((len(mats), 3, s, s)).astype(np.float32)
    want = jax.vmap(lambda im, mt: JG.warp_affine_mxu_planar(im, mt, pad_mode=pad_mode))(
        jnp.asarray(imgs), jnp.asarray(mats))
    got = TG.warp_affine_planar(torch.from_numpy(imgs), torch.from_numpy(mats), pad_mode=pad_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_transpose_fixup_exercised():
    """The matrix set above drives both lattice fix-ups of the warp."""
    m = _warp_matrices(32)
    swaps = []
    for mt in m:
        rd = abs(mt[0, 0]) + abs(mt[1, 1]) < abs(mt[0, 1]) + abs(mt[1, 0])
        if rd:
            mt = TG._f32(TG._rot90_matrix(32, 32)).numpy() @ mt
        swaps.append(abs(mt[0, 0]) > abs(mt[1, 1]))
    assert any(swaps) and not all(swaps)


def test_fold_coords_matches_jax():
    pos = np.array([-40.5, -1.0, -0.25, 0.0, 30.999999, 31.0, 31.0000005, 31.5, 62.0, 95.25], np.float32)
    for mode in ("reflect101", "constant"):
        got = TG._fold_coords(torch.from_numpy(pos), 32, mode).numpy()
        want = np.asarray(JG._fold_coords(jnp.asarray(pos), 32, mode))
        np.testing.assert_array_equal(got, want)


def test_pretrain_geo_matrix_law_matches_jax():
    """The composed pretraining matrices' law by moments: per-entry mean
    within 5 standard errors (of the difference of two means) and std within
    10%, n = 4096 per side."""
    n, s = 4096, 64
    got = TF.draw_pretrain_geo_matrices(torch.Generator().manual_seed(0), n, s).numpy()
    want = np.asarray(jax.vmap(lambda k: JF._pretrain_geo_matrix(k, s))(
        jax.random.split(jax.random.PRNGKey(0), n)))
    assert got.shape == want.shape == (n, 3, 3)
    np.testing.assert_array_equal(got[:, 2], np.broadcast_to([0, 0, 1], (n, 3)))
    for i in range(2):
        for j in range(3):
            g, w = got[:, i, j], want[:, i, j]
            se = np.sqrt((g.var() + w.var()) / n)
            assert abs(g.mean() - w.mean()) < 5 * se + 1e-6, (i, j, g.mean(), w.mean())
            np.testing.assert_allclose(g.std(), w.std(), rtol=0.1, err_msg=f"{i},{j}")
