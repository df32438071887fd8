"""The port's fused v1 augmentation (``ops/rsp_augment_kernel.py``) on the
CPU: its plain version against the JAX package's augmentation composition,
the bf16 output, the Philox noise layout the kernels share, the CPU dispatch
of ``augment_rsp_batch_v1``, and the kernel build's source hash.

The CUDA kernel against this plain version is tests/test_torch_cuda_kernels.py
(GPU only) and chip_smoke.py.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssl_cr_histo_tpu.ops import batch as JB
from ssl_cr_histo_tpu.ops import geometry as JG
from ssl_cr_histo_tpu.ops import pallas_photometric as PP
from ssl_cr_histo_tpu.parallel import steps as JS
from ssl_cr_histo_tpu_torch.csrc import build
from ssl_cr_histo_tpu_torch.ops import batch as TB
from ssl_cr_histo_tpu_torch.ops import geometry as TG
from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK
from ssl_cr_histo_tpu_torch.ops import rsp_augment_kernel as RK
from ssl_cr_histo_tpu_torch.parallel import steps as TS
from torch_tmp import tmp_path  # noqa: F401  (a fixture)


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


GATES = (3, 5, 10, 13)  # hsv, noise, blur, brightness/contrast
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _matrices(s):
    """Two tiles per triplet position: identity, hflip, rotations on both
    sides of 90 degrees, zooms, and anisotropic maps that take the warp's
    transpose fix-up with and without its 90-degree fix-up."""
    hflip = np.array([[-1, 0, s - 1], [0, 1, 0], [0, 0, 1]], np.float32)
    mats = [np.eye(3, dtype=np.float32), hflip]
    mats += [np.asarray(JG.rotation_matrix(jnp.float32(d), s, s)) for d in (30.0, -45.0, 89.0, -91.0)]
    mats += [np.asarray(JG.scale_matrix(jnp.float32(v), s, s)) for v in (0.6, 1.4)]
    mats.append(np.array([[1.4, 0.2, -3.0], [0.1, 0.7, 2.0], [0, 0, 1]], np.float32))
    mats.append(np.array([[0.1, 0.6, 2.0], [1.4, 0.2, -1.0], [0, 0, 1]], np.float32))
    mats += [np.asarray(JG.rotation_matrix(jnp.float32(d), s, s)) for d in (120.0, 10.0)]
    return np.stack(mats).astype(np.float32)


def _params(rng, n):
    """Params with draw_params' law, then per tile: all gates off, all on,
    each gate alone, the blur alone at k = 3, 5, 7, and drawn gates."""
    p = np.zeros((n, PK.N_PARAMS), np.float32)
    p[:, 0] = rng.uniform(-0.1, 0.1, n)
    p[:, 1] = rng.uniform(-1, 1, n)
    p[:, 2] = rng.uniform(-20, 20, n)
    p[:, 4] = rng.uniform(0, 0.1, n)
    p[:, 6:9] = rng.normal(size=(n, 3)) * rng.uniform(-0.035, 0.035, (n, 3))
    p[:, 9] = 3.0 + 2.0 * rng.integers(0, 3, n)
    p[:, 11] = rng.uniform(-0.2, 0.2, n)
    p[:, 12] = rng.uniform(-0.2, 0.2, n)
    p[:, list(GATES)] = rng.integers(0, 2, (n, len(GATES)))
    rows = [(), GATES] + [(g,) for g in GATES] + [(10,)] * 3
    for i, on in enumerate(rows):
        p[i, list(GATES)] = 0.0
        p[i, list(on)] = 1.0
    p[len(rows) - 3:len(rows), 9] = (3.0, 5.0, 7.0)
    return p


def _inputs(s, seed=0):
    mats = _matrices(s)
    n = len(mats)  # 12 tiles = 4 triplets
    rng = np.random.default_rng(seed)
    return {
        "tiles": rng.integers(0, 256, (n // 3, 3, s, s, 3), dtype=np.uint8),
        "mats": mats,
        "params": _params(rng, n),
        "noise": rng.normal(size=(n, 3, s, s)).astype(np.float32),
    }


def _jax_composition(d, mean, std):
    """The JAX package's fused + Pallas augmentation on the same inputs:
    to_float -> vmapped warp_affine_mxu_planar (reflect101) -> interpret-mode
    Pallas chain with host noise -> _clip01 -> normalize_batch."""
    b, t, s = d["tiles"].shape[:3]
    imgs = JB.to_float(jnp.asarray(d["tiles"].reshape(b * t, s, s, 3).transpose(0, 3, 1, 2)))
    warped = jax.vmap(lambda im, m: JG.warp_affine_mxu_planar(im, m, pad_mode="reflect101"))(
        imgs, jnp.asarray(d["mats"]))
    out = JB._clip01(PP.pretrain_photometric_pallas(
        warped, jax.random.PRNGKey(0), interpret=True, noise=jnp.asarray(d["noise"]),
        params=jnp.asarray(d["params"]), planar_io=True))
    return np.asarray(JB.normalize_batch(out.reshape(b, t, 3, s, s), mean, std, channel_axis=2))


def _plain(d, mean, std, out_dtype=torch.float32, noise=True, order=None, tiles=None):
    n = len(d["mats"])
    return RK.rsp_augment_plain(
        torch.from_numpy(d["tiles"]) if tiles is None else tiles, torch.from_numpy(d["mats"]),
        torch.from_numpy(d["params"]), torch.arange(n, dtype=torch.int32),
        torch.from_numpy(d["noise"]) if noise else None, mean, std, out_dtype, order=order)


def _order(b, seed):
    """A numpy-drawn ordering index per triplet that uses every ordering."""
    return np.random.default_rng(seed).permutation(np.arange(max(b, 6)) % 6)[:b].astype(np.int32)


@pytest.mark.parametrize("s", [32, 37])
def test_matrix_set_takes_both_fixups(s):
    """The matrices above drive the warp's 90-degree and transpose fix-ups,
    alone and together."""
    coef = TG.warp_pass_coefficients(torch.from_numpy(_matrices(s)), s).numpy()
    rot, swap = coef[:, 6] > 0.5, coef[:, 7] > 0.5
    assert rot.any() and (~rot).any() and swap.any() and (~swap).any()
    assert (rot & swap).any() and (~rot & swap).any()


@pytest.mark.parametrize("s", [32, 37])
@pytest.mark.parametrize("norm", ["identity", "imagenet"])
def test_plain_matches_jax_composition(s, norm):
    """rsp_augment_plain against the JAX composition, float32, atol 1e-5.
    Why 1e-5: the warps form the same two nonzero hat weights but the JAX
    one sums them in an einsum (another order than the port's two products
    and an add, about 1 ulp of [0, 1] values), and the chains differ by
    libm/XLA ulps in log/exp/division; test_torch_photometric and
    test_torch_geometry hold each half to 1e-5 on its own.  With the
    ImageNet std (~0.22) the normalize scales that by at most 4.5, so the
    bound there is 4.5e-5."""
    mean, std = ((0.0,) * 3, (1.0,) * 3) if norm == "identity" else (MEAN, STD)
    d = _inputs(s)
    got = _plain(d, mean, std)
    assert got.shape == (4, 3, 3, s, s) and got.dtype == torch.float32
    want = _jax_composition(d, mean, std)
    atol = 1e-5 / min(std)
    err = np.abs(got.numpy() - want)
    report = "" if (err <= atol).all() else _mismatch_report(d, mean, std, got.numpy(), want, err, atol)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol, err_msg=report)


def _jax_fixups(mats, s):
    """The JAX warp's lattice fix-up flags (rot90, transpose) for each
    matrix of s x s tiles, as ``warp_affine_mxu_planar`` decides them in
    float32."""
    def flags(m):
        rot = jnp.abs(m[0, 0]) + jnp.abs(m[1, 1]) < jnp.abs(m[0, 1]) + jnp.abs(m[1, 0])
        m = jnp.where(rot, jnp.asarray(JG._rot90_matrix(s, s)) @ m, m)
        return rot, jnp.abs(m[0, 0]) > jnp.abs(m[1, 1])
    rot, swap = jax.vmap(flags)(jnp.asarray(mats))
    return np.asarray(rot), np.asarray(swap)


def _mismatch_report(d, mean, std, got, want, err, atol):
    """What a failure of the parity test needs: the largest error and where
    it is, the tiles over the bound with their gates, blur size and both
    warps' fix-up flags, each tile's largest error, and whether the same
    computation repeated in this process gives the same numbers (a state of
    the process, or of the inputs, rather than the arithmetic)."""
    s = d["tiles"].shape[2]
    err = np.where(np.isnan(err), np.inf, err)
    b, t, c, y, x = (int(i) for i in np.unravel_index(np.argmax(err), err.shape))
    port = TG.warp_pass_coefficients(torch.from_numpy(d["mats"]), s).numpy()
    jrot, jswap = _jax_fixups(d["mats"], s)
    per_tile = err.reshape(len(d["mats"]), -1).max(1)
    tiles = [
        f"tile {i}: max err {per_tile[i]:.3e}, gates (hsv, noise, blur, bc) "
        f"{tuple(int(v) for v in d['params'][i, list(GATES)])}, k {int(d['params'][i, 9])}, "
        f"rot/swap port {int(port[i, 6])}/{int(port[i, 7])} JAX {int(jrot[i])}/{int(jswap[i])}"
        for i in np.flatnonzero(per_tile > atol)]
    again = _plain(d, mean, std).numpy()
    try:
        import ctypes
        rounding = ctypes.CDLL("libm.so.6").fegetround()  # FE_TONEAREST is 0 on x86-64
    except OSError:
        rounding = "unknown"
    return "\n".join([
        f"largest error {err[b, t, c, y, x]:.3e} at (triplet {b}, tile {3 * b + t}, channel {c}, y {y}, x {x}): "
        f"port {float(got[b, t, c, y, x])!r}, JAX {float(want[b, t, c, y, x])!r}; "
        f"{int((~(err <= atol)).sum())} of {err.size} over {atol:.2e}",
        *tiles,
        f"every tile's largest error: {np.array2string(per_tile, precision=3)}",
        f"the port's side computed again: max change {np.abs(again - got).max():.3e}, "
        f"against JAX {np.abs(again - want).max():.3e}; rounding mode {rounding}; torch threads "
        f"{torch.get_num_threads()}, pid {os.getpid()}",
    ])


@pytest.mark.parametrize("noise", [True, False], ids=["host-noise", "philox"])
def test_bf16_output_is_the_float32_output_rounded(noise):
    """out_dtype bf16 is the float32 result cast to bf16 (round to nearest
    even), bit for bit, in both noise modes."""
    d = _inputs(37, seed=1)
    f32 = _plain(d, MEAN, STD, torch.float32, noise)
    bf16 = _plain(d, MEAN, STD, torch.bfloat16, noise)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))


@pytest.mark.parametrize("noise", [True, False], ids=["host-noise", "philox"])
def test_plain_order_is_permute_then_augment(noise):
    """rsp_augment_plain(order=o) is permute_triplets(tiles, o) followed by
    rsp_augment_plain on the reordered tiles, bit for bit: the draws, seeds
    and noise stay with the output slots."""
    d = _inputs(32, seed=5)
    order = torch.from_numpy(_order(4, 5))
    got = _plain(d, MEAN, STD, noise=noise, order=order)
    permuted = TS.permute_triplets(torch.from_numpy(d["tiles"]), order)
    assert torch.equal(got, _plain(d, MEAN, STD, noise=noise, tiles=permuted))
    assert not torch.equal(got, _plain(d, MEAN, STD, noise=noise))


@pytest.mark.parametrize("s", [32, 37])
def test_plain_order_matches_jax_permute_then_composition(s):
    """rsp_augment_plain(order=o) against the JAX package's permute_triplets
    followed by its augmentation composition on the same draws, float32,
    atol 1e-5 (see test_plain_matches_jax_composition)."""
    d = _inputs(s, seed=6)
    order = _order(4, 6)
    got = _plain(d, (0.0,) * 3, (1.0,) * 3, order=torch.from_numpy(order))
    jd = dict(d, tiles=np.asarray(JS.permute_triplets(jnp.asarray(d["tiles"]), jnp.asarray(order))))
    want = _jax_composition(jd, (0.0,) * 3, (1.0,) * 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_plain_rejects_an_order_of_another_length():
    d = _inputs(32)
    with pytest.raises(ValueError, match="order"):
        _plain(d, MEAN, STD, order=torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("bad", [-1, 6])
def test_plain_rejects_orders_out_of_range(bad):
    """An ordering index outside [0, 6) raises (negative indices would
    otherwise wrap around in the table)."""
    d = _inputs(32)
    order = torch.zeros(4, dtype=torch.int32)
    order[2] = bad
    with pytest.raises(ValueError, match="outside"):
        _plain(d, MEAN, STD, order=order)


def test_step_orders_with_the_kernels_table():
    """The step's orderings and permute_triplets are the augmentation's own
    (one table for the kernel, its plain version and the step), and equal the
    JAX package's permute_triplets on every ordering."""
    assert TS.RSP_PERMUTATIONS is RK.RSP_PERMUTATIONS and TS.permute_triplets is RK.permute_triplets
    tiles = np.random.default_rng(9).integers(0, 256, (6, 3, 4, 4, 3), dtype=np.uint8)
    order = np.arange(6, dtype=np.int32)
    got = RK.permute_triplets(torch.from_numpy(tiles), torch.from_numpy(order))
    want = np.asarray(JS.permute_triplets(jnp.asarray(tiles), jnp.asarray(order)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_augment_order_keyword():
    """augment_rsp_batch_v1 with order None augments the tiles as given (the
    same result as ordering 0, the identity); with an order it equals the
    plain version with that order on the same draws and seeds."""
    d = _inputs(32, seed=7)
    tiles = torch.from_numpy(d["tiles"])
    run = lambda **kw: TB.augment_rsp_batch_v1(torch.Generator().manual_seed(8), tiles, mean=MEAN, std=STD,
                                               **kw)
    plain = run()
    assert torch.equal(plain, run(order=torch.zeros(4, dtype=torch.int64)))
    order = torch.from_numpy(_order(4, 7))
    g = torch.Generator().manual_seed(8)
    draws = TB.draw_rsp_v1(g, 12, 32)
    seeds = PK.draw_seeds(g, 12)
    want = RK.rsp_augment_plain(tiles, draws["geo"], draws["params"], seeds, None, MEAN, STD, order=order)
    assert torch.equal(run(order=order), want)


def test_kernel_orderings_are_the_jax_packages():
    """The six orderings handed to the kernel are the JAX package's
    RSP_PERMUTATIONS, row by row; mean and std follow the HED matrices."""
    consts, perms = RK._host_consts(MEAN, STD)
    assert list(perms) == [int(v) for v in np.asarray(JS.RSP_PERMUTATIONS).reshape(-1)]
    assert np.allclose(list(consts)[18:], MEAN + STD, rtol=1e-7, atol=0)


def test_philox_mode_uses_the_shared_noise():
    """With noise None the plain version draws philox_normal(seeds): the
    same result as passing that noise explicitly (exact)."""
    d = _inputs(32, seed=2)
    n = len(d["mats"])
    seeds = torch.arange(n, dtype=torch.int32)
    got = _plain(d, MEAN, STD, noise=False)
    d["noise"] = PK.philox_normal(seeds, (n, 3, 32, 32)).numpy()
    assert torch.equal(got, _plain(d, MEAN, STD))


def test_philox_normal_layout():
    """One Philox call per pixel at counter (x, y, n, 0), key (seed, 0):
    channels 0 and 1 are the cos and sin of words 0-1's Box-Muller pair,
    channel 2 the cos of words 2-3's.  Checked at one pixel against
    philox4x32 (itself checked against Random123's known answers in
    test_torch_photometric.py), exact."""
    seeds = torch.tensor([11, 987654321], dtype=torch.int32)
    z = PK.philox_normal(seeds, (2, 3, 5, 7))
    t = lambda v: torch.tensor([v], dtype=torch.int64)
    n, y, x = 1, 3, 6
    words = PK.philox4x32([t(x), t(y), t(n), t(0)], [t(987654321), t(0)])
    u = [PK._uniform_open(wd) for wd in words]
    r01, r2 = torch.sqrt(-2.0 * torch.log(u[0])), torch.sqrt(-2.0 * torch.log(u[2]))
    want = [r01 * torch.cos(6.283185307179586 * u[1]), r01 * torch.sin(6.283185307179586 * u[1]),
            r2 * torch.cos(6.283185307179586 * u[3])]
    for c in range(3):
        assert z[n, c, y, x].item() == want[c].item()
    with pytest.raises(ValueError):
        PK.philox_normal(seeds, (2, 4, 5, 7))


def test_philox_channels_are_independent_normals():
    """The three channels are N(0, 1) and uncorrelated with each other
    (n = 2 * 96 * 128 = 24576 per channel: mean within 0.03, std within 3%,
    correlations within 0.03, about 4.7 standard errors)."""
    z = PK.philox_normal(torch.tensor([5, 6], dtype=torch.int32), (2, 3, 96, 128))
    planes = z.permute(1, 0, 2, 3).reshape(3, -1).double()
    for c in range(3):
        assert abs(planes[c].mean().item()) < 0.03 and abs(planes[c].std().item() - 1.0) < 0.03
    corr = torch.corrcoef(planes)
    assert (corr - torch.eye(3, dtype=torch.float64)).abs().max().item() < 0.03


def test_augment_on_cpu_never_touches_the_kernel_library(monkeypatch):
    """A CPU batch runs the plain version: the kernel library is never
    loaded and the launch counter does not move.  The result equals
    rsp_augment_plain on the same draws and the seeds drawn after them."""

    def refuse(*_):
        raise AssertionError("the kernel library was loaded for a CPU tensor")

    monkeypatch.setattr(build, "load_library", refuse)
    monkeypatch.setattr(RK, "_library", refuse)
    d = _inputs(32, seed=3)
    tiles = torch.from_numpy(d["tiles"])
    before = RK.launches
    got = TB.augment_rsp_batch_v1(torch.Generator().manual_seed(4), tiles, mean=MEAN, std=STD,
                                  out_dtype=torch.bfloat16)
    assert RK.launches == before
    g = torch.Generator().manual_seed(4)
    draws = TB.draw_rsp_v1(g, 12, 32)
    seeds = PK.draw_seeds(g, 12)
    want = RK.rsp_augment_plain(tiles, draws["geo"], draws["params"], seeds, None, MEAN, STD,
                                torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_kernel_wrapper_rejects_cpu_tensors():
    d = _inputs(32)
    n = len(d["mats"])
    with pytest.raises(ValueError, match="CUDA"):
        RK.rsp_augment_cuda(torch.from_numpy(d["tiles"]), torch.from_numpy(d["mats"]),
                            torch.from_numpy(d["params"]), torch.zeros(n, dtype=torch.int32), None,
                            MEAN, STD)


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """The build key covers the .cu file and the headers of csrc/ it
    includes: editing photometric_common.cuh changes every kernel's library
    path, editing warp_plan.cuh those of the two kernels that warp, editing
    one .cu only its own."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc, ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    monkeypatch.setattr(build, "CSRC", str(csrc))
    names = ("rsp_augment", "photometric_chain", "strong_views")
    assert build.sources("rsp_augment") == ["rsp_augment.cu", "photometric_common.cuh", "warp_plan.cuh"]
    assert build.sources("photometric_chain") == ["photometric_chain.cu", "photometric_common.cuh"]
    assert build.sources("strong_views") == ["strong_views.cu", "photometric_common.cuh", "warp_plan.cuh"]
    before = {k: build.library_path(k) for k in names}
    with open(os.path.join(csrc, "photometric_common.cuh"), "a") as f:
        f.write("\n// edited\n")
    mid = {k: build.library_path(k) for k in names}
    assert all(mid[k] != before[k] for k in names)
    with open(os.path.join(csrc, "warp_plan.cuh"), "a") as f:
        f.write("\n// edited\n")
    warped = {k: build.library_path(k) for k in names}
    assert [warped[k] != mid[k] for k in names] == [True, False, True]
    with open(os.path.join(csrc, "rsp_augment.cu"), "a") as f:
        f.write("\n// edited\n")
    assert build.library_path("rsp_augment") != warped["rsp_augment"]
    assert build.library_path("photometric_chain") == warped["photometric_chain"]
    assert build.library_path("strong_views") == warped["strong_views"]


def test_port_import_sets_up_mkl_before_a_parallel_log():
    """The cause of test_plain_matches_jax_composition (and of
    test_torch_consistency_aug.py's colour test) failing in one worker of a
    run in a few: PyTorch's CPU log hands each 2048-element chunk of a
    parallel loop to MKL's vector math library, which sets itself up on its
    first call, and when several threads make that first call at once one
    chunk can come out off by up to 4e-5 (in about one fresh process in ten
    on an 8-core host, tests/mkl_first_call_race.py).  Importing the port first makes one such call on one
    thread (``ssl_cr_histo_tpu_torch/__init__.py``).  Eight fresh processes
    that import the port and then take a parallel log of 16384 values: every
    value within 1e-6 of float64."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import numpy as np, torch\n"
        "import ssl_cr_histo_tpu_torch\n"
        "x = np.random.default_rng(0).random(16384).astype(np.float32) + 2.0\n"
        "print(float(np.abs(torch.log(torch.from_numpy(x)).numpy() - np.log(x.astype(np.float64))).max()))\n"
    )
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=repo, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(8)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    errs = [float(out) for out, _ in outs]
    assert max(errs) <= 1e-6, errs
