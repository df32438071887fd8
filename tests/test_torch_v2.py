"""The port's v2 pool against the JAX package on the CPU: the gather warp
and the shears, the PIL ops, ``autocontrast``, ``equalize``, the HED and HSB
colour augmenters, each op on the same inputs and parameters;
``augment_rsp_batch_v2`` in ``fused``, ``masked`` and ``exact`` mode on draws
rebuilt from the JAX key; the v2 draw laws by distribution.

``jax_v2_draws`` rebuilds the port's draws dict from the JAX key with the
same ``jax.random`` calls in the same order (``batch.py:83-102``,
``fused.py:480-627``, ``randaugment.py:335-449``).  Inputs are made with numpy
from a seed.  Float32 on both sides; the quantized ops (``equalize``,
``autocontrast``, PIL's gray level and the ops built on it) equal exactly.
torch runs on one intra-op thread."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssl_cr_histo_tpu.ops import batch as JB
from ssl_cr_histo_tpu.ops import geometry as JG
from ssl_cr_histo_tpu.ops import photometric as JP
from ssl_cr_histo_tpu.ops import stain as JS
from ssl_cr_histo_tpu.ops.randaugment import _MAX_LEVEL, _enh_factor, _signflip
from ssl_cr_histo_tpu.parallel import steps as JSteps
from ssl_cr_histo_tpu_torch.ops import batch as TB
from ssl_cr_histo_tpu_torch.ops import fused as TF
from ssl_cr_histo_tpu_torch.ops import geometry as TG
from ssl_cr_histo_tpu_torch.ops import photometric as TP
from ssl_cr_histo_tpu_torch.ops import randaugment as RA
from ssl_cr_histo_tpu_torch.ops import stain as TS

N, MAG = 2, 3.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def planar(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def hwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _images(seed, n=6, s=19):
    """Random pixels; image 1 on two gray levels a channel, image 2 on one
    level (equalize's identity cases), image 3 dark (outside the HED gate),
    image 4 a uint8 image / 255 with pixels on PIL's rounding edges."""
    rng = np.random.default_rng(seed)
    img = rng.random((n, s, s, 3)).astype(np.float32)
    img[1] = np.where(rng.random((s, s, 3)) < 0.5, 0.2, 0.8).astype(np.float32)
    img[2] = 0.5
    if n > 4:
        img[3] *= 0.1
        img[4] = rng.integers(0, 256, (s, s, 3)).astype(np.float32) / 255.0
        img[4, 0, :3] = np.array([[253, 63, 148], [0.5, 1.5, 2.5], [254.5, 127.5, 128.5]], np.float32) / 255.0
    return img


# --- ops ------------------------------------------------------------------------


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
@pytest.mark.parametrize("pad_mode", ["constant", "reflect101", "edge"])
def test_warp_affine_matches_jax(interp, pad_mode):
    """The gather warp on the same images and maps (rotations past the
    corners, a shear, a translation by a fraction, an up-scaling map)
    against the JAX function, atol 1e-5; nearest picks the same pixels."""
    img = _images(0, n=4)
    s = img.shape[1]
    mats = np.stack([np.asarray(JG.rotation_matrix(jnp.float32(a), s, s)) for a in (-37.0, 81.0)]
                    + [np.asarray(JG.shear_x_matrix(jnp.float32(0.27))),
                       np.asarray(JG.translation_matrix(jnp.float32(-3.4), jnp.float32(2.6)))])
    mats[3, :2, :2] *= 0.7
    got = TG.warp_affine(planar(img), torch.from_numpy(mats), interp=interp, pad_mode=pad_mode, fill=0.25)
    want = jax.vmap(lambda im, m: JG.warp_affine(im, m, interp=interp, pad_mode=pad_mode, fill=0.25))(
        jnp.asarray(img), jnp.asarray(mats))
    np.testing.assert_allclose(hwc(got), np.asarray(want), rtol=0, atol=1e-5)


def test_matrices_and_rot90_match_jax():
    """shear_x / shear_y matrices equal the JAX builders; rot90 for k in
    0..3, as an int and per image, equals ``jnp.rot90`` on (H, W)."""
    lv = np.array([-0.3, 0.0, 0.17], np.float32)
    for name in ("shear_x_matrix", "shear_y_matrix"):
        np.testing.assert_array_equal(getattr(TG, name)(torch.from_numpy(lv)).numpy(),
                                      np.asarray(jax.vmap(getattr(JG, name))(lv)))
    img = _images(1, n=4, s=7)
    for k in range(4):
        np.testing.assert_array_equal(hwc(TG.rot90(planar(img), k)), np.asarray(JG.rot90(jnp.asarray(img), k)))
    per = TG.rot90(planar(img), torch.tensor([0, 1, 2, 3]))
    for k in range(4):
        np.testing.assert_array_equal(hwc(per)[k], np.asarray(JG.rot90(jnp.asarray(img[k]), k)))


@pytest.mark.parametrize("op", ["pil_brightness", "pil_contrast", "pil_color", "pil_sharpness", "_pil_gray255",
                                "autocontrast", "equalize"])
def test_pil_op_matches_jax(op):
    """Each PIL op per image against the JAX op (vmapped) at enhance factors
    across 0.1-1.9, on images that include two-level and one-level ones:
    equal exactly (PIL's integer gray level, the contrast mean, the
    equalize LUT and the blends computed from them)."""
    img = _images(2)
    x, xj = planar(img), jnp.asarray(img)
    f = np.array([0.1, 1.9, 0.55, 1.0, 1.37, 0.73], np.float32)
    if op == "_pil_gray255":
        got, want = TP._pil_gray255(x).numpy(), np.asarray(jax.vmap(JP._pil_gray255)(xj))
        assert got[4, 0, 0] == 129  # PIL's fixed point at RGB (253, 63, 148)
    elif op in ("autocontrast", "equalize"):
        got, want = hwc(getattr(TP, op)(x)), np.asarray(jax.vmap(getattr(JP, op))(xj))
    else:
        got = hwc(getattr(TP, op)(x, torch.from_numpy(f)))
        want = np.asarray(jax.vmap(getattr(JP, op))(xj, f))
    np.testing.assert_array_equal(got, want)
    if op == "equalize":
        # one level: the identity LUT on the uint8 grid; two levels: two
        np.testing.assert_array_equal(got[2], np.round(img[2] * 255) / 255)
        assert all(len(np.unique(got[1][..., c])) == 2 for c in range(3))


def test_stain_augmenters_match_jax():
    """hed_color_augment with images inside and outside the [0.15, 0.85]
    mean gate, and hsb_color_augment with negative and positive sigmas
    (hue sigmas past +-1, which the floor modulo wraps), against the JAX
    functions: atol 1e-5; the gated-out image unchanged."""
    img = _images(3)
    x, xj = planar(img), jnp.asarray(img)
    rng = np.random.default_rng(3)
    sig, bias = rng.uniform(-0.2, 0.2, (6, 3)).astype(np.float32), rng.uniform(-0.2, 0.2, (6, 3)).astype(np.float32)
    got = hwc(TS.hed_color_augment(x, torch.from_numpy(sig), torch.from_numpy(bias)))
    np.testing.assert_allclose(got, np.asarray(jax.vmap(JS.hed_color_augment)(xj, sig, bias)), rtol=0, atol=1e-5)
    assert img[3].mean() < 0.15 and (got[3] == img[3]).all() and not (got[0] == img[0]).all()
    hsb = np.array([[-1.3, -0.5, -0.4], [1.2, 0.6, 0.3], [-0.2, 0.4, -0.1], [0.7, -0.3, 0.5], [0.0, 0.0, 0.0],
                    [-0.05, 0.09, 0.09]], np.float32)
    np.testing.assert_allclose(hwc(TS.hsb_color_augment(x, torch.from_numpy(hsb))),
                               np.asarray(jax.vmap(JS.hsb_color_augment)(xj, hsb)), rtol=0, atol=1e-5)


# --- the policies -----------------------------------------------------------------


def _jax_v2_params(op, val, key):
    """The (N_PARAMS,) row of v2 op ``op`` at magnitude ``val`` drawn from
    ``key`` as the JAX op draws it (``randaugment.py:335-411``)."""
    p = [0.0] * RA.N_PARAMS
    name = RA.V2_POOL[op]
    val = jnp.float32(val)
    if name in ("contrast", "brightness", "sharpness", "color"):
        p[0] = float(_enh_factor(val))
    elif name == "rotate":
        p[0] = float(_signflip(key, (val / _MAX_LEVEL) * 30.0))
    elif name in ("translate_x", "translate_y"):
        p[0] = float(_signflip(key, (val / _MAX_LEVEL) * 10.0))
    elif name in ("shear_x", "shear_y"):
        p[0] = float(_signflip(key, (val / _MAX_LEVEL) * 0.3))
    elif name == "hed":
        f = val * 0.03
        ks, kb = jax.random.split(key)
        p = np.concatenate([np.asarray(jax.random.uniform(ks, (3,), minval=-f, maxval=f)),
                            np.asarray(jax.random.uniform(kb, (3,), minval=-f, maxval=f))]).tolist()
    elif name == "hsv":
        f = val * 0.03
        kh, ks = jax.random.split(key)
        p[:2] = [float(jax.random.uniform(kh, (), minval=-f, maxval=f)),
                 float(jax.random.uniform(ks, (), minval=-f, maxval=f))]
    return p


def jax_v2_draws(key, n_tiles, mode, n=N, m=MAG):
    """The draws of JB.augment_rsp_batch_v2(key, triplets, n, m, mode) for
    ``n_tiles`` tiles: one key a tile; fused and exact draw n ops of a
    permutation and a magnitude and key a stage, masked a rank-selected set
    of the 14 ops with a magnitude and key each."""
    ops, params, present = [], [], []
    for k in jax.random.split(key, n_tiles):
        if mode == "masked":
            kperm, kvals, kparams = jax.random.split(k, 3)
            present.append(np.asarray(jnp.argsort(jax.random.uniform(kperm, (14,))) < n).tolist())
            vals = np.asarray(jax.random.uniform(kvals, (14,), minval=1.0, maxval=float(m)))
            ops.append(list(range(14)))
            params.append([_jax_v2_params(i, vals[i], ki) for i, ki in enumerate(jax.random.split(kparams, 14))])
        else:
            kperm, kstages = jax.random.split(k)
            order = np.asarray(jax.random.permutation(kperm, 14))[:n]
            rows = []
            for op, ks in zip(order, jax.random.split(kstages, n)):
                kmag, kparam = jax.random.split(ks)
                rows.append(_jax_v2_params(int(op), jax.random.uniform(kmag, (), minval=1.0, maxval=float(m)), kparam))
            ops.append(order.tolist())
            params.append(rows)
    d = {"ops": torch.tensor(ops), "params": torch.tensor(params, dtype=torch.float32)}
    if mode == "masked":
        d["present"] = torch.tensor(present)
    return d


# (key seed, triplets, NAug): keys whose tiles draw every op of the pool
V2_KEYS = {"fused": (1, 6, 4), "masked": (2, 4, 6), "exact": (3, 6, 4)}


@pytest.mark.parametrize("mode", ["fused", "masked", "exact"])
def test_augment_rsp_batch_v2_matches_jax(mode):
    """augment_rsp_batch_v2 under ``mode`` with an ordering and the draws
    rebuilt from the key against the JAX package's step path (permute the
    uint8 triplets, then augment_rsp_batch_v2(key, ., n, 3, mode)), float32
    at 32^2, atol 1e-5.  Every op of the pool is drawn.

    The composed maps of fused and masked mix rotations, translations and
    shears: a map without a shear keeps |a| = |e| bit for bit in both
    packages (a translation's linear part is exact), and a shear breaks the
    tie, so no map here meets the transpose tie (ROADMAP Queue 3 item 3).
    exact warps each op on its own (PIL's nearest for rotate and translate,
    bilinear for the shears), as the JAX package does."""
    seed, b, n = V2_KEYS[mode]
    s = 32
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 256, (b, 3, s, s, 3), dtype=np.uint8)
    labels = rng.integers(0, 6, b).astype(np.int32)
    permuted = JSteps.permute_triplets(jnp.asarray(tiles), jnp.asarray(labels))
    want = np.asarray(JB.augment_rsp_batch_v2(key, permuted, n=n, m=MAG, mode=mode))
    d = jax_v2_draws(key, b * 3, mode, n=n)
    drawn = d["ops"][d["present"]] if mode == "masked" else d["ops"]
    assert set(drawn.flatten().tolist()) == set(range(14))
    got = TB.augment_rsp_batch_v2(None, torch.from_numpy(tiles), n, MAG, mode=mode, draws=d,
                                  order=torch.from_numpy(labels))
    assert got.shape == (b, 3, 3, s, s) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), want, rtol=0, atol=1e-5)


def test_v2_draws_and_modes():
    """With no draws each mode draws from the CPU generator, the same views
    for the same seed; a generator on another device is refused; the fast
    mode is the masked one (as in the JAX package); a bf16 output."""
    tiles = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 3, 16, 16, 3), dtype=np.uint8))
    for mode in ("fused", "masked", "exact"):
        a, b = (TB.augment_rsp_batch_v2(torch.Generator().manual_seed(0), tiles, mode=mode) for _ in range(2))
        assert torch.equal(a, b) and a.shape == (2, 3, 3, 16, 16)
    fast = TB.augment_rsp_batch_v2(torch.Generator().manual_seed(0), tiles, mode="fast", out_dtype=torch.bfloat16)
    masked = TB.augment_rsp_batch_v2(torch.Generator().manual_seed(0), tiles, mode="masked")
    assert fast.dtype == torch.bfloat16 and torch.equal(fast, masked.to(torch.bfloat16))
    with pytest.raises(ValueError, match="aug mode"):
        TB.augment_rsp_batch_v2(torch.Generator(), tiles, mode="other")


def test_v2_draw_law_matches_jax():
    """The v2 draws by distribution over 12000 tiles: fused/exact draw n
    distinct ops, each op 1/14 of the draws (JAX's permutation too);
    masked selects exactly n ops without replacement, each present with
    probability n/14 (JAX's rank rule too); magnitudes uniform on [1, m);
    the sign flips at 0.5; every parameter within its JAX range at its
    magnitude."""
    t, n = 12000, N
    d = RA.draw_v2(torch.Generator().manual_seed(0), t, n, MAG)
    ops = d["ops"].numpy()
    assert ops.shape == (t, n) and (ops[:, 0] != ops[:, 1]).all()
    jops = np.asarray(jax.vmap(lambda k: jax.random.permutation(jax.random.split(k)[0], 14)[:n])(
        jax.random.split(jax.random.PRNGKey(1), 3000)))
    for a in (ops, jops):
        np.testing.assert_allclose(np.bincount(a.ravel(), minlength=14) / a.size, 1 / 14, atol=0.012)
    dm = RA.draw_v2(torch.Generator().manual_seed(1), t, n, MAG, masked=True)
    assert (dm["present"].sum(1) == n).all() and (dm["ops"] == torch.arange(14)).all()
    jpresent = np.asarray(jax.vmap(lambda k: jnp.argsort(jax.random.uniform(jax.random.split(k, 3)[0], (14,))) < n)(
        jax.random.split(jax.random.PRNGKey(2), 3000)))
    assert (jpresent.sum(1) == n).all()
    for a in (dm["present"].numpy(), jpresent):
        np.testing.assert_allclose(a.mean(0), n / 14, atol=0.03)
    vals, p = d["vals"].numpy(), d["params"].numpy()
    assert vals.min() >= 1.0 and vals.max() < MAG
    np.testing.assert_allclose(vals.mean(), (1 + MAG) / 2, atol=0.02)
    for op, name in enumerate(RA.V2_POOL):
        sel = ops == op
        v, q = vals[sel], p[sel]
        if name in ("contrast", "brightness", "sharpness", "color"):
            np.testing.assert_allclose(q[:, 0], (v / 10) * 1.8 + 0.1, rtol=1e-6)
        elif name in ("rotate", "translate_x", "translate_y", "shear_x", "shear_y"):
            scale = {"rotate": 30.0, "shear_x": 0.3, "shear_y": 0.3}.get(name, 10.0)
            np.testing.assert_allclose(np.abs(q[:, 0]), v / 10 * scale, rtol=1e-6)
            np.testing.assert_allclose((q[:, 0] > 0).mean(), 0.5, atol=0.05)
        elif name in ("hed", "hsv"):
            k = 6 if name == "hed" else 2
            assert (np.abs(q[:, :k]) <= 0.03 * v[:, None] + 1e-7).all() and (q[:, k:] == 0).all()
            np.testing.assert_allclose((np.abs(q[:, :k]) / (0.03 * v[:, None])).mean(), 0.5, atol=0.03)
        else:
            assert (q == 0).all()


def test_v2_composed_matrix_matches_jax_products():
    """Each tile's composed v2 map against the JAX package's ``g @ mat``
    products of its stage matrices (float32, rtol 1e-6 / atol 1e-5)."""
    key, t, s = jax.random.PRNGKey(9), 24, 32
    d = jax_v2_draws(key, t, "fused", n=4)
    makers = {4: lambda p: JG.rotation_matrix(p, s, s), 5: lambda p: JG.translation_matrix(p, 0.0),
              6: lambda p: JG.translation_matrix(0.0, p), 7: JG.shear_x_matrix, 8: JG.shear_y_matrix}
    want = []
    for ops, params in zip(d["ops"].tolist(), d["params"].numpy()):
        g = jnp.eye(3, dtype=jnp.float32)
        for op, p in zip(ops, params):
            if op in makers:
                g = g @ makers[op](jnp.float32(p[0]))
        want.append(np.asarray(g))
    np.testing.assert_allclose(TF.v2_pool_matrix(d["ops"], d["params"], s).numpy(), np.stack(want),
                               rtol=1e-6, atol=1e-5)
