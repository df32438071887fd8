"""The port's consistency views (the fused v1 strong pool and TransformFix)
against the JAX package on the CPU: each colour, stain, photometric and flip
op on the same inputs and parameters; ``transform_fix_batch`` against the
JAX package's ``transform_fix_batch(key, imgs, mode="fused")`` on draws
rebuilt from the key; the draw laws by distribution.

The JAX package draws inside each op from a tree of key splits
(``ops/fused.py:229-301``, ``ops/randaugment.py:55-137``); ``jax_fix_draws``
rebuilds the port's draws dict with the same ``jax.random`` calls in the same
order.  Inputs are made with numpy from a seed.  Float32 on both sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssl_cr_histo_tpu.ops import batch as JB
from ssl_cr_histo_tpu.ops import color as JC
from ssl_cr_histo_tpu.ops import fused as JF
from ssl_cr_histo_tpu.ops import geometry as JG
from ssl_cr_histo_tpu.ops import photometric as JP
from ssl_cr_histo_tpu.ops import stain as JS
from ssl_cr_histo_tpu.ops.randaugment import _mag_v1
from ssl_cr_histo_tpu_torch.ops import batch as TB
from ssl_cr_histo_tpu_torch.ops import color as TC
from ssl_cr_histo_tpu_torch.ops import fused as TF
from ssl_cr_histo_tpu_torch.ops import geometry as TG
from ssl_cr_histo_tpu_torch.ops import photometric as TP
from ssl_cr_histo_tpu_torch.ops import randaugment as RA
from ssl_cr_histo_tpu_torch.ops import stain as TS


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


N_AUG, M = 7, 10


def planar(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def hwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _images(seed, n=6, s=19):
    """Random pixels, then gray pixels, ties of two channel maxima (r = g,
    r = b, g = b above the third), and hues just either side of the wrap
    (r max, b a hair above and below g)."""
    img = np.random.default_rng(seed).random((n, s, s, 3)).astype(np.float32)
    img[0, 0, :5] = np.array([0.0, 0.3, 0.5, 0.999, 1.0], np.float32)[:, None]
    img[0, 1, :4] = [[0.7, 0.7, 0.2], [0.6, 0.1, 0.6], [0.2, 0.8, 0.8], [0.5, 0.5, 0.5]]
    img[0, 2, :4] = [[0.9, 0.3, 0.3 + 1e-6], [0.9, 0.3 + 1e-6, 0.3], [0.8, 0.2, 0.2000001], [1.0, 0.0, 0.0]]
    return img


# --- colour, stain, photometric and flip ops --------------------------------


def test_color_conversions_match_jax():
    """rgb2hsv, hsv2rgb, rgb2hed and hed2rgb (planar) against the JAX
    functions (channels last) on the same pixels, incl. gray pixels, ties
    of the channel maxima and the hue wrap: atol 1e-6; the hues of the
    special pixels equal exactly."""
    img = _images(0)
    got_hsv = TC.rgb2hsv(planar(img))
    want_hsv = np.asarray(JC.rgb2hsv(jnp.asarray(img)))
    np.testing.assert_allclose(hwc(got_hsv), want_hsv, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(hwc(got_hsv)[0, :3, :5, 0], want_hsv[0, :3, :5, 0])
    assert (want_hsv[0, 0, :5, 0] == 0).all() and want_hsv[0, 2, 0, 0] > 0.99 and want_hsv[0, 2, 1, 0] < 1e-5
    hsv = np.random.default_rng(1).random((4, 13, 13, 3)).astype(np.float32)
    hsv[..., 0] = hsv[..., 0] * 3.0 - 1.0  # hues outside [0, 1) wrap
    np.testing.assert_allclose(hwc(TC.hsv2rgb(planar(hsv))), np.asarray(JC.hsv2rgb(jnp.asarray(hsv))),
                               rtol=0, atol=1e-6)
    hed = TC.rgb2hed(planar(img))
    np.testing.assert_allclose(hwc(hed), np.asarray(JC.rgb2hed(jnp.asarray(img))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(hwc(TC.hed2rgb(hed)), np.asarray(JC.hed2rgb(JC.rgb2hed(jnp.asarray(img)))),
                               rtol=0, atol=1e-6)
    # the reference's legacy-skimage round trip is (x + 1) / 2
    np.testing.assert_allclose(hwc(TC.hed2rgb(hed)), (img + 1) / 2, rtol=0, atol=1e-6)


def test_chain_hsv_planes_are_the_color_functions():
    """The photometric chain's plain version converts through
    color.rgb2hsv_planes / hsv2rgb_planes, the functions held to JAX's
    color.rgb2hsv above (the Pallas chain's own helpers have the same
    formulas, ``pallas_photometric.py:98-130``)."""
    from ssl_cr_histo_tpu.ops import pallas_photometric as PP

    img = _images(2)
    r, g, b = (jnp.asarray(img[..., c]) for c in range(3))
    want = np.stack([np.asarray(c) for c in PP._rgb2hsv_planes(r, g, b)], 1)
    got = torch.stack(TC.rgb2hsv_planes(*planar(img).unbind(1)), 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _per_image(rng, n, lo, hi):
    return rng.uniform(lo, hi, n).astype(np.float32)


@pytest.mark.parametrize("op", ["brightness_contrast", "hsv_shift", "gaussian_noise", "box_blur", "hed_shift",
                                "flip_horizontal", "flip_vertical"])
def test_op_matches_jax(op):
    """Each op of the v1 pool, per image, against the JAX op on the same
    image and parameters (vmapped over the images), atol 1e-6; magnitudes
    past the clip points, so that every clip of the JAX op is exercised."""
    n = 6
    rng = np.random.default_rng(3)
    img = _images(4, n)
    x, xj = planar(img), jnp.asarray(img)
    if op == "brightness_contrast":
        b, c = _per_image(rng, n, -0.6, 0.6), _per_image(rng, n, -0.6, 0.6)
        got, want = TP.brightness_contrast(x, torch.from_numpy(b), torch.from_numpy(c)), \
            jax.vmap(JP.brightness_contrast)(xj, b, c)
    elif op == "hsv_shift":
        hs, ss, vs = (_per_image(rng, n, -60, 60) for _ in range(3))
        got = TP.hsv_shift(x, torch.from_numpy(hs), torch.from_numpy(ss), torch.from_numpy(vs))
        want = jax.vmap(JP.hsv_shift)(xj, hs, ss, vs)
    elif op == "gaussian_noise":
        keys = jax.random.split(jax.random.PRNGKey(5), n)
        sig = _per_image(rng, n, 0.0, 0.5)
        want = jax.vmap(JP.gaussian_noise)(xj, keys, sig)
        noise = np.stack([np.asarray(jax.random.normal(k, img.shape[1:], jnp.float32)) for k in keys])
        got = TP.gaussian_noise(x, planar(noise), torch.from_numpy(sig))
    elif op == "box_blur":
        k = np.array([3, 5, 3, 5, 5, 3], np.float32)
        got = TP.box_blur(x, torch.from_numpy(k), max_ksize=5)
        want = jax.vmap(lambda im, kk: JP.box_blur(im, kk, max_ksize=5))(xj, k)
    elif op == "hed_shift":
        d = [rng.normal(size=n).astype(np.float32) * 0.05 for _ in range(3)]
        got = TS.hed_shift(x, *(torch.from_numpy(v) for v in d))
        want = jax.vmap(JS.hed_shift)(xj, *d)
    else:
        got, want = getattr(TG, op)(x), getattr(JG, op)(xj)
    np.testing.assert_allclose(hwc(got), np.asarray(want), rtol=0, atol=1e-6)


def test_identity_warp_gives_the_image_back():
    """An identity composed matrix warps each image to itself within 1e-6
    (an image whose strong stages draw no geometric op, or gate them off)."""
    x = planar(_images(6))
    g = torch.eye(3).expand(x.shape[0], 3, 3)
    np.testing.assert_allclose(TG.warp_affine_planar(x, g, pad_mode="reflect101").numpy(), x.numpy(),
                               rtol=0, atol=1e-6)


# --- the v1 strong pool ------------------------------------------------------


def _jax_op_params(op, v, kparam, s):
    """The (N_PARAMS,) param row of op ``op`` at magnitude ``v`` drawn from
    ``kparam`` exactly as the JAX op draws it (``randaugment.py:55-137``,
    ``fused.py:66-76``, ``:203-226``), and its (H, W, 3) noise field or
    None."""
    u = lambda k, lo, hi: float(jax.random.uniform(k, (), minval=lo, maxval=hi))
    bern = lambda k: float(jax.random.bernoulli(k))
    v = jnp.int32(v)
    p, noise = [0.0] * RA.N_PARAMS, None
    name = RA.V1_POOL[op]
    if name == "hsv":
        val = jnp.abs(_mag_v1(v, -1.0, 1.0))
        kh, ks, kv, kp = jax.random.split(kparam, 4)
        p[:3], p[RA.GATE] = [u(kh, -val, val), u(ks, -val, val), u(kv, -val, val)], bern(kp)
    elif name == "noise":
        ks, kn, kp = jax.random.split(kparam, 3)
        p[0], p[RA.GATE] = u(ks, 0.0, _mag_v1(v, 0.0, 0.15)), bern(kp)
        noise = np.asarray(jax.random.normal(kn, (s, s, 3), jnp.float32))
    elif name == "scale_resize_crop":
        ky, kx = jax.random.split(kparam)
        p[:2], p[RA.GATE] = [int(jax.random.randint(ky, (), 0, 21)), int(jax.random.randint(kx, (), 0, 21))], 1.0
    elif name == "shift_scale_rotate":
        val = _mag_v1(v, 0.01, 0.1)
        kx, ky, ks, ka, kp = jax.random.split(kparam, 5)
        p[:4] = [u(kx, -val, val), u(ky, -val, val), u(ks, 1.0 - (val + 0.5), 1.0 + (val + 0.5)),
                 u(ka, -90.0, 90.0)]
        p[RA.GATE] = bern(kp)
    elif name == "color":
        ksig, knorm = jax.random.split(kparam)
        sigma = jax.random.uniform(ksig, (3,), minval=-0.035, maxval=0.035)
        p[:3], p[RA.GATE] = np.asarray(jax.random.normal(knorm, (3,)) * sigma).tolist(), 1.0
    elif name == "blur":
        kk, kp = jax.random.split(kparam)
        p[0], p[RA.GATE] = float(3 + 2 * jax.random.randint(kk, (), 0, 2)), bern(kp)
    elif name in ("brightness", "contrast"):
        val = jnp.abs(_mag_v1(v, -0.2, 0.2))
        kb, kc, kp = jax.random.split(kparam, 3)
        if name == "brightness":
            p[:2] = [u(kb, -val, val), u(kc, -0.2, 0.2)]
        else:
            p[:2] = [u(kb, -0.2, 0.2), u(kc, -val, val)]
        p[RA.GATE] = bern(kp)
    else:  # rotate_crop
        val = jnp.abs(_mag_v1(v, -90.0, 90.0))
        kf, ka, kp = jax.random.split(kparam, 3)
        kd, kfp = jax.random.split(kf)
        p[:3] = [u(ka, -val, val), int(jax.random.randint(kd, (), 0, 3)), bern(kfp)]
        p[RA.GATE] = bern(kp)
    return p, noise


def jax_fix_draws(key, b, s, n=N_AUG, m=M):
    """The draws of JB.transform_fix_batch(key, imgs, n, m, mode="fused")
    for b images of s^2, rebuilt with the same jax.random calls in the same
    order (``batch.py:152-160``, ``fused.py:229-301``), as the port's dict."""
    out = {k: [] for k in ("weak_flip", "strong_flip", "ops", "mags", "params")}
    noise = []
    for k in jax.random.split(key, b):
        kw, ks1, ks2 = jax.random.split(k, 3)
        out["weak_flip"].append(bool(jax.random.bernoulli(kw)))
        out["strong_flip"].append(bool(jax.random.bernoulli(ks1)))
        ops, mags, params = [], [], []
        for ks in jax.random.split(ks2, n):
            kop, kmag, kparam = jax.random.split(ks, 3)
            op, v = int(jax.random.randint(kop, (), 0, 9)), int(jax.random.randint(kmag, (), 1, m))
            p, nz = _jax_op_params(op, v, kparam, s)
            ops.append(op)
            mags.append(v)
            params.append(p)
            if nz is not None:
                noise.append(nz.transpose(2, 0, 1))
        out["ops"].append(ops)
        out["mags"].append(mags)
        out["params"].append(params)
    d = {k: torch.tensor(v) for k, v in out.items()}
    d["params"] = d["params"].float()
    d["noise"] = torch.from_numpy(np.stack(noise)) if noise else torch.zeros(0, 3, s, s)
    return d


def jax_composed_maps(key, b, s):
    """(b, 3, 3) composed strong-pool matrices as the JAX package computes
    them inside transform_fix_batch: the ``_ra1_geo_*`` stage matrices
    multiplied ``g @ mat`` in a jitted, vmapped scan."""
    geo = [None, None, JF._ra1_geo_scale_resize_crop, JF._ra1_geo_shift_scale_rotate, None, None, None, None,
           JF._ra1_geo_rotate_crop]
    branches = [(lambda a, f=f: a[0] @ f(None, a[1], a[2], s)[1]) if f else (lambda a: a[0]) for f in geo]

    def one(k):
        def prep(ks):
            kop, kmag, kparam = jax.random.split(ks, 3)
            return jax.random.randint(kop, (), 0, 9), jax.random.randint(kmag, (), 1, M), kparam

        ops, mags, kparams = jax.vmap(prep)(jax.random.split(jax.random.split(k, 3)[2], N_AUG))

        def stage(g, xs):
            return jax.lax.switch(xs[0], branches, (g, xs[1], xs[2])), None

        return jax.lax.scan(stage, jnp.eye(3, dtype=jnp.float32), (ops, mags, kparams))[0]

    return np.asarray(jax.jit(jax.vmap(one))(jax.random.split(key, b)))


def _fixups(g, s):
    """Each map's (90-degree, transpose) fix-up flags in the two-pass warp."""
    return TG.warp_pass_coefficients(torch.from_numpy(np.array(g)), s)[:, 6:].numpy() > 0.5


@pytest.mark.parametrize("s", [32, 37])
def test_transform_fix_batch_matches_jax(s):
    """transform_fix_batch with the draws rebuilt from the key against the
    JAX package's transform_fix_batch(key, imgs, mode="fused"), float32,
    atol 1e-5 (the warp's and the blur's summation orders, the composed
    matrices' float32 products).  The keys are chosen so that all nine ops
    occur, gated on and off, and the composed maps fall on both sides of the
    warp's 90-degree fix-up.

    Every op of the pool is a similarity or a mirror, so every composed map
    has |a| = |e| in exact arithmetic: the warp's transpose fix-up
    (|a| > |e|) sits on its tie, and float32 rounding of the matrix
    products decides it, differently in XLA and in PyTorch for about one
    composition in twelve.  The two pass orders are both bilinear
    two-pass resamplings of the same map, but on random pixels they differ
    by up to 0.2.  So the keys are also chosen with no map on which the two
    packages' fix-ups differ, and the test asserts that first."""
    b = 12
    key = jax.random.PRNGKey({32: 7, 37: 11}[s])
    imgs = np.random.default_rng(s).integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    want_w, want_s = (np.asarray(a) for a in JB.transform_fix_batch(key, jnp.asarray(imgs), n=N_AUG, m=M,
                                                                     mode="fused"))
    d = jax_fix_draws(key, b, s)
    ops, gate = d["ops"], d["params"][..., RA.GATE] > 0.5
    assert set(ops.flatten().tolist()) == set(range(9))
    for op in (0, 1, 3, 5, 6, 7, 8):
        assert gate[ops == op].any() and (~gate[ops == op]).any(), RA.V1_POOL[op]
    g = TF.strong_pool_matrix(ops, d["params"], s)
    flags = _fixups(g, s)
    assert flags[:, 0].any() and (~flags[:, 0]).any()
    np.testing.assert_array_equal(flags, _fixups(jax_composed_maps(key, b, s), s))
    assert d["weak_flip"].any() and not d["weak_flip"].all()
    got_w, got_s = TB.transform_fix_batch(None, torch.from_numpy(imgs), N_AUG, M, draws=d)
    assert got_w.shape == got_s.shape == (b, 3, s, s) and got_s.dtype == torch.float32
    np.testing.assert_allclose(hwc(got_w), want_w, rtol=0, atol=1e-6)
    np.testing.assert_allclose(hwc(got_s), want_s, rtol=0, atol=1e-5)
    assert float(got_s.min()) >= 0.0 and float(got_s.max()) <= 1.0


def test_strong_pool_matrix_matches_jax_composition():
    """Each image's composed matrix against the JAX package's composition of
    its stage matrices, float32: rtol 1e-6 / atol 1e-5 (entries up to ~100
    on a 37^2 tile, where one float32 ulp is 7.6e-6), on 48 images."""
    s, b = 37, 48
    key = jax.random.PRNGKey(3)
    d = jax_fix_draws(key, b, s)
    got = TF.strong_pool_matrix(d["ops"], d["params"], s).numpy()
    np.testing.assert_allclose(got, jax_composed_maps(key, b, s), rtol=1e-6, atol=1e-5)


def test_transform_fix_batch_draws_and_modes():
    """With no draws it draws from the generators (tables on the host, the
    noise fields on the generator's device, one per noise stage); each
    other mode draws its own tables (tests/test_torch_aug_modes.py holds
    them to the JAX package) and an unknown mode is refused."""
    imgs = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (5, 16, 16, 3), dtype=np.uint8))
    weak, strong = TB.transform_fix_batch(torch.Generator().manual_seed(0), imgs)
    assert weak.shape == strong.shape == (5, 3, 16, 16)
    again = TB.transform_fix_batch(torch.Generator().manual_seed(0), imgs)
    assert torch.equal(strong, again[1])
    d = TB.draw_transform_fix(torch.Generator().manual_seed(1), 5, 16, host_gen=torch.Generator().manual_seed(2))
    assert d["noise"].shape == (int((d["ops"] == RA.NOISE).sum()), 3, 16, 16)
    for mode, shape in (("fast", (5, 7)), ("masked", (5, 9)), ("exact", (5, 7))):
        d = TB.draw_transform_fix(torch.Generator().manual_seed(1), 5, 16, mode=mode,
                                  host_gen=torch.Generator().manual_seed(2))
        assert d["ops"].shape == shape and ("present" in d) is (mode == "masked")
        weak, strong = TB.transform_fix_batch(torch.Generator().manual_seed(0), imgs, mode=mode)
        assert weak.shape == strong.shape == (5, 3, 16, 16)
    with pytest.raises(ValueError, match="aug mode"):
        TB.transform_fix_batch(torch.Generator(), imgs, mode="other")


def test_grouped_ops_equal_every_op_on_every_image():
    """randaugment_v1_fused runs each op on its group only; the result
    equals the compute-everything-and-select form of the JAX package's
    vmapped switch (each op on every image, kept where the image drew it),
    bit for bit."""
    s, b = 24, 10
    gen = torch.Generator().manual_seed(7)
    d = TB.draw_transform_fix(gen, b, s)
    x = torch.rand(b, 3, s, s, generator=gen)
    got = TF.randaugment_v1_fused(x, d)
    want = x.clone()
    slot = torch.cumsum((d["ops"] == RA.NOISE).flatten(), 0).view(b, -1) - 1
    for j in range(d["ops"].shape[1]):
        p = d["params"][:, j]
        for op in RA.PHOTOMETRIC:
            nz = d["noise"][slot[:, j].clamp_min(0)] if op == RA.NOISE and len(d["noise"]) else None
            if op == RA.NOISE and nz is None:
                continue
            out = RA.apply_photometric(op, want, p, nz)
            keep = (d["ops"][:, j] == op) & (p[:, RA.GATE] > 0.5)
            want = torch.where(keep.view(-1, 1, 1, 1), out, want)
    want = TG.warp_affine_planar(want, TF.strong_pool_matrix(d["ops"], d["params"], s), pad_mode="reflect101")
    assert torch.equal(got, want)


# --- the draw laws -----------------------------------------------------------


def _jax_law_sample(n_images, s=8):
    """(ops, mags, params) of JAX's draws for n_images images, vectorised
    with the same key tree as jax_fix_draws (no images are augmented)."""
    keys = jax.random.split(jax.random.PRNGKey(11), n_images)

    def one(k):
        ks2 = jax.random.split(k, 3)[2]

        def stage(ks):
            kop, kmag, kparam = jax.random.split(ks, 3)
            return jax.random.randint(kop, (), 0, 9), jax.random.randint(kmag, (), 1, M), kparam

        return jax.vmap(stage)(jax.random.split(ks2, N_AUG))

    ops, mags, kparams = jax.vmap(one)(keys)
    return np.asarray(ops), np.asarray(mags), kparams


def test_draw_law_matches_jax():
    """draw_transform_fix's laws against the JAX draws, by distribution over
    6000 images x 7 stages (each bound is over 5 standard errors): op
    frequencies 1/9, magnitudes uniform on 1..9, both flip coins and every
    op's gates at 0.5; and for each op, its parameters' ranges at every
    magnitude and their means against JAX's own draws of that op."""
    n = 6000
    d = TB.draw_transform_fix(torch.Generator().manual_seed(0), n, 8)
    ops, mags, p = d["ops"].numpy(), d["mags"].numpy(), d["params"].numpy()
    jops, jmags, _ = _jax_law_sample(n)
    for a in (ops, jops):
        np.testing.assert_allclose(np.bincount(a.ravel(), minlength=9) / a.size, 1 / 9, atol=0.008)
    for a in (mags, jmags):
        assert a.min() == 1 and a.max() == M - 1
        np.testing.assert_allclose(np.bincount(a.ravel(), minlength=M)[1:] / a.size, 1 / (M - 1), atol=0.008)
    for k in ("weak_flip", "strong_flip"):
        np.testing.assert_allclose(d[k].float().mean().item(), 0.5, atol=0.033)

    # per op: JAX's parameters for 2000 draws at random magnitudes
    rng = np.random.default_rng(0)
    keys = jax.random.split(jax.random.PRNGKey(12), 2000)
    vs = rng.integers(1, M, 2000)
    for op in range(9):
        sel = ops == op
        got, gv = p[sel], mags[sel]
        want = np.array([_jax_op_params(op, int(v), k, 4)[0] for v, k in zip(vs[:300], keys[:300])])
        name = RA.V1_POOL[op]
        if op in (0, 1, 3, 5, 6, 7, 8):
            np.testing.assert_allclose(got[:, RA.GATE].mean(), 0.5, atol=0.04, err_msg=name)
        else:
            assert (got[:, RA.GATE] == 1).all() and (want[:, RA.GATE] == 1).all()
        # ranges at each magnitude, as the JAX law states them
        v = gv.astype(np.float32)
        if name == "hsv":
            val = np.abs(v / 30 * 2 - 1)
            assert (np.abs(got[:, :3]) <= val[:, None] + 1e-6).all()
            np.testing.assert_allclose((np.abs(got[:, :3]) / val[:, None]).mean(), 0.5, atol=0.02)
        elif name == "noise":
            val = v / 30 * 0.15
            assert (got[:, 0] >= 0).all() and (got[:, 0] <= val + 1e-7).all()
            np.testing.assert_allclose((got[:, 0] / val).mean(), 0.5, atol=0.03)
        elif name == "scale_resize_crop":
            assert set(np.unique(got[:, :2])) == set(range(21)) == set(np.unique(want[:, :2]))
        elif name == "shift_scale_rotate":
            val = v / 30 * 0.09 + 0.01
            assert (np.abs(got[:, :2]) <= val[:, None] + 1e-6).all()
            assert (np.abs(got[:, 2] - 1) <= val + 0.5 + 1e-6).all()
            assert (np.abs(got[:, 3]) <= 90).all() and np.abs(got[:, 3]).max() > 85
            np.testing.assert_allclose(np.abs(got[:, 3]).mean(), np.abs(want[:, 3]).mean(), atol=4.0)
        elif name == "color":
            assert np.abs(got[:, :3]).max() < 0.2
            np.testing.assert_allclose(got[:, :3].std(), want[:, :3].std(), rtol=0.15)
        elif name == "blur":
            assert set(np.unique(got[:, 0])) == {3.0, 5.0} == set(np.unique(want[:, 0]))
            np.testing.assert_allclose((got[:, 0] == 5).mean(), 0.5, atol=0.04)
        elif name in ("brightness", "contrast"):
            val = np.abs(v / 30 * 0.4 - 0.2)
            mag_col = 0 if name == "brightness" else 1
            assert (np.abs(got[:, mag_col]) <= val + 1e-6).all()
            assert (np.abs(got[:, 1 - mag_col]) <= 0.2 + 1e-6).all()
            np.testing.assert_allclose(np.abs(got[:, 1 - mag_col]).mean(), 0.1, atol=0.01)
        else:  # rotate_crop
            val = np.abs(v / 30 * 180 - 90)
            assert (np.abs(got[:, 0]) <= val + 1e-4).all()
            np.testing.assert_allclose(np.bincount(got[:, 1].astype(int), minlength=3) / len(got), 1 / 3, atol=0.04)
            np.testing.assert_allclose(got[:, 2].mean(), 0.5, atol=0.04)
            np.testing.assert_allclose(np.abs(got[:, 0]).mean(), np.abs(want[:, 0]).mean(), atol=6.0)
