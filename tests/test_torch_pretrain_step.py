"""The port's whole pretraining slice against the JAX package on the CPU:
one train step with injected draws, the 6-ordering eval step, the CLI end to
end, checkpoint interop, and the port's freedom from jax imports.

Weights are made by flax from a seed and carried over with
``from_jax_params``; tiles, labels, photometric params and noise are made
with numpy; warp matrices come from the port's draw and are handed to both
sides.  Float32 throughout.  IMG 64 (not 32) so that layer4 is 2x2, not 1x1:
BN over a 1x1 map normalises a handful of values per channel and amplifies
float noise (the instability of tests/test_torch_training_parity.py's
32^2 step)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn as tnn

import jax
import jax.numpy as jnp
import optax

from ssl_cr_histo_tpu.models import Classifier as JClassifier
from ssl_cr_histo_tpu.models import TripletNet as JTripletNet
from ssl_cr_histo_tpu.ops import batch as JB
from ssl_cr_histo_tpu.ops import geometry as JG
from ssl_cr_histo_tpu.ops import pallas_photometric as PP
from ssl_cr_histo_tpu.parallel import steps as JS
from ssl_cr_histo_tpu.train import optim as joptim
from ssl_cr_histo_tpu.train.checkpoint import export_torch_state_dict, load_torch_triplet_checkpoint
from ssl_cr_histo_tpu.train.init import init_triplet_state as j_init_state
from ssl_cr_histo_tpu_torch.ops import batch as TB
from ssl_cr_histo_tpu_torch.ops import fused as TF
from ssl_cr_histo_tpu_torch.ops import rsp_augment_kernel as RK
from ssl_cr_histo_tpu_torch.parallel import steps as TS
from ssl_cr_histo_tpu_torch.train.checkpoint import from_jax_params
from ssl_cr_histo_tpu_torch.train.init import init_triplet_state
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


IMG, B = 64, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _numpy_params(rng, n):
    """Photometric params with draw_params' law, numpy side."""
    p = np.zeros((n, PP.N_PARAMS), np.float32)
    p[:, 0] = rng.uniform(-0.1, 0.1, n)
    p[:, 1] = rng.uniform(-1, 1, n)
    p[:, 2] = rng.uniform(-20, 20, n)
    p[:, 3] = rng.integers(0, 2, n)
    p[:, 4] = rng.uniform(0, 0.1, n)
    p[:, 5] = rng.integers(0, 2, n)
    p[:, 6:9] = rng.normal(size=(n, 3)) * rng.uniform(-0.035, 0.035, (n, 3))
    p[:, 9] = 3.0 + 2.0 * rng.integers(0, 3, n)
    p[:, 10] = rng.integers(0, 2, n)
    p[:, 11] = rng.uniform(-0.2, 0.2, n)
    p[:, 12] = rng.uniform(-0.2, 0.2, n)
    p[:, 13] = rng.integers(0, 2, n)
    return p


@pytest.fixture(scope="module")
def setup():
    jm, jc = JTripletNet("resnet18"), JClassifier(num_classes=6)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    dummy = jnp.zeros((1, IMG, IMG, 3), jnp.float32)
    v = jm.init(k1, dummy, dummy, dummy, train=False)
    params = {"model": v["params"], "head": jc.init(k2, jnp.zeros((1, 768)))["params"]}
    stats = v["batch_stats"]
    rng = np.random.default_rng(0)
    n = B * 3
    data = {
        "tiles": rng.integers(0, 256, (B, 3, IMG, IMG, 3), dtype=np.uint8),
        "labels": rng.integers(0, 6, B).astype(np.int32),
        "geo": TF.draw_pretrain_geo_matrices(torch.Generator().manual_seed(3), n, IMG).numpy(),
        "params": _numpy_params(rng, n),
        "noise": rng.normal(size=(n, 3, IMG, IMG)).astype(np.float32),
    }
    return jm, jc, params, stats, data


def _port_state(params, stats):
    sd, head_sd = from_jax_params(jax.device_get(params["model"]), jax.device_get(stats),
                                  jax.device_get(params["head"]))
    torch.manual_seed(0)
    state = init_triplet_state("resnet18", torch.device("cpu"), lr=0.01, weight_decay=1e-4)
    state.model.load_state_dict(sd)
    state.classifier.load_state_dict(head_sd)
    return state


def _head_sd(head):
    return {f"classifier.{i}.{leaf}": (np.asarray(head[n]["kernel"]).T if leaf == "weight"
                                       else np.asarray(head[n]["bias"]))
            for n, i in (("fc1", 0), ("fc2", 2)) for leaf in ("weight", "bias")}


def _jax_augment(data):
    """The JAX package's public augmentation path on the same draws:
    to_float -> vmapped warp_affine_mxu_planar -> interpret-mode Pallas
    kernel -> clip -> normalize, planar (B, 3, 3, H, W)."""
    perm = JS.RSP_PERMUTATIONS[data["labels"]]
    tiles = np.take_along_axis(data["tiles"], perm[:, :, None, None, None], axis=1)
    imgs = JB.to_float(jnp.asarray(tiles.reshape(B * 3, IMG, IMG, 3).transpose(0, 3, 1, 2)))
    warped = jax.vmap(lambda im, m: JG.warp_affine_mxu_planar(im, m, pad_mode="reflect101"))(
        imgs, jnp.asarray(data["geo"]))
    out = JB._clip01(PP.pretrain_photometric_pallas(
        warped, jax.random.PRNGKey(0), interpret=True, noise=jnp.asarray(data["noise"]),
        params=jnp.asarray(data["params"]), planar_io=True))
    return JB.normalize_batch(out.reshape(B, 3, 3, IMG, IMG), channel_axis=2)


def _draws(data):
    return {k: torch.from_numpy(data[k]) for k in ("geo", "params", "noise")}


def _jax_step_f64(jm_name, params, stats, x_planar, labels):
    """The JAX package's loss, gradients, SGD-Nesterov update and BN
    statistics for one joint-encode step, in float64 (see the test's
    docstring for why float64)."""
    with jax.enable_x64():
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        jm = JTripletNet(jm_name, dtype=jnp.float64)
        jc = JClassifier(num_classes=6, dtype=jnp.float64)
        p, s = f64(params), f64(stats)
        x = jnp.asarray(np.asarray(x_planar).transpose(0, 1, 3, 4, 2), jnp.float64)

        def loss_fn(p):
            feats, mut = jm.apply({"params": p["model"], "batch_stats": s}, x, train=True,
                                  mutable=["batch_stats"], method=jm.forward_joint)
            logits = jc.apply({"params": p["head"]}, feats)
            return JS.cross_entropy(logits, jnp.asarray(labels)), mut["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        tx = joptim.sgd_nesterov(0.01, momentum=0.9, weight_decay=1e-4)
        updates, _ = tx.update(grads, tx.init(p), p)
        return jax.device_get((loss, grads, optax.apply_updates(p, updates), new_stats))


def test_pretrain_step_matches_jax(setup):
    """One step with injected draws.  The augmentation is compared in
    float32 (atol 1e-5: warp and chain are each 1e-5 on their own); the
    model half of the step against the JAX package in float64.

    Why float64 on the JAX side: in float32, the JAX package's gradients of
    the early layers are ~2% away from its own float64 gradients (conv1
    1.9e-2, layer1 3.7e-2 relative to the largest entry, measured on this
    step), while torch's float32 gradients stay within 1e-5 of float64, and
    the two frameworks agree to 1e-13 in float64.  A float32-vs-float32
    comparison would measure the JAX package's float32 error.

    Tolerances, against float64 and with float32 inputs that differ by the
    augmentation's 1e-5: loss rtol 1e-5; gradients atol 1e-4 * max|g| per
    tensor; post-step params rtol 1e-5 / atol 1e-6; BN statistics rtol
    1e-4 / atol 1e-6 after removing torch's unbiased n/(n-1) factor."""
    jm, jc, params, stats, data = setup
    x_jax = _jax_augment(data)
    x_port = TB.normalize_batch(TB.augment_rsp_batch_v1(torch.Generator(), torch.from_numpy(data["tiles"]),
                                                        draws=_draws(data), order=torch.from_numpy(data["labels"])),
                                channel_axis=2)
    np.testing.assert_allclose(x_port.numpy(), np.asarray(x_jax), rtol=0, atol=1e-5)
    _assert_step_matches_jax(params, stats, data, x_jax, _draws(data), torch.float32)


def test_pretrain_step_v2_matches_jax(setup, monkeypatch):
    """``pretrain_step(augment="v2")`` (RandAugment n 2, m 3, fused) against
    the JAX package's step path: the views of ``augment_rsp_batch_v2`` with
    the draws rebuilt from the JAX key and the triplets ordered by their
    labels equal JAX's (the uint8 triplets permuted, then
    ``augment_rsp_batch_v2``) in float32 within 1e-5; then the step, its
    v2 augmentation call handed JAX's views (the reason is in
    tests/test_torch_consistency.py::test_consistency_step_matches_jax),
    against the JAX model half in float64, with the tolerances of
    test_pretrain_step_matches_jax, the port's model in float64 too: v2's
    views hold large uniform regions (the black fill of the geometric ops,
    PIL's enhance ops), where the float32 model's conv1 BatchNorm gradient
    strays from float64 by ~3e-4 of its largest entry, the port's float32
    error and not a gap between the packages.  The step calls the v2
    augmentation with its labels as the ordering, n, m, the mode and the
    draws."""
    from test_torch_v2 import jax_v2_draws

    _, _, params, stats, data = setup
    key = jax.random.PRNGKey(5)
    permuted = JS.permute_triplets(jnp.asarray(data["tiles"]), jnp.asarray(data["labels"]))
    x_jax = JB.augment_rsp_batch_v2(key, permuted, n=2, m=3.0, mode="fused").transpose(0, 1, 4, 2, 3)
    draws = jax_v2_draws(key, B * 3, "fused")
    x_port = TB.augment_rsp_batch_v2(None, torch.from_numpy(data["tiles"]), 2, 3.0, draws=draws,
                                     order=torch.from_numpy(data["labels"]))
    np.testing.assert_allclose(x_port.numpy(), np.asarray(x_jax), rtol=0, atol=1e-5)
    calls = []

    def on_jax_views(gen, tiles, n, m, mode, draws, out_dtype, order, shard):
        calls.append((n, m, mode, draws, out_dtype, order, shard))
        return torch.from_numpy(np.asarray(x_jax, np.float64))

    monkeypatch.setattr(TS.aug_batch, "augment_rsp_batch_v2", on_jax_views)
    _assert_step_matches_jax(params, stats, data, x_jax, draws, torch.float64, augment="v2", n_aug=2, m_aug=3.0)
    (n, m, mode, got_draws, out_dtype, order, shard), = calls
    assert (n, m, mode, got_draws, out_dtype, shard) == (2, 3.0, "fused", draws, torch.float32, (0, B))
    assert torch.equal(order, torch.from_numpy(data["labels"]).long())


def _assert_step_matches_jax(params, stats, data, x_jax, draws, dtype, **step_kwargs):
    """The port's pretrain step on ``data`` with ``draws``, its model in
    ``dtype``, against the JAX package's float64 step on its views
    ``x_jax``: loss, gradients, the updated params and BN statistics
    (tolerances in test_pretrain_step_matches_jax)."""
    jloss, grads, jparams, jstats = _jax_step_f64("resnet18", params, stats, x_jax, data["labels"])

    state = _port_state(params, stats)
    state.model.to(dtype)
    state.classifier.to(dtype)
    counts, hooks = {}, []
    for name, m in state.model.named_modules():
        if isinstance(m, tnn.BatchNorm2d):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: counts.__setitem__(
                    name, inp[0].shape[0] * inp[0].shape[2] * inp[0].shape[3])))
    metrics = TS.pretrain_step(state, torch.from_numpy(data["tiles"]), torch.Generator().manual_seed(0),
                               labels=torch.from_numpy(data["labels"]), draws=draws, **step_kwargs)
    for h in hooks:
        h.remove()
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)

    def close_grad(got, want, name):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=name)

    want_g = export_torch_state_dict(grads["model"], {})
    got_g = {k: p.grad.numpy() for k, p in state.model.named_parameters()}
    assert set(got_g) == set(want_g)
    for k in want_g:
        close_grad(got_g[k], want_g[k], f"grad {k}")
    got_hg = {f"classifier.{k}": p.grad.numpy() for k, p in state.classifier.classifier.named_parameters()}
    for k, v in _head_sd(grads["head"]).items():
        close_grad(got_hg[k], v, f"grad {k}")

    want_p = export_torch_state_dict(jparams["model"], {})
    got_sd = state.model.state_dict()
    for k in want_p:
        np.testing.assert_allclose(got_sd[k].numpy(), want_p[k], rtol=1e-5, atol=1e-6, err_msg=f"param {k}")
    for k, v in _head_sd(jparams["head"]).items():
        np.testing.assert_allclose(state.classifier.state_dict()[k].numpy(), v, rtol=1e-5, atol=1e-6,
                                   err_msg=f"param {k}")

    want_s = export_torch_state_dict(jax.device_get(params["model"]), jstats)
    start = export_torch_state_dict(jax.device_get(params["model"]), jax.device_get(stats))
    for k, v in got_sd.items():
        if k.endswith("running_mean"):
            np.testing.assert_allclose(v.numpy(), want_s[k], rtol=1e-4, atol=1e-6, err_msg=k)
        elif k.endswith("running_var"):
            n = counts[k[: -len(".running_var")]]
            base = 0.9 * start[k]
            np.testing.assert_allclose(v.numpy() - base, n / (n - 1) * (want_s[k] - base),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("augment", ["v1", None])
def test_step_orders_triplets_where_the_tiles_are_read(setup, monkeypatch, augment):
    """The v1 step hands the sampler's tiles and its labels (as ``order``)
    to the augmentation, with no permuted copy of the uint8 tiles made
    before it; the unaugmented step still permutes them.  On the v1 path the
    ordered augmentation equals the plain augmentation of tiles permuted
    beforehand, bit for bit."""
    _, _, params, stats, data = setup
    tiles, labels = torch.from_numpy(data["tiles"]), torch.from_numpy(data["labels"])
    calls, seen = [], []
    permute, augment_v1 = TS.permute_triplets, TB.augment_rsp_batch_v1
    monkeypatch.setattr(TS, "permute_triplets", lambda *a: calls.append(1) or permute(*a))
    monkeypatch.setattr(TB, "augment_rsp_batch_v1",
                        lambda g, t, order=None, **kw: seen.append((t, order, len(calls)))
                        or augment_v1(g, t, order=order, **kw))
    got = TS.pretrain_step(_port_state(params, stats), tiles, torch.Generator().manual_seed(0), labels=labels,
                           draws=_draws(data) if augment else None, augment=augment)
    assert np.isfinite(float(got["loss"]))
    if augment is None:
        assert len(calls) == 1 and not seen
    else:
        (t, order, permutes_before), = seen
        assert t is tiles and permutes_before == 0 and torch.equal(order, labels.long())
        a = augment_v1(torch.Generator(), tiles, draws=_draws(data), order=labels)
        b = augment_v1(torch.Generator(), permute(tiles, labels), draws=_draws(data))
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", [-1, 6])
def test_step_rejects_labels_out_of_range(setup, bad):
    """Labels a caller passes are checked before the augmentation reads
    tiles by them: the kernel has no range check of its own."""
    _, _, params, stats, data = setup
    labels = torch.from_numpy(data["labels"]).clone()
    labels[1] = bad
    with pytest.raises(ValueError, match="labels"):
        TS.pretrain_step(_port_state(params, stats), torch.from_numpy(data["tiles"]),
                         torch.Generator().manual_seed(0), labels=labels, draws=_draws(data))


def test_eval_step_matches_jax(setup):
    """All 6 orderings, running BN statistics, masked sums.  The port runs
    the backbone once and permutes embeddings (eval-mode BN makes them
    ordering-independent); JAX runs six full passes.  loss_sum rtol 1e-4,
    correct and count exact."""
    jm, jc, params, stats, data = setup
    tx = joptim.sgd_nesterov(0.01)
    jstate = j_init_state(jm, jc, tx, jax.random.PRNGKey(0), image_size=IMG)
    jstate = jstate.replace(params=params, batch_stats=stats)
    valid = np.array([1, 1, 1, 0], np.float32)
    want = JS.make_pretrain_eval_step(jm, jc)(jstate, jnp.asarray(data["tiles"]), jnp.asarray(valid))
    got = TS.pretrain_eval_step(_port_state(params, stats), torch.from_numpy(data["tiles"]),
                                torch.from_numpy(valid))
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=1e-4)
    assert float(got["correct"]) == float(want["correct"])
    assert float(got["count"]) == float(want["count"]) == 18.0


def test_lookahead_epoch_sync_matches_jax():
    """The per-epoch Lookahead for 11 epochs at la_steps=5, la_alpha=0.5
    (syncs after epochs 5 and 10) against the JAX package's
    lookahead_epoch_sync, with the same fast-weight drift added on both sides
    before each call.  Params, slow weights and the count after every call,
    atol 1e-7: both sides do the same float32 ops, and with alpha 0.5 the
    products are exact."""
    from ssl_cr_histo_tpu_torch.train import optim as toptim

    rng = np.random.default_rng(7)
    shapes = [(8, 3, 3, 3), (8,), (6, 16)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    s0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jp, js, jc = [jnp.asarray(a) for a in p0], [jnp.asarray(a) for a in s0], 0
    tp, ts, tc = [torch.from_numpy(a.copy()) for a in p0], [torch.from_numpy(a.copy()) for a in s0], 0
    synced = []
    for epoch in range(1, 12):
        drift = [rng.normal(scale=0.1, size=s).astype(np.float32) for s in shapes]
        jp = [p + d for p, d in zip(jp, drift)]
        for p, d in zip(tp, drift):
            p.add_(torch.from_numpy(d))
        jp, js, jc = joptim.lookahead_epoch_sync(jp, js, jc, la_steps=5, la_alpha=0.5)
        tc = toptim.lookahead_epoch_sync(tp, ts, tc, la_steps=5, la_alpha=0.5)
        assert tc == int(jc), epoch
        for got, want in zip(tp + ts, jp + js):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7,
                                       err_msg=f"epoch {epoch}")
        if tc == 0:
            synced.append(epoch)
    assert synced == [5, 10]


def test_lookahead_epoch_updates_train_state():
    """train.loop.lookahead_epoch applies the sync to every trainable
    parameter of the state (backbone and classifier) and to its slow
    weights: nothing moves for 4 epochs, then p <- (p + s) / 2 and s <- p."""
    from ssl_cr_histo_tpu_torch.train.loop import lookahead_epoch

    torch.manual_seed(0)
    state = init_triplet_state("resnet18", torch.device("cpu"))
    with torch.no_grad():
        for p in state.parameters():
            p.add_(0.01)
    fast = [p.detach().clone() for p in state.parameters()]
    slow = [s.clone() for s in state.slow]
    for epoch in range(1, 5):
        lookahead_epoch(state, la_steps=5, la_alpha=0.5)
        assert state.la_count == epoch
    assert all(torch.equal(p, f) for p, f in zip(state.parameters(), fast))
    lookahead_epoch(state, la_steps=5, la_alpha=0.5)
    assert state.la_count == 0
    assert len(state.slow) == len(fast) == len(list(state.classifier.parameters())) + len(
        list(state.model.parameters()))
    for p, s, f, s0 in zip(state.parameters(), state.slow, fast, slow):
        torch.testing.assert_close(p.detach(), 0.5 * f + 0.5 * s0, rtol=0, atol=0)
        assert torch.equal(s, p.detach())


def _write_slides(d):
    """Two slides whose tissue passes the v1 LAB foreground test at 64^2
    (white background pulls the slide mean down, as in test_cli.py)."""
    rng = np.random.default_rng(0)
    os.makedirs(d)
    for i in range(2):
        level0 = np.full((1536, 1536, 3), 245, np.uint8)
        tissue = np.stack([np.full((1024, 1024), c) for c in (190, 80, 160)], axis=-1)
        level0[64:1088, 64:1088] = np.clip(tissue + rng.integers(-20, 20, tissue.shape), 0, 255)
        np.save(os.path.join(d, f"slide{i}.npy"), level0)


def test_cli_end_to_end_and_checkpoint_loads_in_jax(tmp_path):
    """The port's CLI on the CPU (--device cpu) at 64^2 for 2 steps; its
    checkpoint loads through the JAX package's reference-format loader and
    gives the same eval forward (FWD tolerance as test_torch_models.py)."""
    from ssl_cr_histo_tpu_torch.cli import pretrain
    from ssl_cr_histo_tpu_torch.models import TripletNet

    slides, run = str(tmp_path / "wsis"), tmp_path / "run"
    _write_slides(slides)
    pretrain.main(["--train_image_pth", slides, "--save_dir", str(run), "--device", "cpu",
                   "--tile_h", "64", "--tile_w", "64", "--tile_stride", "32", "--batch_size", "4",
                   "--num_epoch", "1", "--steps_per_epoch", "2", "--validation_size", "4",
                   "--save_freq", "1", "--no-bf16"])
    rows = (run / "train_results.csv").read_text().splitlines()
    assert rows[0] == "epoch, train_loss, train_acc, val_loss, val_acc" and len(rows) == 2
    vals = [float(v) for v in rows[1].split(",")]
    assert vals[0] == 1 and all(np.isfinite(vals)) and 0 < vals[1] < 10 and vals[4] > 0
    assert (run / "ckpt_1.pth").exists() and (run / "best.pth").exists()

    mparams, mstats = load_torch_triplet_checkpoint(str(run / "ckpt_1.pth"))
    raw = torch.load(run / "ckpt_1.pth", weights_only=False)
    tm = TripletNet("resnet18")
    tm.load_state_dict(raw["model"])
    tm.eval()
    x = np.random.default_rng(1).random((2, IMG, IMG, 3)).astype(np.float32)
    want = JTripletNet("resnet18").apply({"params": mparams, "batch_stats": mstats},
                                         x, x[::-1], x, train=False)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        got = tm(xt, xt.flip(0), xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=2e-4)


def test_cli_prefetch_keeps_the_batches_and_the_state(tmp_path, monkeypatch):
    """The CLI feeds its train and validation batches through the prefetch
    thread (``data.pipeline.prefetch_to_device``, each epoch's two feeds;
    the train feed's through ``cli.common.chunked_feed`` at --multi_step 1,
    one batch a chunk); a run with that feed swapped for an inline read and
    copy (the CLI's feed before it prefetched) gives the same train and
    validation batches, in the same order, and bit-equal checkpoints, on
    the CPU over 2 epochs of 3 steps."""
    from ssl_cr_histo_tpu_torch.cli import common, pretrain

    slides = str(tmp_path / "wsis")
    _write_slides(slides)
    real_prefetch = pretrain.prefetch_to_device

    def inline(it, device, size=2):
        for batch in it:
            yield tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in batch)

    runs = {}
    for name, feed in (("prefetch", real_prefetch), ("inline", inline)):
        seen = {"train": [], "val": [], "feeds": 0}
        real_step, real_eval = TS.pretrain_step, TS.pretrain_eval_step

        def counted(it, device, size=2, feed=feed, seen=seen):
            seen["feeds"] += 1
            return feed(it, device, size)

        def step(state, tiles, *a, seen=seen, real_step=real_step, **kw):
            seen["train"].append(tiles.clone())
            return real_step(state, tiles, *a, **kw)

        def eval_step(state, tiles, valid, *a, seen=seen, real_eval=real_eval, **kw):
            seen["val"].append((tiles.clone(), valid.clone()))
            return real_eval(state, tiles, valid, *a, **kw)

        monkeypatch.setattr(pretrain, "prefetch_to_device", counted)
        monkeypatch.setattr(common, "prefetch_to_device", counted)
        monkeypatch.setattr(TS, "pretrain_step", step)
        monkeypatch.setattr(TS, "pretrain_eval_step", eval_step)
        run = tmp_path / name
        pretrain.main(["--train_image_pth", slides, "--save_dir", str(run), "--device", "cpu",
                       "--tile_h", "64", "--tile_w", "64", "--tile_stride", "32", "--batch_size", "4",
                       "--num_epoch", "2", "--steps_per_epoch", "3", "--validation_size", "6",
                       "--save_freq", "2", "--index_cache_dir", "", "--no-bf16", "--multi_step", "1"])
        monkeypatch.setattr(TS, "pretrain_step", real_step)
        monkeypatch.setattr(TS, "pretrain_eval_step", real_eval)
        runs[name] = (seen, torch.load(run / "ckpt_2.pth", weights_only=False))
    (a, ca), (b, cb) = runs["prefetch"], runs["inline"]
    assert a["feeds"] == b["feeds"] == 4 and len(a["train"]) == 6 and len(a["val"]) == 2 * 2
    for x, y in zip(a["train"], b["train"], strict=True):
        assert torch.equal(x, y)
    for (x, v), (y, w) in zip(a["val"], b["val"], strict=True):
        assert torch.equal(x, y) and torch.equal(v, w)
    for part in ("model", "classifier"):
        for k, v in ca[part].items():
            assert torch.equal(v, cb[part][k]), k
    assert all(torch.equal(x, y) for x, y in zip(ca["slow"], cb["slow"]))


def test_cli_rejects_unported_flags(tmp_path):
    """A --resume file that is not there exits naming it, before any
    epoch.  (The test keeps its name from when v2, the other augmentation
    modes, --reference_exact and --remat exited "not yet ported";
    test_cli_runs_each_flag now runs each of them.)"""
    from ssl_cr_histo_tpu_torch.cli import pretrain

    slides = str(tmp_path / "wsis")
    _write_slides(slides)
    with pytest.raises(SystemExit, match="--resume missing/ckpt_3.pth: no such checkpoint"):
        pretrain.main(["--train_image_pth", slides, "--device", "cpu", "--tile_h", "64", "--tile_w", "64",
                       "--tile_stride", "32", "--index_cache_dir", "", "--save_dir", str(tmp_path / "run"),
                       "--resume", "missing/ckpt_3.pth"])


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for a CLI run at a tiny size (restored after):
    more threads buy nothing there and contend with the other test
    workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("extra", [["--variant", "v2"], ["--aug_mode", "fast"], ["--aug_mode", "masked"],
                                   ["--aug_mode", "exact"], ["--reference_exact"], ["--remat"]])
def test_cli_runs_each_flag(tmp_path, extra, monkeypatch, one_torch_thread):
    """The pretrain CLI on the CPU (64^2 tiles, batch 4, one epoch of 2
    steps) with each flag the JAX CLI takes, doing what it does there:
    ``--variant v2`` runs RandAugment(2, 3) per tile (the v2 augmentation
    each step, the v1 pool never); ``--aug_mode fast`` and ``masked`` run
    the fused v1 pool (the kernel's plain version here, once a step),
    ``exact`` the op-by-op pool;
    ``--reference_exact`` the exact pool in float32, one backbone pass a
    view and the sampler's x6 orderings (labels passed to each step);
    ``--remat`` recomputes each block (a checkpointed call per block and
    step).  The CSV row is finite."""
    from ssl_cr_histo_tpu_torch.cli import pretrain
    from ssl_cr_histo_tpu_torch.models import resnet

    slides = str(tmp_path / "wsis")
    _write_slides(slides)
    steps, augs, blocks, kernel_path = [], [], [], []
    real_step, checkpoint, plain = TS.pretrain_step, resnet.checkpoint, RK.rsp_augment_plain
    v1, v2 = TB.augment_rsp_batch_v1, TB.augment_rsp_batch_v2
    monkeypatch.setattr(TS, "pretrain_step", lambda state, tiles, gen, labels=None, **kw: steps.append(
        (labels, kw)) or real_step(state, tiles, gen, labels=labels, **kw))
    monkeypatch.setattr(TB, "augment_rsp_batch_v1", lambda *a, mode="fused", **k: augs.append(("v1", mode))
                        or v1(*a, mode=mode, **k))
    monkeypatch.setattr(TB, "augment_rsp_batch_v2", lambda *a, mode="fused", **k: augs.append(("v2", mode))
                        or v2(*a, mode=mode, **k))
    monkeypatch.setattr(RK, "rsp_augment_plain", lambda *a, **k: kernel_path.append(1) or plain(*a, **k))
    monkeypatch.setattr(resnet, "checkpoint", lambda fn, *a, **k: blocks.append(fn) or checkpoint(fn, *a, **k))
    run = tmp_path / "run"
    pretrain.main(["--train_image_pth", slides, "--save_dir", str(run), "--device", "cpu", "--tile_h", "64",
                   "--tile_w", "64", "--tile_stride", "32", "--batch_size", "4", "--num_epoch", "1",
                   "--steps_per_epoch", "2", "--validation_size", "4", "--save_freq", "0",
                   "--index_cache_dir", "", "--no-bf16"] + extra)
    rows = (run / "train_results.csv").read_text().splitlines()
    assert len(rows) == 2 and all(np.isfinite(float(v)) for v in rows[1].split(",")[1:])
    assert len(steps) == 2
    labels, kw = steps[0]
    want = {"--variant": ("v2", "fused"), "--aug_mode": ("v1", extra[-1]), "--reference_exact": ("v1", "exact"),
            "--remat": ("v1", "fused")}[extra[0]]
    assert augs == [want] * 2 and kw["augment"] == want[0]
    assert len(kernel_path) == (2 if want[0] == "v1" and want[1] != "exact" else 0)
    if extra[0] == "--variant":
        assert (kw["n_aug"], kw["m_aug"], kw["aug_mode"]) == (2, 3.0, "fused")
    if extra[0] == "--aug_mode":
        assert kw["aug_mode"] == extra[1]
    strict = extra == ["--reference_exact"]
    assert (labels is not None, kw["joint_encode"], kw["bf16"]) == (strict, not strict, False)
    assert len(blocks) == (2 * 8 if extra == ["--remat"] else 0)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import without jax,
    flax, optax or chex, and without any module of the JAX package
    (``ssl_cr_histo_tpu``, even its numpy-only ones); the port's bench tools
    (``tools/bench.py``, ``bench_suite.py``, ``bench_scaling.py``,
    ``reference_baseline.py``) load neither the repo's ``bench.py`` nor
    any of its ``tools/``; nor do they load cv2,
    h5py, matplotlib or scikit-learn, which the GPU machine may lack (the
    functions that read images or .h5 files, or draw, import them), nor
    msgpack, which it lacks (the reader of the JAX package's checkpoints,
    ``utils/flax_msgpack.py``, and ``cli/convert_checkpoint.py`` decode
    flax's format themselves).  A subprocess: this test process
    has jax loaded (tests/conftest.py)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ssl_cr_histo_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'chex'))\n"
        "assert not bad, bad\n"
        "jax_pkg = sorted(k for k in sys.modules if k.split('.')[0] == 'ssl_cr_histo_tpu')\n"
        "assert not jax_pkg, jax_pkg\n"
        "optional = sorted(k for k in sys.modules if k.split('.')[0] in ('cv2', 'h5py', 'matplotlib', 'sklearn'))\n"
        "assert not optional, optional\n"
        "assert not [k for k in sys.modules if k.split('.')[0] == 'msgpack'], 'msgpack'\n"
        "for name in ('cli.convert_checkpoint', 'utils.flax_msgpack'):\n"
        "    assert 'ssl_cr_histo_tpu_torch.' + name in sys.modules, name\n"
        "for name in ('bench', 'bench_suite', 'bench_scaling', 'reference_baseline'):\n"
        "    assert 'ssl_cr_histo_tpu_torch.tools.' + name in sys.modules, name\n"
        "jax_tools = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "                   ('bench', 'tools', 'bench_suite', 'bench_scaling', 'measure_reference_baseline'))\n"
        "assert not jax_tools, jax_tools\n"
        "print('ok', len([k for k in sys.modules if k.startswith('ssl_cr_histo_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[1]) >= 20


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """chip_smoke.py names no module of the JAX package: it reaches the
    slide sampler through ``ssl_cr_histo_tpu_torch.data``."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    top = {n.split(".")[0] for n in names}
    assert not top & {"ssl_cr_histo_tpu", "jax", "jaxlib", "flax", "optax", "chex"}, sorted(top)
    assert "ssl_cr_histo_tpu_torch" in top
