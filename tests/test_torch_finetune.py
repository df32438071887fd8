"""The port's fine-tune slice against the JAX package on the CPU: resize and
crops, the 3-view augmentation on the same key, freezing by torch index,
Adam with the MultiStep schedule, the fine-tune step and the eval forward,
and the CLI end to end from a pretrain checkpoint of the port.

Inputs are made with numpy from a seed; weights by flax, carried over with
``from_jax_params``.  The 3-view draws are rebuilt from the JAX key with the
same ``jax.random`` calls in the same order as ``ops/batch.py::_three_view``
and handed to the port.  IMG 64 for the model steps (layer4 2x2, see
tests/test_torch_pretrain_step.py)."""

import os
import shutil

import numpy as np
import pytest
import torch
import torch.nn as tnn

import jax
import jax.numpy as jnp
import optax

from ssl_cr_histo_tpu.models import FinetuneHead as JFinetuneHead
from ssl_cr_histo_tpu.models import TripletNet as JTripletNet
from ssl_cr_histo_tpu.ops import batch as JB
from ssl_cr_histo_tpu.ops import geometry as JG
from ssl_cr_histo_tpu.parallel import steps as JS
from ssl_cr_histo_tpu.train import freeze as jfreeze
from ssl_cr_histo_tpu.train import optim as joptim
from ssl_cr_histo_tpu.train.checkpoint import (
    export_torch_state_dict,
    load_torch_linear_head,
    load_torch_triplet_checkpoint,
)
from ssl_cr_histo_tpu.train.state import TrainState as JTrainState
from ssl_cr_histo_tpu_torch.cli.common import TASKS, make_optimizer
from ssl_cr_histo_tpu_torch.models import TripletNet
from ssl_cr_histo_tpu_torch.ops import batch as TB
from ssl_cr_histo_tpu_torch.ops import geometry as TG
from ssl_cr_histo_tpu_torch.parallel import steps as TS
from ssl_cr_histo_tpu_torch.train import freeze as tfreeze
from ssl_cr_histo_tpu_torch.train import optim as toptim
from ssl_cr_histo_tpu_torch.train.checkpoint import _torch_name, from_jax_params
from ssl_cr_histo_tpu_torch.train.init import init_finetune_state, load_backbone


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


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Remove each test's temporary directory once it is done: the CLI
    tests write ResNet checkpoints that they read once, and pytest keeps
    its last three sessions' temporary directories."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


IMG, B = 64, 4
MODULES = (0, 3, 15, 30, 45, 60, 64)


# --- geometry: resize and crops --------------------------------------------


@pytest.mark.parametrize("shape,out", [((32, 32), (52, 52)), ((52, 52), (32, 32)),
                                       ((37, 37), (57, 57)), ((57, 41), (29, 70))])
def test_resize_matches_jax(shape, out):
    """cv2-exact bilinear resize, up and down, against the JAX package's
    ``geometry.resize`` (channels last there, planar here), float32, atol
    1e-5: both sum the same two float32 weights per output, in another
    order (an einsum against two products and an add)."""
    img = np.random.default_rng(1).random((2, *shape, 3)).astype(np.float32)
    want = np.asarray(JG.resize(jnp.asarray(img), *out))
    got = TG.resize(torch.from_numpy(img).permute(0, 3, 1, 2), *out).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(TG._cv2_linear_weights(shape[0], out[0]),
                                  JG._cv2_linear_weights(shape[0], out[0]))


def test_crops_match_jax():
    """center_crop, and random_crop at offsets drawn by JAX's own
    ``random_crop`` key split, equal the JAX crops exactly."""
    img = np.random.default_rng(2).random((3, 52, 52, 3)).astype(np.float32)
    planar = torch.from_numpy(img).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(TG.center_crop(planar, 32, 30).permute(0, 2, 3, 1).numpy(),
                                  np.asarray(JG.center_crop(jnp.asarray(img), 32, 30)))
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    want = np.stack([np.asarray(JG.random_crop(jnp.asarray(im), k, 32, 32)) for im, k in zip(img, keys)])
    offs = [[int(jax.random.randint(kk, (), 0, 21)) for kk in jax.random.split(k)] for k in keys]
    y0, x0 = torch.tensor(offs).T
    got = TG.random_crop(planar, y0, x0, 32, 32).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [32, 37])
def test_rotation_warp_matches_jax_across_45_degrees(s):
    """The 3-view rotation: the port's planar warp of rotation_matrix(angle)
    against the JAX package's warp_affine_mxu (HWC) with reflect-101
    borders, at angles on both sides of +-45 degrees, where the two-pass
    warp's 90-degree fix-up flips, and near +-90; float32, atol 1e-5.  Both
    sides take the same fix-up at every angle."""
    angles = np.array([-90.0, -89.9, -45.2, -44.8, -10.0, 0.0, 44.8, 45.2, 89.9], np.float32)
    img = np.random.default_rng(4).random((len(angles), s, s, 3)).astype(np.float32)
    mats = TG.rotation_matrix(torch.from_numpy(angles), s, s)
    got = TG.warp_affine_planar(torch.from_numpy(img).permute(0, 3, 1, 2), mats, pad_mode="reflect101")
    want = np.stack([np.asarray(JG.warp_affine_mxu(jnp.asarray(im), JG.rotation_matrix(jnp.float32(a), s, s),
                                                   pad_mode="reflect101")) for im, a in zip(img, angles)])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)
    flags = TG.warp_pass_coefficients(mats, s)[:, 6:].numpy()
    jm = [np.asarray(JG.rotation_matrix(jnp.float32(a), s, s)) for a in angles]
    rot = np.array([abs(m[0, 0]) + abs(m[1, 1]) < abs(m[0, 1]) + abs(m[1, 0]) for m in jm])
    np.testing.assert_array_equal(flags[:, 0] > 0.5, rot)
    # a pure rotation has equal diagonal terms: never the transpose fix-up
    assert rot.any() and (~rot).any() and not (flags[:, 1] > 0.5).any()


# --- the 3-view augmentation ------------------------------------------------


def jax_3view_draws(key, b):
    """The draws of JB.augment_3view_batch(key, ...) for b images, rebuilt
    with the same jax.random calls in the same order
    (``batch.py:110-132``, ``geometry.py:458-460``), as the port's dict."""
    out = {"angles": [], "rotate": [], "crop": [], "perm": []}
    for k in jax.random.split(key, b):
        k2a, k2p, k3a, k3p, k3c, kshuf = jax.random.split(k, 6)
        out["angles"].append([float(jax.random.uniform(ka, (), minval=-90.0, maxval=90.0)) for ka in (k2a, k3a)])
        out["rotate"].append([bool(jax.random.bernoulli(kp)) for kp in (k2p, k3p)])
        out["crop"].append([int(jax.random.randint(kk, (), 0, TB.THREE_VIEW_PAD + 1))
                            for kk in jax.random.split(k3c)])
        out["perm"].append(np.asarray(jax.random.permutation(kshuf, 3)).tolist())
    return {"angles": torch.tensor(out["angles"], dtype=torch.float32), "rotate": torch.tensor(out["rotate"]),
            "crop": torch.tensor(out["crop"]), "perm": torch.tensor(out["perm"])}


@pytest.mark.parametrize("s", [32, 37])
def test_3view_matches_jax_augment_3view_batch(s):
    """augment_3view_batch with the draws rebuilt from the key against the
    JAX package's augment_3view_batch(key, imgs), float32, atol 1e-5 (the
    warp's and the resize's summation orders, tests above)."""
    b = 8
    key = jax.random.PRNGKey(10 + s)
    imgs = np.random.default_rng(s).integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    want = np.asarray(JB.augment_3view_batch(key, jnp.asarray(imgs)))
    draws = jax_3view_draws(key, b)
    assert draws["rotate"].any() and not draws["rotate"].all()
    got = TB.augment_3view_batch(torch.Generator(), torch.from_numpy(imgs), draws)
    assert got.shape == (b, 3, 3, s, s) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), want, rtol=0, atol=1e-5)


def test_3view_draw_law():
    """draw_3view's laws, by counts over 60000 images (each bound is over
    5 binomial standard deviations): angles uniform on [-90, 90), coins at
    p = 0.5, crop offsets uniform on 0..20, permutations uniform over the
    six."""
    n = 60000
    d = TB.draw_3view(torch.Generator().manual_seed(0), n, 224)
    a = d["angles"].numpy()
    assert a.min() >= -90.0 and a.max() < 90.0 and abs(a.mean()) < 1.2
    np.testing.assert_allclose((a < 45.0).mean(), 0.75, atol=0.01)
    np.testing.assert_allclose(d["rotate"].float().mean(0).numpy(), 0.5, atol=0.011)
    counts = np.bincount(d["crop"].numpy().ravel(), minlength=21)
    assert len(counts) == 21
    np.testing.assert_allclose(counts / (2 * n), 1 / 21, atol=0.003)
    perms, freq = np.unique(d["perm"].numpy(), axis=0, return_counts=True)
    assert len(perms) == 6 and all(sorted(p) == [0, 1, 2] for p in perms.tolist())
    np.testing.assert_allclose(freq / n, 1 / 6, atol=0.01)


# --- freezing, optimizer, schedule -------------------------------------------


def _jax_param_tree(model_name, num_classes=9):
    """Shapes of the JAX fine-tune params {'model', 'head'} (no compute)."""
    jm = JTripletNet(model_name)
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), dummy, train=False, method=jm.encode_single))
    head = jax.eval_shape(lambda: JFinetuneHead(num_classes).init(jax.random.PRNGKey(1), jnp.zeros((1, 768))))
    return {"model": v["params"], "head": head["params"]}


def _jax_torch_name(path):
    if path[0] == "fc":
        return f"fc.{ {'fc1': 0, 'fc2': 2}[path[1]] }.{ {'kernel': 'weight', 'bias': 'bias'}[path[2]] }"
    return _torch_name(path[1:])


@pytest.mark.parametrize("model_name", ["resnet18", "resnet50"])
def test_param_order_matches_jax(model_name):
    """The port's ``--modules`` index space, TripletNet.parameters() order,
    is the JAX package's torch_param_order, name for name."""
    got = tfreeze.torch_param_order(TripletNet(model_name))
    want = [_jax_torch_name(p) for p in jfreeze.torch_param_order(model_name)]
    assert got == want
    assert len(got) == {"resnet18": 64, "resnet50": 163}[model_name]


@pytest.mark.parametrize("modules", MODULES)
@pytest.mark.parametrize("model_name", ["resnet18", "resnet50"])
def test_frozen_set_matches_jax(model_name, modules):
    """The tensors freeze() switches off are those JAX's freeze_labels
    labels 'freeze', exactly; the head never freezes."""
    model = TripletNet(model_name)
    frozen = tfreeze.freeze(model, modules)
    labels = jfreeze.freeze_labels(_jax_param_tree(model_name), modules, model_name)
    want = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(labels):
        keys = tuple(k.key for k in path)
        if leaf == "freeze":
            assert keys[0] == "model"
            want.add(_jax_torch_name(keys[1:]) if keys[1] == "fc" else _torch_name(keys[2:]))
    assert set(frozen) == want and len(frozen) == modules
    assert {n for n, p in model.named_parameters() if not p.requires_grad} == want


def test_adam_multistep_matches_optax_across_milestones():
    """torch Adam (L2 1e-4 added to the gradient) under multistep_schedule
    against the JAX package's adam(multistep_schedule(...)), 7 steps with
    milestones at steps 2 and 4 and the same gradients each step: the rate
    of every update equal to optax's schedule at its count, and the params
    after every step rtol 1e-6 / atol 1e-6, a ten-thousandth of one update
    (torch adds the update to the param in one fused op, optax in two: a
    float32 ulp apart a step).  lr 0.01 so that each update moves the
    params far beyond the tolerance."""
    rng = np.random.default_rng(5)
    shapes = [(4, 3, 3, 3), (9,), (9, 768)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    lr, wd, milestones = 0.01, 1e-4, [2, 4]
    jp = [jnp.asarray(a) for a in p0]
    tx = joptim.adam(joptim.multistep_schedule(lr, milestones, 0.1), weight_decay=wd)
    jstate = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    opt = toptim.adam(tp, lr, weight_decay=wd)
    sched = toptim.multistep_schedule(opt, milestones, 0.1)
    sched_fn = joptim.multistep_schedule(lr, milestones, 0.1)
    for step in range(7):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(sched_fn(step)), rtol=1e-6)
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
        for got, want in zip(tp, jp):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {step}")
    assert opt.param_groups[0]["lr"] == pytest.approx(lr * 0.01)


# --- the fine-tune step and the eval forward ---------------------------------


@pytest.fixture(scope="module")
def weights():
    """flax TripletNet + FinetuneHead weights (9 classes and 1 output) from a
    seed, as numpy trees."""
    jm = JTripletNet("resnet18")
    dummy = jnp.zeros((1, IMG, IMG, 3), jnp.float32)
    v = jm.init(jax.random.PRNGKey(0), dummy, train=False, method=jm.encode_single)
    heads = {n: JFinetuneHead(n).init(jax.random.PRNGKey(n), jnp.zeros((1, 768)))["params"] for n in (9, 1)}
    return jax.device_get(v["params"]), jax.device_get(v["batch_stats"]), jax.device_get(heads)


def _port_state(weights, task_cfg, modules, milestones=()):
    mparams, stats, heads = weights
    sd, head_sd = from_jax_params(mparams, stats, heads[task_cfg.num_classes])
    torch.manual_seed(0)
    state = init_finetune_state(
        "resnet18", task_cfg.num_classes, torch.device("cpu"),
        lambda ps: make_optimizer(task_cfg.optimizer, ps, task_cfg.lr, 1e-4), modules=modules,
        milestones_steps=milestones)
    state.model.load_state_dict(sd)
    state.head.load_state_dict(head_sd)
    return state


def _jax_step_f64(weights, task_cfg, modules, imgs, labels, key):
    """The JAX package's own fine-tune step (make_finetune_step, its 3-view
    augmentation drawn from ``key``) with a float64 model and head, the
    task's Adam under masked_optimizer; returns (loss, metric, grads, new
    params, new batch stats) and the draws it made."""
    mparams, stats, heads = weights
    with jax.enable_x64():
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        jm = JTripletNet("resnet18", dtype=jnp.float64)
        jh = JFinetuneHead(task_cfg.num_classes, dtype=jnp.float64)
        params = {"model": f64(mparams), "head": f64(heads[task_cfg.num_classes])}
        tx = jfreeze.masked_optimizer(joptim.adam(task_cfg.lr, weight_decay=1e-4), params, modules, "resnet18")
        state = JTrainState(params=params, batch_stats=f64(stats), opt_state=tx.init(params),
                            step=jnp.zeros([], jnp.int32))
        step = JS.make_finetune_step(jm, jh, tx, task=task_cfg.task, donate=False)
        new, m = step(state, jnp.asarray(imgs), jnp.asarray(labels), key)
        draws = jax_3view_draws(key, len(imgs))
        # the gradients of the same loss at the same views, for the per-tensor check
        views = np.asarray(JB.augment_3view_batch(key, jnp.asarray(imgs))).reshape(-1, IMG, IMG, 3)

        def loss_fn(p):
            feats, _ = jm.apply({"params": p["model"], "batch_stats": state.batch_stats},
                                jnp.asarray(views, jnp.float64), train=True, mutable=["batch_stats"],
                                method=jm.encode_single)
            out = jh.apply({"params": p["head"]}, feats)
            lab = jnp.repeat(jnp.asarray(labels), 3)
            if task_cfg.task == "regression":
                return JS.mse(out.squeeze(-1), lab.astype(jnp.float64))
            return JS.cross_entropy(out, lab)

        grads = jax.grad(loss_fn)(params)
        return jax.device_get((m["loss"], m["metric"], grads, new.params, new.batch_stats)), draws, views


@pytest.mark.parametrize("modules", [0, 15])
@pytest.mark.parametrize("task", ["kather", "breastpathq"])
def test_finetune_step_matches_jax(weights, task, modules, monkeypatch):
    """One step at the task's config (Kather: 9-way CE, Adam 1e-5;
    BreastPathQ: 1-output MSE, Adam 1e-4; L2 1e-4) against the JAX
    package's make_finetune_step run in float64, on the same images,
    labels and 3-view draws (rebuilt from the JAX key).

    The port's views from those draws are held to JAX's (atol 2e-5: under
    float64 JAX draws each angle in float64, which reaches the port rounded
    to float32), and then the step runs on JAX's views, bit for bit: this
    randomly initialised net's gradients move by far more than the bounds
    below under input changes of 1e-5, while on equal views the port and
    JAX agree to 7.1e-7 in float64 (tests/torch_grad_sensitivity.py prints
    both on this batch).

    Float64 on the JAX side for the reason in
    tests/test_torch_pretrain_step.py (its float32 gradients are ~2% off its
    own float64 ones).  Tolerances: loss rtol 1e-5 and metric equal; the
    gradients atol 1e-4 * max|g| per tensor; the update each param took
    (new - old) rtol 1e-4 / atol 1e-4 * lr plus one float32 ulp of the
    param where the L2-added gradient is above 1e-2 of its tensor's largest
    entry (Adam's first update is
    lr * g / (|g| + eps), so the sign of a gradient within the comparison's
    noise of 0 decides the whole update); frozen tensors bitwise unchanged on
    the port, unchanged on JAX; BN statistics of every layer, frozen or not,
    updated as JAX's, rtol 1e-4 / atol 1e-6 after torch's unbiased n/(n-1)
    factor."""
    cfg = TASKS[task]
    rng = np.random.default_rng(20 + modules)
    imgs = rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    labels = (rng.integers(0, 9, B).astype(np.int32) if cfg.task == "classification"
              else rng.random(B).astype(np.float32))
    (jloss, jmetric, grads, jparams, jstats), draws, views = _jax_step_f64(
        weights, cfg, modules, imgs, labels, jax.random.PRNGKey(modules + 1))
    views = torch.from_numpy(views.reshape(B, 3, IMG, IMG, 3)).permute(0, 1, 4, 2, 3).contiguous()
    own = TB.augment_3view_batch(torch.Generator(), torch.from_numpy(imgs), draws)
    np.testing.assert_allclose(own.numpy(), views.numpy(), rtol=0, atol=2e-5)
    seen = []
    monkeypatch.setattr(TS.aug_batch, "augment_3view_batch",
                        lambda gen, x, d=None, shard=None: seen.append((x, d, shard)) or views)

    state = _port_state(weights, cfg, modules)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    head_before = {k: v.clone() for k, v in state.head.state_dict().items()}
    counts, hooks = {}, []
    for name, m in state.model.named_modules():
        if isinstance(m, tnn.BatchNorm2d):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: counts.__setitem__(
                    name, inp[0].shape[0] * inp[0].shape[2] * inp[0].shape[3])))
    got = TS.finetune_step(state, torch.from_numpy(imgs), torch.from_numpy(labels), torch.Generator(),
                           cfg.task, draws=draws)
    for h in hooks:
        h.remove()
    assert state.step == 1 and len(seen) == 1 and seen[0][1] is draws and seen[0][2] == (0, B)
    np.testing.assert_allclose(float(got["loss"]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(got["metric"]), float(jmetric), rtol=1e-5)

    want_g = export_torch_state_dict(grads["model"], {})
    frozen = set(tfreeze.torch_param_order(state.model)[:modules])
    want_p = export_torch_state_dict(jparams["model"], {})
    start = export_torch_state_dict(weights[0], {})
    named = dict(state.model.named_parameters())
    pairs = [(k, named[k], want_g[k], want_p[k], start[k]) for k in want_g]
    hp = {f"classifier.0.{k}": p for k, p in state.head.classifier[0].named_parameters()}
    hg = grads["head"]["fc"]
    pairs += [(k, hp[k], np.asarray(hg[leaf]).T if leaf == "kernel" else np.asarray(hg[leaf]),
               np.asarray(jparams["head"]["fc"][leaf]).T if leaf == "kernel" else np.asarray(jparams["head"]["fc"][leaf]),
               head_before[k].numpy()) for k, leaf in (("classifier.0.weight", "kernel"), ("classifier.0.bias", "bias"))]
    for k, p, g, new, old in pairs:
        if k in frozen:
            assert p.grad is None and torch.equal(p.detach(), before[k]), k
            np.testing.assert_array_equal(new, old, err_msg=k)
            continue
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=1e-4 * np.abs(g).max(), err_msg=f"grad {k}")
        g_l2 = g + 1e-4 * old
        clear = np.abs(g_l2) > 1e-2 * np.abs(g_l2).max()
        du_got, du_want = p.detach().numpy() - old, new - old
        ulp = np.spacing(np.abs(old).astype(np.float32))  # the float32 rounding of old + update
        bad = np.abs(du_got - du_want) > 1e-4 * np.abs(du_want) + 1e-4 * cfg.lr + ulp
        assert not (bad & clear).any(), (k, np.abs(du_got - du_want)[bad & clear].max())
        assert (np.abs(du_got) <= cfg.lr * (1 + 1e-5) + ulp).all(), k

    want_s = export_torch_state_dict(jparams["model"], jstats)
    got_sd = state.model.state_dict()
    for k, v in got_sd.items():
        if k.endswith("running_mean"):
            np.testing.assert_allclose(v.numpy(), want_s[k], rtol=1e-4, atol=1e-6, err_msg=k)
        elif k.endswith("running_var"):
            n = counts[k[: -len(".running_var")]]
            base = 0.9 * before[k].numpy()
            np.testing.assert_allclose(v.numpy() - base, n / (n - 1) * (want_s[k] - base),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    assert torch.equal(got_sd["model.conv1.weight"], before["model.conv1.weight"]) == (modules > 0)
    assert not torch.equal(got_sd["model.bn1.running_mean"], before["model.bn1.running_mean"])


def test_finetune_step_steps_the_schedule(weights):
    """Each step takes one step of the LR schedule: with milestones at steps
    1 and 2 the rate is lr, lr / 10, lr / 100 for the first three updates."""
    cfg = TASKS["kather"]
    state = _port_state(weights, cfg, 60, milestones=[1, 2])
    imgs = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))
    rates = []
    for _ in range(3):
        rates.append(state.optimizer.param_groups[0]["lr"])
        TS.finetune_step(state, imgs, torch.tensor([1, 2]), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(rates, [1e-5, 1e-6, 1e-7], rtol=1e-12)
    assert state.step == 3


@pytest.mark.parametrize("num_classes", [9, 1])
def test_forward_matches_make_forward_fn(weights, num_classes):
    """The eval forward (running BN statistics) against the JAX package's
    make_forward_fn on the same uint8 images, float32 both sides; rtol 1e-3
    / atol 2e-4 as the eval forwards of tests/test_torch_models.py."""
    mparams, stats, heads = weights
    cfg = TASKS["kather"] if num_classes == 9 else TASKS["breastpathq"]
    state = _port_state(weights, cfg, 0)
    imgs = np.random.default_rng(30).integers(0, 256, (3, IMG, IMG, 3), dtype=np.uint8)
    jm, jh = JTripletNet("resnet18"), JFinetuneHead(num_classes)
    jstate = JTrainState(params={"model": mparams, "head": heads[num_classes]}, batch_stats=stats,
                         opt_state=(), step=jnp.zeros([], jnp.int32))
    want = np.asarray(JS.make_forward_fn(jm, jh)(jstate, jnp.asarray(imgs)))
    got = TS.forward(state, torch.from_numpy(imgs))
    assert got.shape == (3, num_classes) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-4)


def test_from_jax_params_carries_the_finetune_head(weights):
    """A FinetuneHead's ``fc`` lands under ``classifier.0.*``, transposed."""
    _, _, heads = weights
    _, head_sd = from_jax_params({}, {}, heads[9])
    assert set(head_sd) == {"classifier.0.weight", "classifier.0.bias"}
    np.testing.assert_array_equal(head_sd["classifier.0.weight"].numpy(), np.asarray(heads[9]["fc"]["kernel"]).T)


# --- the CLI -----------------------------------------------------------------


def _write_kather(root, n_per_class=6, size=32):
    import cv2

    rng = np.random.default_rng(0)
    for c, cls in enumerate(("ADI", "LYM", "TUM")):
        d = os.path.join(root, cls)
        os.makedirs(d)
        for i in range(n_per_class):
            img = np.clip(30 + 70 * c + rng.integers(0, 40, (size, size, 3)), 0, 255).astype(np.uint8)
            cv2.imwrite(os.path.join(d, f"p{i}.tif"), img)


def test_cli_end_to_end_from_pretrain_checkpoint_loads_in_jax(tmp_path):
    """The fine-tune CLI on the CPU (--device cpu) at 32^2, 2 epochs on a
    3-class Kather folder, from a pretrain checkpoint of the port: the CSV
    has a finite row per epoch, best / ckpt_2 / final checkpoints carry the
    reference keys and the optimizer and schedule state, the loaded backbone
    is the pretrain one before training, and the final checkpoint loads in
    the JAX package (load_torch_triplet_checkpoint +
    load_torch_linear_head(..., "classifier")) and gives the port's eval
    logits (rtol 1e-3 / atol 2e-4)."""
    from ssl_cr_histo_tpu_torch.cli import finetune
    from ssl_cr_histo_tpu_torch.train.checkpoint import save_checkpoint
    from ssl_cr_histo_tpu_torch.train.init import init_triplet_state

    data, run = str(tmp_path / "kather"), tmp_path / "run"
    _write_kather(data)
    torch.manual_seed(3)
    pre = init_triplet_state("resnet18", torch.device("cpu"))
    pre_path = str(tmp_path / "pretrain" / "best.pth")
    save_checkpoint(pre_path, pre, {"epoch": 1})

    state = finetune.main(["--task", "kather", "--train_path", data, "--model_path", pre_path,
                           "--save_dir", str(run), "--device", "cpu", "--image_size", "32",
                           "--batch_size", "4", "--num_epoch", "2", "--save_freq", "2", "--modules", "15",
                           "--validation_split", "0.25", "--no-bf16"])
    rows = (run / "fine_tuned_results.csv").read_text().splitlines()
    assert rows[0] == "epoch, train_loss, val_metric" and len(rows) == 3
    for r in rows[1:]:
        vals = [float(v) for v in r.split(",")]
        assert all(np.isfinite(vals)) and 0 <= vals[2] <= 1
    for name in ("best.pth", "ckpt_2.pth", "final.pth"):
        raw = torch.load(run / name, weights_only=False)
        assert {"model", "classifier", "optimizer", "scheduler", "step", "meta"} <= set(raw)
        assert set(raw["classifier"]) == {"classifier.0.weight", "classifier.0.bias"}
        assert raw["classifier"]["classifier.0.weight"].shape == (9, 768)
    final = torch.load(run / "final.pth", weights_only=False)
    assert final["step"] == 2 * 3 and final["scheduler"]["last_epoch"] == 6
    # the frozen tensors are the pretrain checkpoint's
    pre_sd = pre.model.state_dict()
    for k in tfreeze.torch_param_order(state.model)[:15]:
        assert torch.equal(final["model"][k], pre_sd[k]), k

    mparams, mstats = load_torch_triplet_checkpoint(str(run / "final.pth"))
    head = load_torch_linear_head(str(run / "final.pth"), "classifier")
    x = np.random.default_rng(1).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    jstate = JTrainState(params={"model": mparams, "head": head}, batch_stats=mstats, opt_state=(),
                         step=jnp.zeros([], jnp.int32))
    want = np.asarray(JS.make_forward_fn(JTripletNet("resnet18"), JFinetuneHead(9))(jstate, jnp.asarray(x)))
    np.testing.assert_allclose(TS.forward(state, torch.from_numpy(x)).numpy(), want, rtol=1e-3, atol=2e-4)


def test_load_backbone_keeps_the_head_and_strips_module_prefix(tmp_path):
    """load_backbone takes model.* and fc.* with the BN statistics from a
    'model' state_dict, with or without DataParallel's ``module.`` prefix,
    and leaves the fresh head as it was."""
    cfg = TASKS["kather"]
    torch.manual_seed(1)
    donor = TripletNet("resnet18")
    with torch.no_grad():
        donor.model.bn1.running_mean.add_(0.5)
    path = str(tmp_path / "ref.pth")
    torch.save({"model": {f"module.{k}": v for k, v in donor.state_dict().items()}}, path)
    state = init_finetune_state("resnet18", cfg.num_classes, torch.device("cpu"),
                                lambda ps: make_optimizer("adam", ps, cfg.lr))
    head = {k: v.clone() for k, v in state.head.state_dict().items()}
    load_backbone(state, path)
    for k, v in donor.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    assert all(torch.equal(state.head.state_dict()[k], v) for k, v in head.items())


def _flag_run(root, extra):
    """The fine-tune CLI on the CPU at 32^2, one epoch, from a pretrain
    checkpoint of the port, with ``extra`` flags: its save_dir."""
    from ssl_cr_histo_tpu_torch.cli import finetune
    from ssl_cr_histo_tpu_torch.train.checkpoint import save_checkpoint
    from ssl_cr_histo_tpu_torch.train.init import init_triplet_state

    data, pre_path, run = root / "kather", root / "pretrain" / "best.pth", root / "run"
    if not data.exists():
        _write_kather(str(data))
        torch.manual_seed(3)
        save_checkpoint(str(pre_path), init_triplet_state("resnet18", torch.device("cpu")), {"epoch": 1})
    finetune.main(["--task", "kather", "--train_path", str(data), "--model_path", str(pre_path), "--save_dir",
                   str(run), "--device", "cpu", "--image_size", "32", "--batch_size", "4", "--num_epoch", "1",
                   "--save_freq", "0", "--validation_split", "0.25", "--no-bf16"] + extra)
    return run


@pytest.fixture(scope="module")
def plain_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("plain")
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as the runs it is compared with (one_torch_thread)
    try:
        run = _flag_run(root, [])
    finally:
        torch.set_num_threads(n)
    yield run
    shutil.rmtree(root, ignore_errors=True)  # its checkpoints: pytest keeps its last three runs' temp dirs


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for a CLI run at a tiny size (restored after):
    more threads buy nothing there and contend with the other test
    workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("extra", [["--aug_mode", "fast"], ["--aug_mode", "masked"], ["--reference_exact"],
                                   ["--remat"], ["--aug_mode", "exact"]])
def test_cli_rejects_unported(tmp_path, extra, plain_run, monkeypatch, one_torch_thread):
    """Each flag that the CLI once rejected as not ported (the test keeps
    its name from then) runs the CLI on the CPU (32^2, one epoch) and does
    what it does in the JAX CLI: ``--aug_mode`` is accepted and recorded,
    and the 3-view stack has no modes, so the run's final.pth equals the
    plain run's tensor for tensor; so does ``--remat``'s, whose backbone
    recomputes each block in the backward pass (a checkpointed call per
    block and train step); ``--reference_exact`` records float32, exact
    and with-replacement subsampling."""
    from ssl_cr_histo_tpu_torch.models import resnet

    blocks, checkpoint = [], resnet.checkpoint
    monkeypatch.setattr(resnet, "checkpoint", lambda fn, *a, **k: blocks.append(fn) or checkpoint(fn, *a, **k))
    run = _flag_run(tmp_path, extra)
    rows = (run / "fine_tuned_results.csv").read_text().splitlines()
    assert len(rows) == 2 and all(np.isfinite(float(v)) for v in rows[1].split(",")[1:])
    args = torch.load(run / "best.pth", weights_only=False)["meta"]["args"]
    final, plain = (torch.load(r / "final.pth", weights_only=False) for r in (run, plain_run))
    assert (len(blocks) > 0) is (extra == ["--remat"]) and len(blocks) % 8 == 0
    shutil.rmtree(tmp_path, ignore_errors=True)  # its checkpoints: pytest keeps its last three runs' temp dirs
    if extra == ["--reference_exact"]:
        assert (args["bf16"], args["aug_mode"], args["with_replacement"]) == (False, "exact", True)
        return
    assert args["aug_mode"] == (extra[1] if extra[0] == "--aug_mode" else "fused")
    for part in ("model", "classifier"):
        for k, v in plain[part].items():
            assert torch.equal(final[part][k], v), k


@pytest.mark.parametrize("extra,message", [
    (["--mode", "evaluation"], "--finetune_ckpt required for evaluation"),
    (["--resume", "missing/ckpt_3.pth"], "--resume missing/ckpt_3.pth: no such checkpoint"),
])
def test_cli_fails_naming_what_is_missing(tmp_path, extra, message):
    """Evaluation without a checkpoint exits with the JAX CLI's message; a
    --resume file that is not there exits naming it, before any epoch."""
    from ssl_cr_histo_tpu_torch.cli import finetune

    data = str(tmp_path / "kather")
    _write_kather(data)
    argv = ["--task", "kather", "--train_path", data, "--device", "cpu", "--image_size", "32", "--batch_size", "4",
            "--save_dir", str(tmp_path / "run")]
    with pytest.raises(SystemExit, match=message):
        finetune.main(argv + extra)
    assert not (tmp_path / "run" / "fine_tuned_results.csv").exists() or \
        len((tmp_path / "run" / "fine_tuned_results.csv").read_text().splitlines()) == 1


def test_cli_needs_a_gpu_by_default(tmp_path, monkeypatch):
    """Without --device the CLI asks for CUDA and fails when there is none,
    before it reads any data."""
    from ssl_cr_histo_tpu_torch.cli import finetune

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        finetune.main(["--task", "breastpathq", "--train_path", str(tmp_path / "missing")])
