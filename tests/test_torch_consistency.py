"""The port's consistency slice (SSL_CR stage 3) against the JAX package on
the CPU: the consistency step against ``make_consistency_step`` in float64
on JAX's own views, the teacher refresh and EMA against the JAX functions,
the labeled 3-view branch, and the CLI end to end from a fine-tune
checkpoint of the port.

Weights by flax from a seed, carried over with ``from_jax_params``; inputs
made with numpy.  IMG 64 for the model steps (layer4 2x2, as in
tests/test_torch_finetune.py)."""

import os
import shutil

import numpy as np
import pytest
import torch
import torch.nn as tnn

import jax
import jax.numpy as jnp

from ssl_cr_histo_tpu.models import FinetuneHead as JFinetuneHead
from ssl_cr_histo_tpu.models import TripletNet as JTripletNet
from ssl_cr_histo_tpu.ops import batch as JB
from ssl_cr_histo_tpu.parallel import steps as JS
from ssl_cr_histo_tpu.train import freeze as jfreeze
from ssl_cr_histo_tpu.train import optim as joptim
from ssl_cr_histo_tpu.train.checkpoint import export_torch_state_dict
from ssl_cr_histo_tpu.train.state import TrainState as JTrainState
from ssl_cr_histo_tpu_torch.cli.common import TASKS, make_optimizer
from ssl_cr_histo_tpu_torch.ops import batch as TB
from ssl_cr_histo_tpu_torch.parallel import steps as TS
from ssl_cr_histo_tpu_torch.train import freeze as tfreeze
from ssl_cr_histo_tpu_torch.train.checkpoint import from_jax_params, save_checkpoint
from ssl_cr_histo_tpu_torch.train.init import init_finetune_state, init_teacher, load_finetuned

IMG, B, MU, N_AUG = 64, 2, 2, 7


@pytest.fixture(scope="module")
def weights():
    """flax TripletNet + FinetuneHead weights (9 classes and 1 output) from a
    seed, as numpy trees, with BN running statistics moved off their init."""
    jm = JTripletNet("resnet18")
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3), jnp.float32), train=False,
                method=jm.encode_single)
    leaves, tdef = jax.tree_util.tree_flatten(v["batch_stats"])
    ks = jax.random.split(jax.random.PRNGKey(9), len(leaves))
    stats = jax.tree_util.tree_unflatten(tdef, [l + 0.1 * jax.random.uniform(k, l.shape) for l, k in zip(leaves, ks)])
    heads = {n: JFinetuneHead(n).init(jax.random.PRNGKey(n), jnp.zeros((1, 768)))["params"] for n in (9, 1)}
    return jax.device_get(v["params"]), jax.device_get(stats), jax.device_get(heads)


def _port_state(weights, cfg, modules, dtype=torch.float32):
    mparams, stats, heads = weights
    sd, head_sd = from_jax_params(mparams, stats, heads[cfg.num_classes])
    torch.manual_seed(0)
    state = init_finetune_state("resnet18", cfg.num_classes, torch.device("cpu"),
                                lambda ps: make_optimizer(cfg.optimizer, ps, cfg.lr, 1e-4), modules=modules)
    state.model.load_state_dict(sd)
    state.head.load_state_dict(head_sd)
    state.model.to(dtype)
    state.head.to(dtype)
    return state


def _jax_cr_step_f64(weights, cfg, modules, x_l, y_l, x_u, key, monkeypatch, mode="fused"):
    """The JAX package's own consistency step (make_consistency_step, the
    task's Adam under masked_optimizer, the teacher equal to the student)
    with a float64 model and head, on JAX's own views of ``key``: the
    weak/strong views under ``mode`` and the 3-view labeled stack that the step draws from
    ``kl, ku = split(key)``, made in float32 (the fused strong pool does not
    trace under x64) and handed to the step in float64 through its module's
    ``transform_fix_batch`` and ``expand_labeled_batch``.  Returns its
    metrics, new params and batch stats, the gradients of the same loss at
    the same views, the views (x_l, weak, strong; NHWC, un-normalized) and
    the teacher's outputs on the weak views."""
    mparams, stats, heads = weights
    kl, ku = jax.random.split(key)
    weak, strong = JB.transform_fix_batch(ku, jnp.asarray(x_u), n=N_AUG, mode=mode)
    xl, y_rep = JS.expand_labeled_batch(kl, jnp.asarray(x_l), jnp.asarray(y_l), views=3)
    views32 = tuple(np.asarray(v) for v in (xl, weak, strong))
    y_rep = np.asarray(y_rep)
    with jax.enable_x64():
        views = tuple(jnp.asarray(v, jnp.float64) for v in views32)
        monkeypatch.setattr(JS.aug_batch, "transform_fix_batch", lambda k, x, n, mode: (views[1], views[2]))
        monkeypatch.setattr(JS, "expand_labeled_batch", lambda k, x, y, views=3: (views_l, jnp.asarray(y_rep)))
        views_l = views[0]
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        jm = JTripletNet("resnet18", dtype=jnp.float64)
        jh = JFinetuneHead(cfg.num_classes, dtype=jnp.float64)
        params = {"model": f64(mparams), "head": f64(heads[cfg.num_classes])}
        tx = jfreeze.masked_optimizer(joptim.adam(cfg.lr, weight_decay=1e-4), params, modules, "resnet18")
        state = JTrainState(params=params, batch_stats=f64(stats), opt_state=tx.init(params),
                            step=jnp.zeros([], jnp.int32))
        t_params, t_stats = JS.refresh_teacher(state)
        step = JS.make_consistency_step(jm, jh, tx, task=cfg.task, lambda_u=1.0, n_aug=N_AUG, aug_mode=mode,
                                        donate=False)
        new, m = step(state, t_params, t_stats, jnp.asarray(x_l), jnp.asarray(y_l), jnp.asarray(x_u), key)
        monkeypatch.undo()

        enc = lambda p, st, x, train: jm.apply({"params": p["model"], "batch_stats": st}, x, train=train,
                                              mutable=["batch_stats"] if train else False,
                                              method=jm.encode_single)
        out_w = jh.apply({"params": t_params["head"]}, enc(t_params, t_stats, views[1], False))

        def loss_fn(p):
            feats, _ = enc(p, state.batch_stats, jnp.concatenate([views[0], views[2]]), True)
            out = jh.apply({"params": p["head"]}, feats)
            out_l, out_s = out[: len(y_rep)], out[len(y_rep):]
            if cfg.task == "regression":
                return JS.mse(out_l.squeeze(-1), jnp.asarray(y_rep, jnp.float64)) + \
                    JS.mse(out_w.squeeze(-1), out_s.squeeze(-1))
            return JS.cross_entropy(out_l, jnp.asarray(y_rep)) + \
                JS.cross_entropy(out_s, jnp.argmax(jax.nn.softmax(out_w, -1), -1))

        grads = jax.grad(loss_fn)(params)
        return jax.device_get((m, new.params, new.batch_stats, grads, views, out_w))


def _planar64(x):
    return torch.from_numpy(np.asarray(x, np.float64).transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("modules", [0, 60])
@pytest.mark.parametrize("task", ["kather", "breastpathq"])
def test_consistency_step_matches_jax(weights, task, modules, monkeypatch):
    """One consistency step at the task's config (Kather: 9-way CE with
    hard pseudo-labels, Adam 1e-5; BreastPathQ: 1-output MSE with MSE
    consistency, Adam 1e-4; L2 1e-4; lambda_u 1) against the JAX package's
    make_consistency_step run in float64, on JAX's own views (see
    ``_jax_cr_step_f64``): B 2 labeled
    images (6 views) and mu 2 (4 unlabeled images) at 64^2, teacher =
    student.

    The step runs on JAX's views (``views=``) for the reason in
    tests/test_torch_finetune.py::test_finetune_step_matches_jax (this
    random net's gradients move far more with its input than the two
    frameworks differ on equal inputs); the views themselves are
    tests/test_torch_consistency_aug.py's.  Tolerances: loss, sup and cons
    rtol 1e-6; the teacher's pseudo-labels equal (and its outputs rtol
    1e-9); the metric equal; and as in the fine-tune step test: gradients
    atol 1e-4 * max|g| per tensor, the update each trainable param took
    rtol 1e-4 / atol 1e-4 * lr plus one float32 ulp where its L2-added
    gradient is above 1e-2 of its tensor's largest entry, frozen tensors
    bitwise unchanged, every BN layer's statistics (frozen or not, pooled
    over the labeled and strong views) rtol 1e-4 / atol 1e-6 after torch's
    n/(n-1).  The teacher is bit-equal before and after the step."""
    cfg = TASKS[task]
    rng = np.random.default_rng(40 + modules)
    x_l = rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    x_u = rng.integers(0, 256, (B * MU, IMG, IMG, 3), dtype=np.uint8)
    y_l = (rng.integers(0, 9, B).astype(np.int32) if cfg.task == "classification"
           else rng.random(B).astype(np.float32))
    jax_out = _jax_cr_step_f64(weights, cfg, modules, x_l, y_l, x_u, jax.random.PRNGKey(modules + 7), monkeypatch)
    x_lv, weak, strong = (_planar64(v) for v in jax_out[4])
    _assert_cr_step_matches(weights, cfg, modules, jax_out, lambda state, teacher: TS.consistency_step(
        state, teacher, torch.from_numpy(x_l), torch.from_numpy(y_l), torch.from_numpy(x_u), None, cfg.task,
        views=(x_lv, weak, strong)))


def test_consistency_step_fast_matches_jax(weights, monkeypatch):
    """The step under ``aug_mode="fast"`` (the strong pool's op sequence
    shared by the batch) at Kather's config, 60 tensors frozen, against the
    JAX package's step under the same mode in float64, as
    test_consistency_step_matches_jax does for fused: the port's fast views
    on the draws rebuilt from the step's key equal JAX's in float32 (weak
    1e-6, strong 1e-5); then the step, its view functions handed JAX's
    views, with that test's tolerances.  The step asks for the fast views
    of the unlabeled images with NAug strong stages."""
    from test_torch_aug_modes import jax_fast_draws

    cfg, modules = TASKS["kather"], 60
    rng = np.random.default_rng(50)
    x_l = rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    x_u = rng.integers(0, 256, (B * MU, IMG, IMG, 3), dtype=np.uint8)
    y_l = rng.integers(0, 9, B).astype(np.int32)
    key = jax.random.PRNGKey(11)
    jax_out = _jax_cr_step_f64(weights, cfg, modules, x_l, y_l, x_u, key, monkeypatch, mode="fast")
    x_lv, weak, strong = (_planar64(v) for v in jax_out[4])
    ku = jax.random.split(key)[1]
    got_w, got_s = TB.transform_fix_batch(None, torch.from_numpy(x_u), N_AUG, mode="fast",
                                          draws=jax_fast_draws(ku, B * MU, IMG))
    np.testing.assert_allclose(got_w.numpy(), weak.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_s.numpy(), strong.numpy(), rtol=0, atol=1e-5)
    calls = []

    def fast_views(gen, x, n, mode, host_gen, shard):
        calls.append((tuple(x.shape), n, mode, shard))
        return weak, strong

    monkeypatch.setattr(TS.aug_batch, "transform_fix_batch", fast_views)
    monkeypatch.setattr(TS, "expand_labeled_batch",
                        lambda gen, x, y, views, shard: (x_lv, y.repeat_interleave(3)))
    _assert_cr_step_matches(weights, cfg, modules, jax_out, lambda state, teacher: TS.consistency_step(
        state, teacher, torch.from_numpy(x_l), torch.from_numpy(y_l), torch.from_numpy(x_u), None, cfg.task,
        n_aug=N_AUG, aug_mode="fast"))
    assert calls == [((B * MU, IMG, IMG, 3), N_AUG, "fast", (0, B * MU))]


def _assert_cr_step_matches(weights, cfg, modules, jax_out, run_step):
    """``run_step(state, teacher)``, a consistency step of the port's float64
    state on JAX's views, against the JAX step's ``jax_out``
    (``_jax_cr_step_f64``), with the tolerances of
    test_consistency_step_matches_jax."""
    jm, jparams, jstats, grads, views, out_w = jax_out
    state = _port_state(weights, cfg, modules, torch.float64)
    teacher = init_teacher(state)
    t_before = {k: v.clone() for k, v in {**teacher.model.state_dict(), **teacher.head.state_dict()}.items()}
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    head_before = {k: v.clone() for k, v in state.head.state_dict().items()}
    x_lv, weak, strong = (_planar64(v) for v in views)
    with torch.no_grad():
        t_out = teacher.head(teacher.model.encode_single(weak))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(out_w), rtol=1e-9, atol=1e-12)
    if cfg.task == "classification":
        np.testing.assert_array_equal(t_out.argmax(-1).numpy(), np.asarray(out_w).argmax(-1))
    counts, hooks = {}, []
    for name, mod in state.model.named_modules():
        if isinstance(mod, tnn.BatchNorm2d):
            hooks.append(mod.register_forward_hook(
                lambda m_, inp, out, name=name: counts.__setitem__(
                    name, inp[0].shape[0] * inp[0].shape[2] * inp[0].shape[3])))
    got = run_step(state, teacher)
    for h in hooks:
        h.remove()
    assert state.step == 1
    for k in ("loss", "sup", "cons"):
        np.testing.assert_allclose(float(got[k]), float(jm[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(got["metric"]), float(jm["metric"]), rtol=1e-6)
    for k, v in {**teacher.model.state_dict(), **teacher.head.state_dict()}.items():
        assert torch.equal(v, t_before[k]), f"teacher {k} moved"
    assert not teacher.model.training and not any(p.requires_grad for p in teacher.model.parameters())

    want_g = export_torch_state_dict(grads["model"], {})
    frozen = set(tfreeze.torch_param_order(state.model)[:modules])
    want_p = export_torch_state_dict(jparams["model"], {})
    start = export_torch_state_dict(weights[0], {})
    named = dict(state.model.named_parameters())
    pairs = [(k, named[k], want_g[k], want_p[k], start[k]) for k in want_g]
    hp = {f"classifier.0.{k}": p for k, p in state.head.classifier[0].named_parameters()}
    hg, hn = grads["head"]["fc"], jparams["head"]["fc"]
    tr = lambda leaf, a: np.asarray(a).T if leaf == "kernel" else np.asarray(a)
    pairs += [(k, hp[k], tr(leaf, hg[leaf]), tr(leaf, hn[leaf]), head_before[k].numpy())
              for k, leaf in (("classifier.0.weight", "kernel"), ("classifier.0.bias", "bias"))]
    for k, p, g, new, old in pairs:
        if k in frozen:
            assert p.grad is None and torch.equal(p.detach(), before[k]), k
            np.testing.assert_array_equal(new, old, err_msg=k)
            continue
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=1e-4 * np.abs(g).max(), err_msg=f"grad {k}")
        g_l2 = g + 1e-4 * old
        clear = np.abs(g_l2) > 1e-2 * np.abs(g_l2).max()
        du_got, du_want = p.detach().numpy() - old, new - old
        ulp = np.spacing(np.abs(old).astype(np.float32))
        bad = np.abs(du_got - du_want) > 1e-4 * np.abs(du_want) + 1e-4 * cfg.lr + ulp
        assert not (bad & clear).any(), (k, np.abs(du_got - du_want)[bad & clear].max())

    want_s = export_torch_state_dict(jparams["model"], jstats)
    for k, v in state.model.state_dict().items():
        if k.endswith("running_mean"):
            np.testing.assert_allclose(v.numpy(), want_s[k], rtol=1e-4, atol=1e-6, err_msg=k)
        elif k.endswith("running_var"):
            n = counts[k[: -len(".running_var")]]
            base = 0.9 * before[k].numpy()
            np.testing.assert_allclose(v.numpy() - base, n / (n - 1) * (want_s[k] - base),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    assert counts["model.bn1"] == (3 * B + B * MU) * (IMG // 2) ** 2


def test_consistency_step_draws_its_views_and_steps_the_schedule(weights):
    """Without ``views`` the step draws the weak/strong views (tables from
    ``host_gen``) and the 3-view stack itself: equal generators give equal
    steps; the LR schedule takes one step per step."""
    cfg = TASKS["kather"]
    rng = np.random.default_rng(0)
    x_l = torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))
    x_u = torch.from_numpy(rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8))
    out = []
    for _ in range(2):
        state = _port_state(weights, cfg, 60)
        state.scheduler.milestones.update({1: 1})
        teacher = init_teacher(state)
        m = TS.consistency_step(state, teacher, x_l, torch.tensor([1, 4]), x_u, torch.Generator().manual_seed(1),
                                host_gen=torch.Generator().manual_seed(2))
        out.append((float(m["loss"]), state.head.classifier[0].weight.detach().clone()))
        assert np.isfinite(out[-1][0]) and state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-6)
    assert out[0][0] == out[1][0] and torch.equal(out[0][1], out[1][1])


@pytest.mark.parametrize("views", [1, 3])
def test_expand_labeled_batch_matches_jax(views):
    """The labeled branch against the JAX package's expand_labeled_batch on
    the same key (the 3-view draws rebuilt as in tests/test_torch_finetune.py):
    views 3 is the 3-view stack b-major with labels repeated (atol 1e-5),
    views 1 the images themselves."""
    from test_torch_finetune import jax_3view_draws

    key = jax.random.PRNGKey(4)
    imgs = np.random.default_rng(1).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    y = np.array([2, 0, 5], np.int32)
    want_x, want_y = JS.expand_labeled_batch(key, jnp.asarray(imgs), jnp.asarray(y), views=views)
    draws = jax_3view_draws(key, 3) if views == 3 else None
    got_x, got_y = TS.expand_labeled_batch(None, torch.from_numpy(imgs), torch.from_numpy(y), views, draws)
    assert got_x.shape == (3 * views, 3, 32, 32)
    np.testing.assert_allclose(got_x.permute(0, 2, 3, 1).numpy(), np.asarray(want_x), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    with pytest.raises(ValueError):
        TS.expand_labeled_batch(None, torch.from_numpy(imgs), torch.from_numpy(y), 2)


def test_refresh_teacher_and_ema_match_jax(weights):
    """ema_update (decay 0.9) moves every parameter and BN running statistic
    of the teacher as the JAX package's ema_update does on the same trees,
    rtol 1e-6 / atol 1e-7; refresh_teacher copies the student's parameters
    and BN buffers into it exactly, as JAX's refresh_teacher copies the
    params and batch_stats trees; the teacher stays in eval mode without
    gradients."""
    state = _port_state(weights, TASKS["kather"], 0)
    teacher = init_teacher(state)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():  # move the student, parameters and statistics
        for t in list(state.model.state_dict().values()) + list(state.head.state_dict().values()):
            if t.is_floating_point():
                t.add_(0.05 * torch.randn(t.shape, generator=g))
    sd = lambda tc: {**tc.model.state_dict(), **tc.head.state_dict()}
    floats = lambda d: {k: jnp.asarray(v.numpy()) for k, v in d.items() if v.is_floating_point()}
    want = JS.ema_update(floats(sd(teacher)), floats(sd(state)), 0.9)
    TS.ema_update(teacher, state, 0.9)
    got = sd(teacher)
    assert want.keys() == {k for k, v in got.items() if v.is_floating_point()}
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=1e-6, atol=1e-7, err_msg=k)

    TS.refresh_teacher(teacher, state)
    student = sd(state)
    jstate = JTrainState(params=floats(student), batch_stats={}, opt_state=(), step=0)
    want_p, _ = JS.refresh_teacher(jstate)
    for k, v in sd(teacher).items():
        assert torch.equal(v, student[k]), k
        if k in want_p:
            np.testing.assert_array_equal(v.numpy(), np.asarray(want_p[k]))
    assert not teacher.model.training and not teacher.head.training
    assert not any(p.requires_grad for p in list(teacher.model.parameters()) + list(teacher.head.parameters()))


def test_load_finetuned_takes_model_and_head_with_module_prefix(tmp_path):
    """load_finetuned takes 'model' (with BN statistics) and 'classifier'
    from a fine-tune checkpoint, with or without DataParallel's ``module.``
    prefix, and rejects a pretraining checkpoint without the head."""
    cfg = TASKS["kather"]
    mk = lambda seed: (torch.manual_seed(seed), init_finetune_state(
        "resnet18", cfg.num_classes, torch.device("cpu"), lambda ps: make_optimizer("adam", ps, cfg.lr)))[1]
    donor = mk(1)
    with torch.no_grad():
        donor.model.model.bn1.running_mean.add_(0.5)
    ref = str(tmp_path / "ref.pth")
    torch.save({"model": {f"module.{k}": v for k, v in donor.model.state_dict().items()},
                "classifier": {f"module.{k}": v for k, v in donor.head.state_dict().items()}}, ref)
    for path in (ref, str(tmp_path / "port.pth")):
        if path.endswith("port.pth"):
            save_checkpoint(path, donor, {"epoch": 1})
        state = mk(2)
        load_finetuned(state, path)
        for mod, want in ((state.model, donor.model), (state.head, donor.head)):
            for k, v in want.state_dict().items():
                assert torch.equal(mod.state_dict()[k], v), k
    torch.save({"model": donor.model.state_dict()}, str(tmp_path / "pre.pth"))
    with pytest.raises(ValueError, match="fine-tune checkpoint"):
        load_finetuned(mk(3), str(tmp_path / "pre.pth"))


# --- the CLI -----------------------------------------------------------------


def _write_kather(root, n_per_class=8, size=32):
    import cv2

    rng = np.random.default_rng(0)
    for c, cls in enumerate(("ADI", "LYM", "TUM")):
        d = os.path.join(root, cls)
        os.makedirs(d)
        for i in range(n_per_class):
            img = np.clip(30 + 70 * c + rng.integers(0, 40, (size, size, 3)), 0, 255).astype(np.uint8)
            cv2.imwrite(os.path.join(d, f"p{i}.png"), img)


def _finetune_checkpoint(path):
    cfg = TASKS["kather"]
    torch.manual_seed(5)
    state = init_finetune_state("resnet18", cfg.num_classes, torch.device("cpu"),
                                lambda ps: make_optimizer("adam", ps, cfg.lr))
    save_checkpoint(path, state, {"epoch": 1})
    return state


def test_cli_end_to_end_from_finetune_checkpoint(tmp_path):
    """The consistency CLI on the CPU (--device cpu) at 32^2, batch 2, mu 2,
    2 epochs of 4 steps on a 3-class Kather folder, from a fine-tune
    checkpoint of the port: the CSV has a finite row per epoch with its five
    columns; best / ckpt_2 / final carry the fine-tune layout with the
    optimizer and schedule; the tensors below --modules_student 60 are the
    fine-tune checkpoint's, the head moved; the schedule took 8 steps."""
    from ssl_cr_histo_tpu_torch.cli import consistency

    data, run, ft = str(tmp_path / "kather"), tmp_path / "run", str(tmp_path / "ft" / "best.pth")
    _write_kather(data)
    ft_state = _finetune_checkpoint(ft)
    state = consistency.main(["--task", "kather", "--train_path", data, "--finetune_ckpt", ft, "--save_dir", str(run),
                              "--device", "cpu", "--image_size", "32", "--batch_size", "2", "--mu", "2",
                              "--num_epoch", "2", "--save_freq", "2", "--labeled_train", "0.5",
                              "--validation_split", "0.25", "--no-bf16"])
    rows = (run / "consistency_results.csv").read_text().splitlines()
    assert rows[0] == "epoch, train_loss, sup_loss, cons_loss, val_metric" and len(rows) == 3
    for r in rows[1:]:
        vals = [float(v) for v in r.split(",")]
        assert len(vals) == 5 and all(np.isfinite(vals)) and 0 <= vals[4] <= 1
        np.testing.assert_allclose(vals[1], vals[2] + vals[3], rtol=1e-5)
    for name in ("best.pth", "ckpt_2.pth", "final.pth"):
        raw = torch.load(run / name, weights_only=False)
        assert {"model", "classifier", "optimizer", "scheduler", "step", "meta"} <= set(raw)
        assert raw["classifier"]["classifier.0.weight"].shape == (9, 768)
    assert not (run / "teacher_final.pth").exists()
    final = torch.load(run / "final.pth", weights_only=False)
    assert final["step"] == 8 and final["scheduler"]["last_epoch"] == 8
    ft_sd = ft_state.model.state_dict()
    for k in tfreeze.torch_param_order(state.model)[:60]:
        assert torch.equal(final["model"][k], ft_sd[k]), k
    assert not torch.equal(final["classifier"]["classifier.0.weight"], ft_state.head.state_dict()["classifier.0.weight"])


def test_cli_ema_teacher_checkpoints(tmp_path):
    """Under --ema the teacher is EMA-updated after each step and saved as
    its own teacher_final.pth (and teacher_best.pth), which differs from the
    student's final.pth."""
    from ssl_cr_histo_tpu_torch.cli import consistency

    data, run, ft = str(tmp_path / "kather"), tmp_path / "run", str(tmp_path / "ft" / "best.pth")
    _write_kather(data, n_per_class=6)
    _finetune_checkpoint(ft)
    consistency.main(["--task", "kather", "--train_path", data, "--finetune_ckpt", ft, "--save_dir", str(run),
                      "--device", "cpu", "--image_size", "32", "--batch_size", "2", "--mu", "2", "--num_epoch", "1",
                      "--save_freq", "0", "--labeled_train", "0.5", "--ema", "0.5", "--modules_student", "0",
                      "--lr", "1e-3", "--no-bf16"])
    student = torch.load(run / "final.pth", weights_only=False)
    teacher = torch.load(run / "teacher_final.pth", weights_only=False)
    assert set(teacher) == {"model", "classifier", "meta"} and teacher["meta"]["role"] == "teacher"
    assert (run / "teacher_best.pth").exists()
    assert not torch.equal(student["model"]["model.conv1.weight"], teacher["model"]["model.conv1.weight"])


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for a CLI run at a tiny size (restored after):
    more threads buy nothing there and contend with the other test
    workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("extra", [["--remat"], ["--aug_mode", "fast"], ["--aug_mode", "masked"],
                                   ["--aug_mode", "exact"], ["--reference_exact"]])
def test_cli_rejects_unported(tmp_path, extra, monkeypatch, one_torch_thread):
    """Each flag that the CLI once rejected as not ported (the test keeps
    its name from then) runs the CLI on the CPU (32^2, batch 2, mu 2, one
    epoch of 2 steps) and does what it says: ``--aug_mode`` gives every
    step's unlabeled images its mode's views; ``--remat`` recomputes the
    student's blocks in the backward pass (a checkpointed call per block
    and train pass), and nothing else does; ``--reference_exact`` gives
    exact views, float32 and with-replacement subsampling.  The CSV row is
    finite and best.pth records the flags."""
    from ssl_cr_histo_tpu_torch.cli import consistency
    from ssl_cr_histo_tpu_torch.models import resnet

    data, run, ft = str(tmp_path / "kather"), tmp_path / "run", str(tmp_path / "ft" / "best.pth")
    _write_kather(data, n_per_class=6)
    _finetune_checkpoint(ft)
    modes, blocks = [], []
    views, checkpoint = TS.aug_batch.transform_fix_batch, resnet.checkpoint
    monkeypatch.setattr(TS.aug_batch, "transform_fix_batch",
                        lambda *a, mode="fused", **k: modes.append(mode) or views(*a, mode=mode, **k))
    monkeypatch.setattr(resnet, "checkpoint", lambda fn, *a, **k: blocks.append(fn) or checkpoint(fn, *a, **k))
    state = consistency.main(["--task", "kather", "--train_path", data, "--finetune_ckpt", ft, "--save_dir",
                              str(run), "--device", "cpu", "--image_size", "32", "--batch_size", "2", "--mu", "2",
                              "--num_epoch", "1", "--save_freq", "0", "--labeled_train", "0.3",
                              "--modules_student", "0", "--no-bf16"] + extra)
    rows = (run / "consistency_results.csv").read_text().splitlines()
    assert len(rows) == 2 and all(np.isfinite(float(v)) for v in rows[1].split(",")[1:])
    args = torch.load(run / "best.pth", weights_only=False)["meta"]["args"]
    want = extra[1] if extra[0] == "--aug_mode" else "exact" if extra == ["--reference_exact"] else "fused"
    assert len(modes) == 2 and set(modes) == {want} and args["aug_mode"] == want
    remat = extra == ["--remat"]
    assert state.model.model.remat is remat and len(blocks) == (2 * 8 if remat else 0)
    if extra == ["--reference_exact"]:
        assert args["bf16"] is False and args["with_replacement"] is True
    shutil.rmtree(tmp_path, ignore_errors=True)  # its checkpoints: pytest keeps its last three runs' temp dirs


@pytest.mark.parametrize("extra,message", [
    (["--mode", "evaluation"], "--eval_ckpt required for evaluation"),
    (["--resume", "missing/ckpt_3.pth"], "--resume missing/ckpt_3.pth: no such checkpoint"),
])
def test_cli_fails_naming_what_is_missing(tmp_path, extra, message):
    """Evaluation with neither --eval_ckpt nor --finetune_ckpt exits with
    the JAX CLI's message; a --resume file that is not there exits naming
    it, before any epoch."""
    from ssl_cr_histo_tpu_torch.cli import consistency

    data, ft = str(tmp_path / "kather"), str(tmp_path / "ft" / "best.pth")
    _write_kather(data)
    _finetune_checkpoint(ft)
    argv = ["--task", "kather", "--train_path", data, "--device", "cpu", "--image_size", "32", "--batch_size", "2",
            "--mu", "2", "--labeled_train", "0.5", "--save_dir", str(tmp_path / "run")]
    if extra[0] == "--resume":
        argv += ["--finetune_ckpt", ft]
    with pytest.raises(SystemExit, match=message):
        consistency.main(argv + extra)
    assert not (tmp_path / "run" / "consistency_results.csv").exists() or \
        len((tmp_path / "run" / "consistency_results.csv").read_text().splitlines()) == 1


def test_cli_needs_a_gpu_by_default(tmp_path, monkeypatch):
    """Without --device the CLI asks for CUDA and fails when there is none,
    before it reads any data."""
    from ssl_cr_histo_tpu_torch.cli import consistency

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        consistency.main(["--task", "kather", "--train_path", str(tmp_path / "missing"), "--finetune_ckpt", "x.pth"])


def test_cr_batch_of_record():
    """The consistency batch per task (``common.py:30-58``): BreastPathQ 4,
    Kather 8, Camelyon16 8, as the JAX package's TaskConfig.cr_batch."""
    from ssl_cr_histo_tpu.cli.common import TASKS as JTASKS

    for name, cfg in TASKS.items():
        assert cfg.cr_batch == JTASKS[name].cr_batch == {"breastpathq": 4, "kather": 8, "camelyon16": 8}[name]
