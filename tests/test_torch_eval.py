"""The port's ``--mode evaluation`` against the JAX package on the CPU: the
eval logits of ``predict_all`` on the same weights and images, the report
against the JAX evaluator's on the same logits, both stage CLIs end to end
with every artifact the JAX evaluator writes, the two-rater BreastPathQ
loader, the port's copy of ``eval/reporting.py``, and the numpy F1 and
ROC-AUCs of the port's metrics against scikit-learn.

Weights: a flax resnet18 TripletNet and the task's FinetuneHead from a seed,
carried into the port with ``from_jax_params``; images of 32^2 made with
numpy from a seed.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from camelyon_fixtures import class_entries, write_annotation_jsons, write_patch_dir
from ssl_cr_histo_tpu.cli import finetune as JF
from ssl_cr_histo_tpu.cli.common import TASKS as JTASKS
from ssl_cr_histo_tpu.data import datasets as JD
from ssl_cr_histo_tpu.eval import reporting as JR
from ssl_cr_histo_tpu.models import FinetuneHead as JFinetuneHead
from ssl_cr_histo_tpu.models import TripletNet as JTripletNet
from ssl_cr_histo_tpu.parallel import steps as JS
from ssl_cr_histo_tpu.train.state import TrainState as JTrainState
from ssl_cr_histo_tpu_torch.cli import consistency, finetune
from ssl_cr_histo_tpu_torch.cli.common import TASKS, make_optimizer
from ssl_cr_histo_tpu_torch.data import datasets as TD
from ssl_cr_histo_tpu_torch.eval import metrics as TM
from ssl_cr_histo_tpu_torch.eval import reporting as TR
from ssl_cr_histo_tpu_torch.train.checkpoint import from_jax_params, save_checkpoint
from ssl_cr_histo_tpu_torch.train.init import init_finetune_state

S, BATCH = 32, 4
TASK_NAMES = ("kather", "breastpathq", "camelyon16")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the file's torch work (restored after): at
    these sizes more threads buy nothing, and under the six-worker run they
    contend with the other workers' for the cores, which made this file
    ~20x slower there. Each comparison's runs share the setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tasks, name):
    return dataclasses.replace(tasks[name], image_size=S)


@pytest.fixture(scope="module")
def weights():
    """flax TripletNet weights (BN statistics moved off 0 and 1, so the eval
    forward depends on them) and a FinetuneHead for 9, 2 and 1 outputs, as
    numpy trees."""
    jm = JTripletNet("resnet18")
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, S, S, 3)), train=False, method=jm.encode_single))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.0, 0.2, np.shape(a)).astype(np.float32), jax.device_get(v["batch_stats"]))
    heads = {n: jax.device_get(JFinetuneHead(n).init(jax.random.PRNGKey(n), jnp.zeros((1, 768)))["params"])
             for n in (9, 2, 1)}
    return jax.device_get(v["params"]), stats, heads


def _write_h5(d, x, y):
    import h5py

    os.makedirs(d)
    with h5py.File(os.path.join(d, "part0.h5"), "w") as f:
        f["x"] = x
        f["y"] = y


@pytest.fixture(scope="module")
def test_sets(tmp_path_factory):
    """Seeded test sets of each task at 32^2: Kather, two images in each of
    the nine class folders; BreastPathQ, 10 patches scored by two raters;
    Camelyon16, 6 tumor and 6 normal patches with their annotations."""
    root = tmp_path_factory.mktemp("eval_sets")
    rng = np.random.default_rng(11)
    kather = root / "kather"
    for c, cls in enumerate(TD.KATHER_CLASSES):
        os.makedirs(kather / cls)
        for i in range(2):
            img = np.clip(20 * c + rng.integers(0, 80, (S, S, 3)), 0, 255).astype(np.uint8)
            cv2.imwrite(str(kather / cls / f"p{i}.png"), img)
    x = rng.random((10, 3, S, S)).astype(np.float32)
    y_a = rng.random(10).astype(np.float32)
    _write_h5(str(root / "bpq_a"), x, y_a)
    _write_h5(str(root / "bpq_b"), x, np.clip(y_a + rng.normal(0, 0.1, 10), 0, 1).astype(np.float32))
    c16 = root / "c16"
    entries = class_entries("Tumor_026", 50, 6, seed=1) + class_entries("Normal_040", 50, 6, seed=2)
    write_patch_dir(c16 / "test", entries)
    write_annotation_jsons(c16 / "json")
    return {"kather": {"test_path": str(kather)},
            "breastpathq": {"test_path": str(root / "bpq_a"), "test_path_b": str(root / "bpq_b")},
            "camelyon16": {"test_path": str(c16 / "test"), "json_path": str(c16 / "json")}}


def _jax_state(weights, n):
    mparams, stats, heads = weights
    return JTrainState(params={"model": mparams, "head": heads[n]}, batch_stats=stats, opt_state=(),
                       step=jnp.zeros([], jnp.int32))


def _port_ckpt(weights, n, path):
    """A fine-tune checkpoint of the port holding the JAX weights."""
    mparams, stats, heads = weights
    sd, head_sd = from_jax_params(mparams, stats, heads[n])
    state = init_finetune_state("resnet18", n, CPU, lambda ps: make_optimizer("adam", ps, 1e-5))
    state.model.load_state_dict(sd)
    state.head.load_state_dict(head_sd)
    save_checkpoint(str(path), state, {"epoch": 1})
    return state


def _jax_evaluate(weights, task, sets, save_dir, out=None):
    """The JAX package's evaluator on ``task``'s test set; with ``out`` its
    predict_all returns those outputs instead of its own forward's."""
    cfg = _cfg(JTASKS, task)
    args = SimpleNamespace(**{"save_dir": str(save_dir), "test_path": "", "test_path_b": "", "json_path": "",
                              **sets[task]})
    forward = JS.make_forward_fn(JTripletNet("resnet18"), JFinetuneHead(cfg.num_classes))
    real = JF.predict_all
    if out is not None:
        JF.predict_all = lambda *a, **kw: out
    try:
        JF.evaluate(args, cfg, _jax_state(weights, cfg.num_classes), forward, eval_batch_size=BATCH)
    finally:
        JF.predict_all = real
    with open(os.path.join(save_dir, f"{task}_eval.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def evaluated(weights, test_sets, tmp_path_factory):
    """Per task: the port's CLI ``--mode evaluation`` on a port checkpoint of
    the weights (its save dir, and its outputs recorded from predict_all),
    and the JAX package's predict_all on the same weights and images (its
    logits) and its evaluator on those outputs (its save dir)."""
    out = {}
    for task in TASK_NAMES:
        root = tmp_path_factory.mktemp(f"eval_{task}")
        cfg = _cfg(TASKS, task)
        ckpt = root / "ft" / "best.pth"
        _port_ckpt(weights, cfg.num_classes, ckpt)
        seen = []
        real = finetune.predict_all

        def record(*a, **kw):
            seen.append(real(*a, **kw))
            return seen[-1]

        finetune.predict_all = record
        try:
            argv = ["--task", task, "--mode", "evaluation", "--finetune_ckpt", str(ckpt), "--save_dir",
                    str(root / "port"), "--device", "cpu", "--image_size", str(S), "--eval_batch_size",
                    str(BATCH), "--no-bf16"]
            for k, v in test_sets[task].items():
                argv += [f"--{k}", v]
            report = finetune.main(argv)
        finally:
            finetune.predict_all = real
        jcfg = _cfg(JTASKS, task)
        jds = (JD.load_breastpathq_h5(test_sets[task]["test_path"], S) if task == "breastpathq" else
               JD.load_camelyon16_patches(test_sets[task]["test_path"], test_sets[task]["json_path"], S, split=None)
               if task == "camelyon16" else JD.load_kather_folder(test_sets[task]["test_path"], S))
        forward = JS.make_forward_fn(JTripletNet("resnet18"), JFinetuneHead(jcfg.num_classes))
        jlogits = JF.predict_all(_jax_state(weights, jcfg.num_classes), forward, jds, jcfg, raw=True,
                                 batch_size=BATCH)
        jreport = _jax_evaluate(weights, task, test_sets, root / "jax",
                                out=np.asarray(jlogits)[:, 0] if task == "breastpathq" else jlogits)
        out[task] = SimpleNamespace(root=root, report=report, out=seen[0], jlogits=np.asarray(jlogits),
                                    jreport=jreport, labels=np.asarray(jds.labels))
    return out


@pytest.mark.parametrize("task", TASK_NAMES)
def test_predict_all_matches_jax(evaluated, task):
    """The port's predict_all logits (raw; BreastPathQ's scores) within
    1e-4 of the JAX package's predict_all on the same weights and images,
    in order, the last short batch kept."""
    e = evaluated[task]
    want = e.jlogits[:, 0] if task == "breastpathq" else e.jlogits
    assert e.out.shape == want.shape and e.out.dtype == np.float32
    np.testing.assert_allclose(e.out, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("task", TASK_NAMES)
def test_report_is_the_jax_evaluators_on_the_same_outputs(evaluated, weights, test_sets, task):
    """The port's report (what its CLI printed and wrote) equals, key for
    key and value for value, what the JAX evaluator writes when its
    predict_all returns the port's outputs: the same metric functions of
    the same logits."""
    e = evaluated[task]
    want = _jax_evaluate(weights, task, test_sets, e.root / "jax_same", out=e.out)
    with open(e.root / "port" / f"{task}_eval.json") as f:
        got = json.load(f)
    assert got == json.loads(json.dumps(e.report, default=float))
    assert list(got) == list(want)
    np.testing.assert_equal(got, want)


@pytest.mark.parametrize("task", TASK_NAMES)
def test_cli_evaluation_writes_what_jax_writes(evaluated, task):
    """The port CLI's artifacts carry the JAX evaluator's names (the JSON,
    the confusion plot or BreastPathQ's scatter and Bland-Altman plots per
    pairing); its metrics are the JAX run's within what 1e-4 of logits
    moves; the confusion equals JAX's wherever no logit margin is under
    1e-4 and sums to the set's size."""
    e = evaluated[task]
    assert sorted(os.listdir(e.root / "port")) == sorted(os.listdir(e.root / "jax"))
    assert all(os.path.getsize(e.root / "port" / n) > 0 for n in os.listdir(e.root / "port"))
    got, want = e.report, e.jreport
    assert list(got) == list(want)
    if task == "breastpathq":
        for k in ("icc_MA", "icc_MB"):
            for name, v in want[k].items():
                np.testing.assert_allclose(got[k][name], v, rtol=0, atol=1e-3, err_msg=f"{k} {name}")
        assert got["icc_AB"] == pytest.approx(want["icc_AB"], abs=1e-12)
        assert got["mse_MA"] == pytest.approx(want["mse_MA"], abs=1e-4)
        return
    top2 = np.sort(e.jlogits, -1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) >= 1e-4
    np.testing.assert_array_equal(e.out.argmax(-1)[clear], e.jlogits.argmax(-1)[clear])
    assert int(np.sum(got["confusion"])) == len(e.labels)
    if clear.all():
        assert got["confusion"] == want["confusion"]
        assert got["accuracy"] == want["accuracy"] and got["weighted_f1"] == pytest.approx(want["weighted_f1"])
    auc = "auc" if task == "camelyon16" else "ovr_auc"
    assert got[auc] == pytest.approx(want[auc], abs=1e-3)


def test_consistency_cli_evaluation(evaluated, test_sets, tmp_path):
    """The consistency CLI's --mode evaluation scores --eval_ckpt, or else
    --finetune_ckpt, through the same evaluator: the reports equal the
    fine-tune CLI's on the same checkpoint."""
    ckpt = str(evaluated["kather"].root / "ft" / "best.pth")
    base = ["--task", "kather", "--mode", "evaluation", "--device", "cpu", "--image_size", str(S),
            "--eval_batch_size", str(BATCH), "--no-bf16", "--test_path", test_sets["kather"]["test_path"]]
    a = consistency.main(base + ["--eval_ckpt", ckpt, "--save_dir", str(tmp_path / "a")])
    b = consistency.main(base + ["--finetune_ckpt", ckpt, "--save_dir", str(tmp_path / "b")])
    assert a == b == evaluated["kather"].report
    assert sorted(os.listdir(tmp_path / "a")) == ["kather_confusion.png", "kather_eval.json"]


def test_load_breastpathq_eval_pair_matches_jax(test_sets, tmp_path):
    """The two-rater set equals the JAX loader's (images, rater A's labels,
    rater B's); sets of unequal size raise in both."""
    a, b = test_sets["breastpathq"]["test_path"], test_sets["breastpathq"]["test_path_b"]
    ds, lb = TD.load_breastpathq_eval_pair(a, b, S)
    jds, jlb = JD.load_breastpathq_eval_pair(a, b, S)
    np.testing.assert_array_equal(ds.images, jds.images)
    np.testing.assert_array_equal(ds.labels, jds.labels)
    np.testing.assert_array_equal(lb, jlb)
    _write_h5(str(tmp_path / "short"), np.zeros((3, 3, S, S), np.float32), np.zeros(3, np.float32))
    for load in (TD.load_breastpathq_eval_pair, JD.load_breastpathq_eval_pair):
        with pytest.raises(ValueError, match="differ in size"):
            load(a, str(tmp_path / "short"), S)


def test_reporting_writes_what_jax_writes(tmp_path):
    """The port's reporting copy writes the files the JAX module writes for
    the same calls (tests/test_reporting.py's checks): the confusion
    matrix (raw and normalized), the t-SNE plot with its _feats/_targets
    arrays (equal to JAX's), the scatter and Bland-Altman plots."""
    rng = np.random.default_rng(0)
    feats = np.concatenate([rng.normal(i, 0.1, (20, 16)) for i in range(3)])
    labels = np.repeat(np.arange(3), 20)
    a = np.linspace(0, 1, 30)
    b = a + rng.normal(0, 0.05, 30)
    for mod, d in ((TR, tmp_path / "port"), (JR, tmp_path / "jax")):
        os.makedirs(d)
        mod.save_confusion_matrix_plot(np.array([[5, 1], [2, 7]]), ["neg", "pos"], str(d / "cm.png"))
        mod.save_confusion_matrix_plot(np.array([[5, 1], [2, 7]]), ["neg", "pos"], str(d / "cmn.png"), normalize=True)
        with threadpool_limits(1):  # scikit-learn's t-SNE stalls on a busy host with an OpenMP thread a core
            mod.save_tsne_plot(feats, labels, str(d / "tsne.png"), perplexity=5)
        mod.save_scatter_plot(a, b, "rater", "model", str(d / "sc.png"))
        mod.save_bland_altman_plot(a, b, str(d / "ba.png"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and "tsne_feats.npy" in names
    assert all(os.path.getsize(tmp_path / "port" / n) > 0 for n in names)
    for n in ("tsne_feats.npy", "tsne_targets.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / n), np.load(tmp_path / "jax" / n))


def _sklearn_cases():
    rng = np.random.default_rng(8)
    y = rng.integers(0, 4, 60)
    cases = {
        "random": (y, np.where(rng.random(60) < 0.6, y, rng.integers(0, 4, 60))),
        "a label never predicted": (y, np.where(y == 3, 0, y)),
        "a predicted label never true": (np.where(y == 3, 0, y), y),
    }
    # scores with ties (rounded), as a low-resolution classifier gives
    probs = np.round(rng.random((60, 4)), 1) + 0.05
    return cases, y, probs / probs.sum(1, keepdims=True)


@pytest.mark.parametrize("case", ["random", "a label never predicted", "a predicted label never true"])
def test_numpy_metrics_match_sklearn(case):
    """The port's numpy weighted F1 and ROC-AUCs against scikit-learn's
    f1_score(average='weighted') and roc_auc_score (binary, and one-vs-rest
    over classes), with tied scores; and the ValueError where scikit-learn
    raises (a class missing from y_true; rows not summing to 1), and where
    one class is present."""
    from sklearn.metrics import f1_score, roc_auc_score

    cases, y, probs = _sklearn_cases()
    y_true, y_pred = cases[case]
    assert TM.weighted_f1(y_true, y_pred) == pytest.approx(f1_score(y_true, y_pred, average="weighted"),
                                                           rel=1e-12, abs=1e-12)
    assert TM.multiclass_ovr_auc(y, probs) == pytest.approx(roc_auc_score(y, probs, multi_class="ovr"), rel=1e-12)
    for c in range(4):
        assert TM.binary_auc(y == c, probs[:, c]) == pytest.approx(roc_auc_score(y == c, probs[:, c]), rel=1e-12)
    two = np.where(y > 1, 7, 3)  # the greater label is the positive one
    assert TM.binary_auc(two, probs[:, 0]) == pytest.approx(roc_auc_score(two, probs[:, 0]), rel=1e-12)
    # one class present: ValueError here (the JAX evaluator then reports None); scikit-learn raises the
    # same or, in its newer releases, warns and returns NaN
    with pytest.raises(ValueError):
        TM.binary_auc(np.zeros(60, int), probs[:, 0])
    try:
        assert np.isnan(roc_auc_score(np.zeros(60, int), probs[:, 0]))
    except ValueError:
        pass
    for bad_y, bad_p in ((np.where(y == 3, 0, y), probs), (y, probs * 2)):
        with pytest.raises(ValueError):
            TM.multiclass_ovr_auc(bad_y, bad_p)
        with pytest.raises(ValueError):
            roc_auc_score(bad_y, bad_p, multi_class="ovr")
