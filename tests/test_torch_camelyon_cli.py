"""The fine-tune and consistency CLIs with ``--task camelyon16`` on the CPU
(``--device cpu``, float32, 32^2) against the JAX package's data path: the
step inputs are the JAX package's balanced batches for the same seeds, the
steps per epoch and LR milestones are the ones the JAX CLIs count, each
fine-tune step takes 16 tumor-pool and 16 normal-pool images, and the final
checkpoint loads into the JAX package, whose forward agrees with the
port's within 1e-5 (float32 logits).  Patch trees are written through
tests/camelyon_fixtures.py; weights are the port's, seeded."""

import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from camelyon_fixtures import class_entries, write_annotation_jsons, write_patch_dir
from ssl_cr_histo_tpu.cli import common as JC
from ssl_cr_histo_tpu.cli import finetune as jfinetune
from ssl_cr_histo_tpu.data import datasets as JD
from ssl_cr_histo_tpu.data import pipeline as JP
from ssl_cr_histo_tpu.models import FinetuneHead as JFinetuneHead
from ssl_cr_histo_tpu.models import TripletNet as JTripletNet
from ssl_cr_histo_tpu.parallel import steps as JS
from ssl_cr_histo_tpu.train.checkpoint import load_torch_linear_head, load_torch_triplet_checkpoint
from ssl_cr_histo_tpu.train.state import TrainState as JTrainState
from ssl_cr_histo_tpu_torch.cli import common as TC
from ssl_cr_histo_tpu_torch.cli import consistency, finetune
from ssl_cr_histo_tpu_torch.parallel import steps as TS
from ssl_cr_histo_tpu_torch.train.checkpoint import save_checkpoint
from ssl_cr_histo_tpu_torch.train.init import init_finetune_state, init_triplet_state


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


SIZE = 32


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Train dirs (tumor: 34 patches, 30 in the origin polygon; normal: 36)
    and VALID dirs (6 + 6), all on fine-tune slides; tumor-dir patches are
    bright and normal-dir ones dark, so a batch's pools can be counted."""
    root = tmp_path_factory.mktemp("cam_cli")
    jsons = write_annotation_jsons(root / "jsons", pids=("Tumor_026", "Normal_040", "Tumor_030", "Normal_050"))
    tumor = write_patch_dir(root / "tumor", class_entries("Tumor_026", 50, 30, seed=1)
                            + class_entries("Tumor_026", 500, 4, seed=2))
    normal = write_patch_dir(root / "normal", class_entries("Normal_040", 500, 36, seed=3))
    vt = write_patch_dir(root / "tumor_valid", class_entries("Tumor_030", 50, 6, seed=4))
    vn = write_patch_dir(root / "normal_valid", class_entries("Normal_050", 500, 6, seed=5))
    return {"train": f"{tumor},{normal}", "val": f"{vt},{vn}", "json": str(jsons), "root": root}


def _bright(imgs) -> int:
    """How many images of a batch come from the tumor dir (bright)."""
    return int((np.asarray(imgs, np.float64).reshape(len(imgs), -1).mean(1) > 128).sum())


def _record(monkeypatch, name):
    """Wrap parallel.steps.<name> to keep each call's arguments on the host."""
    calls, real = [], getattr(TS, name)

    def wrapped(*a, **kw):
        calls.append([x.numpy().copy() if isinstance(x, torch.Tensor) else x for x in a])
        return real(*a, **kw)

    monkeypatch.setattr(TS, name, wrapped)
    return calls


def _jax_logits_agree(path, state, num_classes=2):
    """The checkpoint read by the JAX package gives the port's eval logits
    within 1e-5 (float32 both sides)."""
    mparams, mstats = load_torch_triplet_checkpoint(path)
    head = load_torch_linear_head(path, "classifier")
    jstate = JTrainState(params={"model": mparams, "head": head}, batch_stats=mstats, opt_state=(),
                         step=jnp.zeros([], jnp.int32))
    x = np.random.default_rng(9).integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)
    want = np.asarray(JS.make_forward_fn(JTripletNet("resnet18"), JFinetuneHead(num_classes))(jstate, jnp.asarray(x)))
    got = TS.forward(state, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_finetune_cli_camelyon16(tree, monkeypatch, tmp_path):
    """Two epochs at 32^2, batch 16 a pool, from a port pretrain
    checkpoint: each step's 32 rows are 16 from each pool and equal the
    JAX package's balanced_batch_iterator batch for seed + epoch; steps per
    epoch (2) and the LR milestones ([60, 120] steps) are those the JAX CLI
    counts from the same data; validation reads the VALID dirs; the final
    checkpoint loads in the JAX package with equal logits."""
    calls = _record(monkeypatch, "finetune_step")
    torch.manual_seed(3)
    pre_path = str(tmp_path / "pre" / "ckpt_1.pth")
    save_checkpoint(pre_path, init_triplet_state("resnet18", torch.device("cpu")), {"epoch": 1})
    run = tmp_path / "ft"
    state = finetune.main(["--task", "camelyon16", "--train_path", tree["train"], "--json_path", tree["json"],
                           "--val_path", tree["val"], "--model_path", pre_path, "--save_dir", str(run),
                           "--device", "cpu", "--image_size", str(SIZE), "--num_epoch", "2", "--save_freq", "0",
                           "--no-bf16"])
    jtrain = JD.load_camelyon16_patches(tree["train"], tree["json"], SIZE)
    n_steps = JC.balanced_epoch_len(JD.grouping_key(jtrain), 16, clamp=False)
    assert n_steps == 2 and len(calls) == 2 * n_steps
    want = [b for epoch in (1, 2) for b in JP.balanced_batch_iterator(jtrain, 16, seed=42 + epoch)]
    for (_, imgs, labels, *_), (wi, wl) in zip(calls, want, strict=True):
        assert imgs.shape == (32, SIZE, SIZE, 3) and _bright(imgs) == 16
        np.testing.assert_array_equal(imgs, wi)
        np.testing.assert_array_equal(labels, wl)
    final = torch.load(run / "final.pth", weights_only=False)
    assert final["step"] == 4
    assert sorted(final["scheduler"]["milestones"]) == [m * n_steps for m in JC.TASKS["camelyon16"].milestones]
    assert state.optimizer.param_groups[0]["nesterov"] and state.optimizer.param_groups[0]["lr"] == 5e-4
    rows = (run / "fine_tuned_results.csv").read_text().splitlines()
    assert len(rows) == 3 and all(0 <= float(r.split(",")[2]) <= 1 for r in rows[1:])
    _jax_logits_agree(str(run / "final.pth"), state)


def test_finetune_cli_camelyon16_labeled_fraction_and_guard(tree, tmp_path):
    """--labeled_train draws each pool apart as the JAX CLI's
    subsample_labeled does; steps per epoch equal the JAX count; too large
    a batch for the pools exits before any step."""
    args = SimpleNamespace(labeled_train=0.5, with_replacement=False, seed=42)
    cfg = TC.TASKS["camelyon16"]
    for per_pool in (4, 8):
        train = finetune.load_task_dataset(TC.apply_task_overrides(SimpleNamespace(image_size=SIZE), cfg),
                                           tree["train"], tree["json"])
        jtrain = JD.load_camelyon16_patches(tree["train"], tree["json"], SIZE)
        got = finetune.subsample_labeled(train, args, cfg)
        want = jfinetune.subsample_labeled(jtrain, args, JC.TASKS["camelyon16"])
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.groups, want.groups)
        assert finetune.steps_per_epoch(cfg, got, per_pool) == JC.balanced_epoch_len(
            JD.grouping_key(want), per_pool, clamp=False)
    with pytest.raises(SystemExit, match="zero steps per epoch"):
        finetune.main(["--task", "camelyon16", "--train_path", tree["train"], "--json_path", tree["json"],
                       "--val_path", tree["val"], "--save_dir", str(tmp_path), "--device", "cpu",
                       "--image_size", str(SIZE), "--batch_size", "40"])


def test_consistency_cli_camelyon16(tree, monkeypatch, tmp_path):
    """One epoch at 32^2, batch 2 a pool, mu 2, from a port fine-tune
    checkpoint with a 2-way head: the labeled batches are the JAX package's
    balanced batches of its per-pool labeled subsample (seed + epoch), the
    unlabeled ones its balanced batches of the whole train split (1000 +
    seed + epoch), each half from each pool; the epoch is the smaller of
    the two balanced counts; the milestones count it; the checkpoint loads
    in the JAX package with equal logits."""
    calls = _record(monkeypatch, "consistency_step")
    torch.manual_seed(5)
    ft_state = init_finetune_state("resnet18", 2, torch.device("cpu"), lambda ps: TC.make_optimizer("sgd", ps, 5e-4))
    ft = str(tmp_path / "ft" / "best.pth")
    save_checkpoint(ft, ft_state, {"epoch": 1})
    run = tmp_path / "cr"
    state = consistency.main(["--task", "camelyon16", "--train_path", tree["train"], "--json_path", tree["json"],
                              "--val_path", tree["val"], "--finetune_ckpt", ft, "--save_dir", str(run),
                              "--device", "cpu", "--image_size", str(SIZE), "--batch_size", "2", "--mu", "2",
                              "--labeled_train", "0.25", "--num_epoch", "1", "--save_freq", "0", "--no-bf16"])
    jtrain = JD.load_camelyon16_patches(tree["train"], tree["json"], SIZE)
    jlabeled = jfinetune.subsample_labeled(
        jtrain, SimpleNamespace(labeled_train=0.25, with_replacement=False, seed=42), JC.TASKS["camelyon16"])
    n_lab = JC.balanced_epoch_len(JD.grouping_key(jlabeled), 2, clamp=False)
    n_unl = JC.balanced_epoch_len(JD.grouping_key(jtrain), 4, clamp=False)
    assert (n_lab, n_unl) == (4, 8) and len(calls) == min(n_lab, n_unl)
    lab = JP.balanced_batch_iterator(jlabeled, 2, seed=43)
    unl = JP.balanced_batch_iterator(jtrain, 4, seed=1043)
    for (_, _, x_l, y_l, x_u, *_), (wl, wy), (wu, _) in zip(calls, lab, unl):
        assert x_l.shape[0] == 4 and x_u.shape[0] == 8 and _bright(x_l) == 2 and _bright(x_u) == 4
        np.testing.assert_array_equal(x_l, wl)
        np.testing.assert_array_equal(y_l, wy)
        np.testing.assert_array_equal(x_u, wu)
    final = torch.load(run / "final.pth", weights_only=False)
    assert final["step"] == 4 and sorted(final["scheduler"]["milestones"]) == [120, 240]
    assert final["classifier"]["classifier.0.weight"].shape == (2, 768)
    _jax_logits_agree(str(run / "final.pth"), state)
