"""The port's CLIs under ``python -m torch.distributed.run --standalone``
(rendezvous on a port bound to 0) on the CPU, each process one torch
thread, through ``tests/torch_dist_worker.py``'s ``cli`` mode, against the
same CLI in this process with no world: the pretrain CLI at 64^2 on one and
on two processes, ``--mode evaluation`` and the heatmap CLI on two.  Only
rank 0 writes."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ssl_cr_histo_tpu_torch.cli.common import TASKS, make_optimizer
from ssl_cr_histo_tpu_torch.train.checkpoint import save_checkpoint
from ssl_cr_histo_tpu_torch.train.init import init_finetune_state
from torch_tmp import release


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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def launch(nproc: int, out, commands: list, timeout: float = 600) -> list:
    """``commands`` ((cli, argv) pairs) in turn on ``nproc`` processes of a
    standalone launch; for each command, each rank's record."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
            os.path.join(REPO, "tests", "torch_dist_worker.py"), "cli", str(out)]
    for cli, args in commands:
        argv += ["--", cli, *args]
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.run(argv, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-6000:]
    return [[torch.load(f"{out}.{i}.{r}", weights_only=False) for r in range(nproc)] for i in range(len(commands))]


def _under(paths: list, root) -> list:
    root = os.path.realpath(root)
    return sorted(os.path.basename(p) for p in paths if os.path.realpath(p).startswith(root + os.sep))


# --- the pretrain CLI ------------------------------------------------------------


def _write_slides(d):
    """Two slides whose tissue passes the v1 LAB foreground test at 64^2
    (tests/test_torch_pretrain_step.py's)."""
    rng = np.random.default_rng(0)
    os.makedirs(d)
    for i in range(2):
        level0 = np.full((1536, 1536, 3), 245, np.uint8)
        tissue = np.stack([np.full((1024, 1024), c) for c in (190, 80, 160)], axis=-1)
        level0[64:1088, 64:1088] = np.clip(tissue + rng.integers(-20, 20, tissue.shape), 0, 255)
        np.save(os.path.join(d, f"slide{i}.npy"), level0)


@pytest.fixture(scope="module")
def pretrain_runs(tmp_path_factory):
    """One epoch of 2 steps of the pretrain CLI (64^2, batch 4, float32,
    the v1 fused pool's plain version) in this process, and under a launch
    of one and of two processes; each run's save dir and the launches'
    records."""
    from ssl_cr_histo_tpu_torch.cli import pretrain

    tmp = tmp_path_factory.mktemp("pretrain_cli")
    slides = str(tmp / "wsis")
    _write_slides(slides)
    args = ["--train_image_pth", slides, "--device", "cpu", "--tile_h", "64", "--tile_w", "64", "--tile_stride",
            "32", "--batch_size", "4", "--num_epoch", "1", "--steps_per_epoch", "2", "--validation_size", "6",
            "--save_freq", "1", "--index_cache_dir", "", "--no-bf16"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pretrain.main(args + ["--save_dir", str(tmp / "plain")])
    finally:
        torch.set_num_threads(threads)
    records = {n: launch(n, tmp / f"world{n}", [("pretrain", args + ["--save_dir", str(tmp / f"world{n}_run")])])[0]
               for n in (1, 2)}
    yield tmp, records
    release(tmp)


def _ckpt(run):
    return torch.load(os.path.join(run, "ckpt_1.pth"), weights_only=False)


def test_pretrain_cli_on_one_process_of_a_launch_is_bit_equal(pretrain_runs):
    """Under ``torch.distributed.run --nproc_per_node 1`` every collective
    is skipped: the checkpoint (weights, BN statistics, optimizer, slow
    weights, step, generators) and the CSV are the plain run's bit for bit."""
    tmp, records = pretrain_runs
    assert records[1][0]["world"] == 1
    a, b = _ckpt(tmp / "plain"), _ckpt(tmp / "world1_run")
    for part in ("model", "classifier"):
        for k, v in a[part].items():
            assert torch.equal(b[part][k], v), f"{part} {k}"
    assert all(torch.equal(x, y) for x, y in zip(a["slow"], b["slow"], strict=True))
    assert a["step"] == b["step"] == 2
    for k, st in a["optimizer"]["state"].items():
        assert torch.equal(b["optimizer"]["state"][k]["momentum_buffer"], st["momentum_buffer"]), k
    for name, g in a["generators"].items():
        assert torch.equal(b["generators"][name], g), name
    assert (tmp / "plain" / "train_results.csv").read_text() == (tmp / "world1_run" / "train_results.csv").read_text()


def test_pretrain_cli_on_two_processes_matches_one(pretrain_runs):
    """Two processes of two triplets each against one process at batch 4,
    in float32: the CSV's losses and accuracies within 1e-4 (the forward
    passes: a process normalising or drawing over its own rows misses by
    percents), BN statistics rtol 1e-4 / atol 1e-6, batch counts, step and
    generators equal (the draws are the global batch's), and each tensor's
    update over the two steps (the checkpoint less the seeded initial
    state) within 0.25 of its largest entry: a wiring check (a gradient
    summed or left per process misses it by its own size), not a precision
    one.  A float32 step at this size has gradients up to 6e-3 of their
    largest entry from the float64 step's in one process, and the two runs
    round differently (the updates of layer4's convolutions, whose
    BatchNorms see 2x2 maps, differed by up to 0.088 of their largest
    entry); the float64 steps of tests/test_torch_distributed.py hold the
    arithmetic to 1e-4 of the largest gradient."""
    from ssl_cr_histo_tpu_torch.train.init import init_triplet_state

    tmp, records = pretrain_runs
    assert records[2][0]["world"] == 2
    a, b = _ckpt(tmp / "plain"), _ckpt(tmp / "world2_run")
    torch.manual_seed(42)  # the CLI's --seed: seed_everything, then init_triplet_state
    start = init_triplet_state("resnet18", CPU)
    initial = {"model": start.model.state_dict(), "classifier": start.classifier.state_dict()}
    for part in ("model", "classifier"):
        for k, v in a[part].items():
            if k.endswith("num_batches_tracked"):
                assert torch.equal(b[part][k], v), k
            elif "running" in k:
                np.testing.assert_allclose(b[part][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
            else:
                step = v - initial[part][k]
                assert step.abs().max() > 0, k
                np.testing.assert_allclose((b[part][k] - initial[part][k]).numpy(), step.numpy(), rtol=0,
                                           atol=0.25 * step.abs().max().item(), err_msg=k)
    assert a["step"] == b["step"] == 2
    for name, g in a["generators"].items():
        assert torch.equal(b["generators"][name], g), name
    rows = [(tmp / r / "train_results.csv").read_text().splitlines() for r in ("plain", "world2_run")]
    assert rows[0][0] == rows[1][0] and len(rows[1]) == 2
    np.testing.assert_allclose([float(v) for v in rows[1][1].split(",")], [float(v) for v in rows[0][1].split(",")],
                               rtol=1e-4)


def test_pretrain_cli_writes_on_rank_0_only(pretrain_runs):
    """Of the two processes, rank 0 writes the CSV and the checkpoints
    (each through its temporary file) and rank 1 writes nothing under the
    save dir."""
    tmp, records = pretrain_runs
    run = tmp / "world2_run"
    rank0, rank1 = (_under(r["writes"], run) for r in records[2])
    assert rank1 == []
    assert set(rank0) == {"train_results.csv", "ckpt_1.pth.tmp", "best.pth.tmp"}
    assert sorted(os.listdir(run)) == ["best.pth", "ckpt_1.pth", "train_results.csv"]


# --- evaluation and serving ------------------------------------------------------


def _write_kather(root, n_per_class=6, size=32):
    from PIL import Image

    rng = np.random.default_rng(0)
    for c, cls in enumerate(("ADI", "LYM", "TUM")):
        d = os.path.join(root, cls)
        os.makedirs(d)
        for i in range(n_per_class):
            img = np.clip(30 + 70 * c + rng.integers(0, 40, (size, size, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(d, f"p{i}.png"))


def _write_slide(wsis, masks, name="tumor_001", size=512, cells=16):
    """A white slide with a noisy pink tissue block, and its tissue mask."""
    rng = np.random.default_rng(3)
    s = np.full((size, size, 3), 245, np.uint8)
    s[:, : size * 5 // 8] = np.clip(np.array([190, 80, 160]) + rng.integers(-40, 40, (size, size * 5 // 8, 3)),
                                    0, 255)
    os.makedirs(wsis)
    os.makedirs(masks)
    np.save(os.path.join(wsis, f"{name}.npy"), s)
    np.save(os.path.join(masks, f"{name}_tissue.npy"), (rng.random((cells, cells)) < 0.5).astype(np.uint8))


@pytest.fixture(scope="module")
def serving_runs(tmp_path_factory):
    """``cli.finetune --mode evaluation`` (Kather, 18 images at 32^2, eval
    batch 5: the last batch of 3 is padded to 4 on two processes) and
    ``cli.heatmap`` (batch 7: every batch padded to 8) from one port
    checkpoint, in this process and on two processes of one launch."""
    from ssl_cr_histo_tpu_torch.cli import finetune, heatmap

    tmp = tmp_path_factory.mktemp("serving")
    _write_kather(str(tmp / "kather"))
    _write_slide(str(tmp / "wsis"), str(tmp / "masks"))
    ckpts = {}
    for classes in (TASKS["kather"].num_classes, 2):
        torch.manual_seed(4)
        state = init_finetune_state("resnet18", classes, CPU, lambda ps: make_optimizer("adam", ps, 1e-4))
        with torch.no_grad():
            state.head.classifier[0].weight.mul_(50.0)
        ckpts[classes] = str(tmp / f"ft{classes}" / "best.pth")
        save_checkpoint(ckpts[classes], state, {"epoch": 1})

    def commands(tag):
        common = ["--device", "cpu", "--no-bf16", "--image_size", "32"]
        return [("finetune", ["--task", "kather", "--mode", "evaluation", "--test_path", str(tmp / "kather"),
                              "--eval_batch_size", "5", "--save_dir", str(tmp / f"eval_{tag}"), "--finetune_ckpt",
                              ckpts[9]] + common),
                ("heatmap", ["--test_image_pth", str(tmp / "wsis"), "--test_mask_pth", str(tmp / "masks"),
                             "--probs_map_path", str(tmp / f"maps_{tag}"), "--batch_size", "7", "--finetune_ckpt",
                             ckpts[2]] + common)]

    outputs = []
    predict_all = finetune.predict_all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        finetune.predict_all = lambda *a, **k: outputs.append(predict_all(*a, **k)) or outputs[-1]
        (_, eval_argv), (_, map_argv) = commands("plain")
        finetune.main(eval_argv)
        maps = heatmap.main(map_argv)
    finally:
        finetune.predict_all = predict_all
        torch.set_num_threads(threads)
    yield tmp, {"outputs": outputs, "maps": maps}, launch(2, tmp / "world2", commands("world2"))
    release(tmp)


def test_evaluation_on_two_processes_matches_one(serving_runs):
    """``--mode evaluation`` on two processes: each forwards its rows of
    every batch and both get all 18 logits, within 1e-6 of one process's
    (bit for bit on this CPU); the report is the same; rank 0 alone writes
    ``kather_eval.json`` (and the plot, where matplotlib is installed)."""
    tmp, plain, (evals, _) = serving_runs
    want = plain["outputs"][0]
    assert want.shape == (18, 9)
    for r, rec in enumerate(evals):
        assert rec["world"] == 2
        (got,) = rec["outputs"]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        written = _under(rec["writes"], tmp / "eval_world2")
        assert ("kather_eval.json" in written) if r == 0 else written == [], (r, written)
    assert np.array_equal(evals[0]["outputs"][0], want)
    assert (tmp / "eval_world2" / "kather_eval.json").read_text() == (tmp / "eval_plain" / "kather_eval.json").read_text()


def test_heatmap_on_two_processes_matches_one(serving_runs):
    """The heatmap CLI on two processes: the map is whole on both, within
    1e-6 of one process's (bit for bit on this CPU), and rank 0 alone
    writes the artifacts."""
    tmp, plain, (_, maps) = serving_runs
    want = plain["maps"]["tumor_001"]
    assert want.any()
    for r, rec in enumerate(maps):
        got = rec["maps"]["tumor_001"]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        written = _under(rec["writes"], tmp / "maps_world2")
        assert ("tumor_001.npy" in written) if r == 0 else written == [], (r, written)
    assert np.array_equal(maps[0]["maps"]["tumor_001"], want)
    np.testing.assert_array_equal(np.load(tmp / "maps_world2" / "tumor_001.npy"), want)
