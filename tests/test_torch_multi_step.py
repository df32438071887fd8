"""``--multi_step K`` in the port on the CPU: K train steps a chunk.

``data.pipeline.chunk_batches`` against the JAX package's; each of the
pretrain, fine-tune and consistency steps (with and without ``--ema``) run
by ``parallel.steps.StepGraph`` at K = 3 over 7 steps (chunks of 3, 3 and
a partial 1) against 7 calls of the single step, bit for bit, both as the
CPU runs it (the eager step K times) and split as the card's graph splits
it (eager prologue, device body, host epilogue; the body runs eagerly
here); the pretrain runner against the JAX package's
``make_pretrain_multi_step`` in float64; each stage CLI at ``--multi_step
3`` against ``--multi_step 1`` (bit-equal checkpoints that the JAX package
loads); and every port CLI's flags against its JAX CLI's.  Tiny sizes:
32^2-64^2 images, batches of 2 to 4.  The card's replays against eager
steps are in tests/test_torch_cuda_kernels.py.
"""

import argparse
import importlib
import os
import pkgutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssl_cr_histo_tpu.data import pipeline as JP
from ssl_cr_histo_tpu.models import Classifier as JClassifier
from ssl_cr_histo_tpu.models import TripletNet as JTripletNet
from ssl_cr_histo_tpu.parallel import steps as JS
from ssl_cr_histo_tpu.train import optim as joptim
from ssl_cr_histo_tpu.train.checkpoint import load_torch_linear_head, load_torch_triplet_checkpoint
from ssl_cr_histo_tpu.train.init import init_triplet_state as j_init_state
from ssl_cr_histo_tpu_torch.cli import common as TC
from ssl_cr_histo_tpu_torch.cli import consistency, finetune, pretrain
from ssl_cr_histo_tpu_torch.cli.common import TASKS, make_optimizer
from ssl_cr_histo_tpu_torch.data import pipeline as TP
from ssl_cr_histo_tpu_torch.parallel import steps as TS
from ssl_cr_histo_tpu_torch.train.checkpoint import from_jax_params, save_checkpoint
from ssl_cr_histo_tpu_torch.train.init import init_finetune_state, init_teacher, init_triplet_state
from torch_tmp import release, tmp_path  # noqa: F401  (a fixture)

CPU = torch.device("cpu")
K, STEPS = 3, 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the file's torch work (restored after): at
    these sizes more threads buy nothing and contend with the other test
    workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b, where=""):
    """Bit-equality of two checkpoint trees (tensors, dicts, lists, scalars)."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), (where, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def _same_ckpt(path_a, path_b):
    """Two checkpoint files bit-equal, apart from the meta's record of the
    command line (which holds --multi_step)."""
    a, b = (torch.load(p, weights_only=False) for p in (path_a, path_b))
    for m in (a["meta"], b["meta"]):
        assert m.pop("args")["multi_step"] in (1, K)
    _same(a, b, os.path.basename(str(path_a)))


# --- chunk_batches ------------------------------------------------------------


@pytest.mark.parametrize("n,tupled", [(6, False), (7, False), (6, True), (8, True)],
                         ids=["full", "partial", "full-tuples", "partial-tuples"])
def test_chunk_batches_matches_jax(n, tupled):
    """The same numpy batches chunked by the port and by the JAX package:
    the same stacked arrays (dtype and shape too) and valid masks, full
    chunks and a zero-padded partial last one."""
    rng = np.random.default_rng(n)
    batches = [rng.integers(0, 256, (4, 5, 5, 3), dtype=np.uint8) for _ in range(n)]
    if tupled:
        batches = [(b, rng.integers(0, 9, 4)) for b in batches]
    got, want = list(TP.chunk_batches(iter(batches), K)), list(JP.chunk_batches(iter(batches), K))
    assert len(got) == len(want) == -(-n // K)
    for (g, gv), (w, wv) in zip(got, want, strict=True):
        np.testing.assert_array_equal(gv, wv)
        assert gv.dtype == wv.dtype == np.float32
        for ga, wa in zip(g if tupled else (g,), w if tupled else (w,), strict=True):
            assert ga.dtype == wa.dtype and ga.shape == wa.shape
            np.testing.assert_array_equal(ga, wa)
    assert got[-1][1].sum() == n - K * (len(got) - 1)


def test_chunked_feed_yields_each_batch_once_in_order():
    """The CLIs' feed: zipped iterators' batches stacked K a chunk, the
    last chunk partial with zero rows, and K = 1 one batch a chunk."""
    rng = np.random.default_rng(0)
    a = [(rng.integers(0, 9, (2, 3)), rng.integers(0, 9, 2)) for _ in range(STEPS)]
    b = [(rng.integers(0, 9, (4, 3)),) for _ in range(STEPS)]
    for k in (1, K):
        chunks = list(TC.chunked_feed(CPU, k, iter(a), iter(b)))
        assert [n for _, n in chunks] == ([1] * STEPS if k == 1 else [3, 3, 1])
        rows = [tuple(t[i].numpy() for t in chunk) for chunk, n in chunks for i in range(n)]
        for got, (x, y), (u,) in zip(rows, a, b, strict=True):
            for g, w in zip(got, (x, y, u), strict=True):
                np.testing.assert_array_equal(g, w)
        if k == K:
            assert all(not t[1:].any() for t in chunks[-1][0])
    with pytest.raises(ValueError, match="--multi_step 0"):
        next(TC.chunked_feed(CPU, 0, iter(a)))


# --- the runners against the single steps -----------------------------------


SIZE = 32


def _chunks(rows):
    """``rows`` (one tuple of tensors a step) as chunks of K stacked rows
    and their valid counts, the last chunk zero-padded."""
    out = []
    for i in range(0, len(rows), K):
        part = rows[i:i + K]
        out.append((tuple(torch.cat([torch.stack(col), torch.zeros_like(torch.stack(col))[:K - len(part)]])
                          for col in zip(*part)), len(part)))
    return out


def _split(runner):
    """``runner`` as the card runs it, its body called eagerly instead of
    replayed: the first step eager, then prologue, body and epilogue."""
    runner.graphed = True
    runner._replay = lambda inputs: runner.body(*inputs)
    return runner


def _pretrain_setup(seed=0):
    torch.manual_seed(seed)
    state = init_triplet_state("resnet18", CPU, lr=0.01, weight_decay=1e-4)
    rng = np.random.default_rng(seed)
    rows = [(torch.from_numpy(rng.integers(0, 256, (2, 3, SIZE, SIZE, 3), dtype=np.uint8)),)
            for _ in range(STEPS)]
    return state, rows


def _finetune_setup(opt="adam", seed=0):
    torch.manual_seed(seed)
    state = init_finetune_state("resnet18", 3, CPU, lambda ps: make_optimizer(opt, ps, 1e-3),
                                milestones_steps=[2, 5])
    rng = np.random.default_rng(seed)
    rows = [(torch.from_numpy(rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)),
             torch.from_numpy(rng.integers(0, 3, 2))) for _ in range(STEPS)]
    return state, rows


def _state_tree(state, teacher=None):
    tree = {"state": state.payload()}
    if teacher is not None:
        tree["teacher"] = teacher.payload()
    return tree


def _run_chunks(runner, rows):
    metrics = []
    for chunk, n in _chunks(rows):
        ms = runner.run(chunk, n)
        assert all(not v[n:].any() for v in ms.values())
        metrics += [{k: v[i].clone() for k, v in ms.items()} for i in range(n)]
    return metrics


@pytest.mark.parametrize("split", [False, True], ids=["eager", "split"])
@pytest.mark.parametrize("aug", [("v1", "fused"), ("v2", "masked"), (None, "fused")], ids=["v1", "v2", "none"])
def test_pretrain_runner_equals_single_steps(aug, split):
    """make_pretrain_multi_step at K = 3 over 7 steps against 7
    pretrain_step calls on the same tiles and generators: the metrics, the
    state (weights, BN statistics, momentum, step) and both generators'
    states bit for bit; v1's kernel path and no augmentation as
    whole-step graphs, v2 with its views in the prologue."""
    kw = dict(augment=aug[0], aug_mode=aug[1], return_feats=True, bf16=False)
    runs = []
    for multi in (False, True):
        state, rows = _pretrain_setup()
        gen, host_gen = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
        if multi:
            runner = TS.make_pretrain_multi_step(state, gen, K, host_gen=host_gen, **kw)
            metrics = _run_chunks(_split(runner) if split else runner, rows)
        else:
            metrics = [TS.pretrain_step(state, row[0], gen, host_gen=host_gen, **kw) for row in rows]
        runs.append((metrics, _state_tree(state), gen.get_state(), host_gen.get_state()))
    _same(runs[0], runs[1])
    assert runs[1][1]["state"]["step"] == STEPS


def test_pretrain_runner_takes_the_chunks_labels():
    """Labels the chunk carries (--expand_orderings) reach each step as
    they are: the features' labels echo them, equal to the single steps'."""
    state, rows = _pretrain_setup()
    rng = np.random.default_rng(3)
    rows = [(t, torch.from_numpy(rng.integers(0, 6, 2))) for (t,) in rows]
    runner = _split(TS.make_pretrain_multi_step(state, torch.Generator().manual_seed(1), K, augment=None,
                                                return_feats=True))
    metrics = _run_chunks(runner, rows)
    for m, (_, labels) in zip(metrics, rows, strict=True):
        assert torch.equal(m["labels"], labels)


@pytest.mark.parametrize("split", [False, True], ids=["eager", "split"])
@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_finetune_runner_equals_single_steps(opt, split):
    """make_finetune_multi_step at K = 3 over 7 steps against 7
    finetune_step calls: metrics, weights, the optimizer (Adam's moments and
    step counts, or SGD's momentum), the MultiStep schedule past both of
    its milestones (steps 2 and 5) and the generator, bit for bit."""
    runs = []
    for multi in (False, True):
        state, rows = _finetune_setup(opt)
        gen = torch.Generator().manual_seed(1)
        if multi:
            runner = TS.make_finetune_multi_step(state, gen, K)
            metrics = _run_chunks(_split(runner) if split else runner, rows)
        else:
            metrics = [TS.finetune_step(state, x, y, gen) for x, y in rows]
        runs.append((metrics, _state_tree(state), gen.get_state()))
    _same(runs[0], runs[1])
    assert runs[1][1]["state"]["scheduler"]["last_epoch"] == STEPS


@pytest.mark.parametrize("split", [False, True], ids=["eager", "split"])
@pytest.mark.parametrize("ema", [0.0, 0.9], ids=["refresh", "ema"])
def test_consistency_runner_equals_single_steps(ema, split):
    """make_consistency_multi_step at K = 3 over 7 steps against 7
    consistency_step calls, each followed by ema_update under --ema:
    metrics, the student, the optimizer, the schedule, the teacher (moved
    by the EMA, or untouched between refreshes) and both generators, bit
    for bit; the strong views in the prologue, the rest the body."""
    runs = []
    for multi in (False, True):
        state, rows = _finetune_setup("adam", seed=1)
        teacher = init_teacher(state)
        rng = np.random.default_rng(4)
        rows = [(x, y, torch.from_numpy(rng.integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)))
                for x, y in rows]
        gen, host_gen = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
        kw = dict(n_aug=2, host_gen=host_gen, aug_mode="masked")
        if multi:
            runner = TS.make_consistency_multi_step(state, teacher, gen, K, ema=ema, **kw)
            metrics = _run_chunks(_split(runner) if split else runner, rows)
        else:
            metrics = []
            for x_l, y_l, x_u in rows:
                metrics.append(TS.consistency_step(state, teacher, x_l, y_l, x_u, gen, **kw))
                if ema:
                    TS.ema_update(teacher, state, ema)
        runs.append((metrics, _state_tree(state, teacher), gen.get_state(), host_gen.get_state()))
    _same(runs[0], runs[1])
    moved = not torch.equal(runs[1][1]["teacher"]["classifier"]["classifier.0.weight"],
                            init_teacher(_finetune_setup("adam", seed=1)[0]).head.state_dict()["classifier.0.weight"])
    assert moved == (ema > 0)


def test_runner_refuses_no_steps_a_chunk():
    state, _ = _pretrain_setup()
    with pytest.raises(ValueError, match="--multi_step 0"):
        TS.make_pretrain_multi_step(state, torch.Generator(), 0)


# --- the pretrain runner against the JAX package's multi step ----------------


IMG, B = 64, 2


def test_pretrain_multi_step_matches_jax_in_float64():
    """JAX's make_pretrain_multi_step(augment=None, donate=False,
    joint_encode=True) with explicit labels, K = 3 steps of one chunk,
    against the port's runner on the same weights (carried over by
    from_jax_params), both in float64: each step's loss rtol 1e-5, the
    weights after the chunk rtol 1e-5 / atol 1e-6, the BN running means
    rtol 1e-4 / atol 1e-6 (tests/test_torch_pretrain_step.py's float64
    step tolerances).  The running variances are left out: flax keeps the
    biased batch variance, torch the unbiased one, and over K steps that
    difference compounds (test_pretrain_step_matches_jax holds one step's
    with the factor removed)."""
    jm, jc = JTripletNet("resnet18", dtype=jnp.float64), JClassifier(num_classes=6, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    tiles = rng.integers(0, 256, (K, B, 3, IMG, IMG, 3), dtype=np.uint8)
    labels = rng.integers(0, 6, (K, B)).astype(np.int32)
    with jax.enable_x64():
        tx = joptim.sgd_nesterov(0.01, momentum=0.9, weight_decay=1e-4)
        jstate = j_init_state(JTripletNet("resnet18"), JClassifier(num_classes=6), tx, jax.random.PRNGKey(0),
                              image_size=IMG)
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        params, stats = f64(jstate.params), f64(jstate.batch_stats)
        jstate = jstate.replace(params=params, batch_stats=stats, opt_state=tx.init(params))
        multi = JS.make_pretrain_multi_step(jm, jc, tx, augment=None, donate=False, joint_encode=True)
        jout, jms = jax.device_get(multi(jstate, jnp.asarray(tiles), jax.random.PRNGKey(1), jnp.ones(K),
                                         jnp.asarray(labels)))
    sd, head_sd = from_jax_params(jax.device_get(params["model"]), jax.device_get(stats),
                                  jax.device_get(params["head"]))
    state = init_triplet_state("resnet18", CPU, lr=0.01, weight_decay=1e-4)
    state.model.load_state_dict(sd)
    state.classifier.load_state_dict(head_sd)
    state.model.double()
    state.classifier.double()
    joint = state.model.forward_joint
    state.model.forward_joint = lambda t: joint(t.double())  # the JAX model casts its float32 input too
    runner = TS.make_pretrain_multi_step(state, torch.Generator(), K, augment=None)
    ms = runner.run((torch.from_numpy(tiles), torch.from_numpy(labels)), K)
    np.testing.assert_allclose(ms["loss"].numpy(), np.asarray(jms["loss"]), rtol=1e-5)
    want_sd, want_head = from_jax_params(jout.params["model"], jout.batch_stats, jout.params["head"])
    got_sd = state.model.state_dict()
    for k, v in want_sd.items():
        if k.endswith("running_var") or k.endswith("num_batches_tracked"):
            continue
        tol = dict(rtol=1e-4, atol=1e-6) if k.endswith("running_mean") else dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_sd[k].numpy(), np.asarray(v, np.float64), err_msg=k, **tol)
    for k, v in want_head.items():
        np.testing.assert_allclose(state.classifier.state_dict()[k].numpy(), np.asarray(v, np.float64), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# --- the three CLIs at --multi_step 3 against 1 ----------------------------------


def _write_slides(d):
    """Two slides whose tissue passes the v1 foreground test."""
    rng = np.random.default_rng(0)
    os.makedirs(d)
    for i in range(2):
        level0 = np.full((1536, 1536, 3), 245, np.uint8)
        tissue = np.stack([np.full((1024, 1024), c) for c in (190, 80, 160)], axis=-1)
        level0[64:1088, 64:1088] = np.clip(tissue + rng.integers(-20, 20, tissue.shape), 0, 255)
        np.save(os.path.join(d, f"slide{i}.npy"), level0)


def _write_kather(root, n_per_class=8, size=SIZE):
    import cv2

    rng = np.random.default_rng(0)
    for c, cls in enumerate(("ADI", "LYM", "TUM")):
        d = os.path.join(root, cls)
        os.makedirs(d)
        for i in range(n_per_class):
            img = np.clip(30 + 70 * c + rng.integers(0, 40, (size, size, 3)), 0, 255).astype(np.uint8)
            cv2.imwrite(os.path.join(d, f"p{i}.png"), img)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("multi_step")
    slides, kather = str(root / "wsis"), str(root / "kather")
    _write_slides(slides)
    _write_kather(kather)
    torch.manual_seed(5)
    state = init_finetune_state("resnet18", TASKS["kather"].num_classes, CPU,
                                lambda ps: make_optimizer("adam", ps, 1e-5))
    ft = str(root / "ft" / "best.pth")
    save_checkpoint(ft, state, {"epoch": 1})
    yield slides, kather, ft
    release(root)


def _loads_in_jax(path, head: bool):
    """The JAX package reads the checkpoint: its backbone (and the head)."""
    mparams, mstats = load_torch_triplet_checkpoint(path)
    ck = torch.load(path, weights_only=False)
    np.testing.assert_array_equal(np.asarray(mparams["backbone"]["conv1"]["kernel"]).transpose(3, 2, 0, 1),
                                  ck["model"]["model.conv1.weight"].numpy())
    if head:
        assert load_torch_linear_head(path, "classifier")["fc"]["kernel"].shape[1] == TASKS["kather"].num_classes


def test_pretrain_cli_multi_step_equals_one(data, tmp_path):
    """The pretrain CLI, 4 steps (a chunk of 3 and a partial one) at
    --multi_step 3 against 1: ckpt_1.pth bit-equal (weights, momentum,
    Lookahead, step, generators, best value), the same CSV, and the JAX
    package loads it."""
    slides = data[0]
    for k in (1, K):
        pretrain.main(["--train_image_pth", slides, "--save_dir", str(tmp_path / str(k)), "--device", "cpu",
                       "--tile_h", "32", "--tile_w", "32", "--tile_stride", "64", "--batch_size", "2",
                       "--steps_per_epoch", "4", "--validation_size", "2", "--num_epoch", "1", "--save_freq", "1",
                       "--index_cache_dir", "", "--no-bf16", "--multi_step", str(k)])
    _same_ckpt(tmp_path / "1" / "ckpt_1.pth", tmp_path / str(K) / "ckpt_1.pth")
    assert torch.load(tmp_path / "1" / "ckpt_1.pth", weights_only=False)["step"] == 4
    assert (tmp_path / "1" / "train_results.csv").read_text() == (tmp_path / str(K) / "train_results.csv").read_text()
    _loads_in_jax(str(tmp_path / str(K) / "ckpt_1.pth"), head=False)


def test_finetune_cli_multi_step_equals_one(data, tmp_path):
    """The fine-tune CLI (Kather, Adam), 4 steps an epoch at --multi_step 3
    against 1: ckpt_1.pth bit-equal (Adam's moments and step counts, the
    schedule), and the JAX package loads it."""
    _, kather, _ = data
    for k in (1, K):
        finetune.main(["--task", "kather", "--train_path", kather, "--save_dir", str(tmp_path / str(k)),
                       "--device", "cpu", "--image_size", str(SIZE), "--batch_size", "4", "--num_epoch", "1",
                       "--save_freq", "1", "--modules", "45", "--lr", "1e-3", "--validation_split", "0.25",
                       "--no-bf16", "--multi_step", str(k)])
    _same_ckpt(tmp_path / "1" / "ckpt_1.pth", tmp_path / str(K) / "ckpt_1.pth")
    assert torch.load(tmp_path / "1" / "ckpt_1.pth", weights_only=False)["step"] == 4
    _loads_in_jax(str(tmp_path / str(K) / "ckpt_1.pth"), head=True)


@pytest.mark.parametrize("ema", ["0", "0.5"], ids=["refresh", "ema"])
def test_consistency_cli_multi_step_equals_one(data, tmp_path, ema):
    """The consistency CLI (Kather), 4 steps an epoch at --multi_step 3
    against 1: ckpt_1.pth bit-equal, and under --ema teacher_ckpt_1.pth
    too; the JAX package loads both."""
    _, kather, ft = data
    for k in (1, K):
        consistency.main(["--task", "kather", "--train_path", kather, "--finetune_ckpt", ft,
                          "--save_dir", str(tmp_path / str(k)), "--device", "cpu", "--image_size", str(SIZE),
                          "--batch_size", "2", "--mu", "2", "--NAug", "2", "--labeled_train", "0.5",
                          "--modules_student", "45", "--lr", "1e-3", "--num_epoch", "1", "--save_freq", "1",
                          "--ema", ema, "--validation_split", "0.25", "--no-bf16", "--multi_step", str(k)])
    _same_ckpt(tmp_path / "1" / "ckpt_1.pth", tmp_path / str(K) / "ckpt_1.pth")
    assert torch.load(tmp_path / "1" / "ckpt_1.pth", weights_only=False)["step"] == 4
    _loads_in_jax(str(tmp_path / str(K) / "ckpt_1.pth"), head=True)
    if ema != "0":
        a, b = (torch.load(tmp_path / d / "teacher_ckpt_1.pth", weights_only=False) for d in ("1", str(K)))
        _same(a["model"], b["model"])
        _same(a["classifier"], b["classifier"])
        _loads_in_jax(str(tmp_path / str(K) / "teacher_ckpt_1.pth"), head=True)


# --- the flags ----------------------------------------------------------------


class _Parsed(Exception):
    pass


def _flags(module, monkeypatch) -> dict:
    """The option strings of the parser ``module`` builds, with their
    defaults: ``parse_args`` stops the module at its parse."""
    def stop(self, *a, **kw):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as parsed:
        (module.parse_args if hasattr(module, "parse_args") else module.main)([])
    monkeypatch.undo()
    return {opt: a.default for a in parsed.value.args[0]._actions for opt in a.option_strings}


def _cli_modules(package: str) -> set:
    pkg = importlib.import_module(package)
    return {m.name for m in pkgutil.iter_modules(pkg.__path__) if m.name not in ("__init__", "common")}


# A JAX flag the port leaves out, with its reason: the device picks the
# photometric path (the CUDA kernel on a card, the plain chain on the CPU)
NOT_PORTED_FLAGS = {"--photometric"}
# Every JAX CLI has its port
NOT_PORTED_CLIS = set()


@pytest.mark.parametrize("name", sorted(_cli_modules("ssl_cr_histo_tpu.cli") - NOT_PORTED_CLIS))
def test_cli_flags_match_jax(name, monkeypatch):
    """Every flag of each JAX CLI is a flag of the port's CLI of the same
    name, but --photometric; every JAX CLI has a port of the same name;
    --multi_step defaults to 8 in both where JAX has it."""
    assert _cli_modules("ssl_cr_histo_tpu.cli") - _cli_modules("ssl_cr_histo_tpu_torch.cli") == NOT_PORTED_CLIS
    want = _flags(importlib.import_module(f"ssl_cr_histo_tpu.cli.{name}"), monkeypatch)
    got = _flags(importlib.import_module(f"ssl_cr_histo_tpu_torch.cli.{name}"), monkeypatch)
    assert set(want) - set(got) - {"-h", "--help"} == (NOT_PORTED_FLAGS & set(want))
    if "--multi_step" in want:
        assert want["--multi_step"] == got["--multi_step"] == 8


@pytest.mark.parametrize("cli", [pretrain, finetune, consistency], ids=["pretrain", "finetune", "consistency"])
def test_parsers_take_multi_step(cli):
    """The three stage parsers take --multi_step, 8 by default, and
    --reference_exact leaves it alone (``common.py:184``)."""
    base = ["--train_image_pth", "x"] if cli is pretrain else ["--task", "kather"]
    assert cli.parse_args(base).multi_step == 8
    args = TC.apply_reference_exact(cli.parse_args(base + ["--multi_step", "2", "--reference_exact"]),
                                    cli.__name__.rsplit(".", 1)[1])
    assert args.multi_step == 2 and args.bf16 is False
