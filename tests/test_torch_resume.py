"""``--resume`` for the port's three stage CLIs, and the pretrain CLI's
``--expand_orderings``, ``--cache_tiles`` and ``--tsne``, on the CPU.

A run of two epochs and a run of one epoch resumed for the second
(``--resume auto``) end in bit-equal checkpoints: weights, optimizer,
schedule, Lookahead, step, the generators' states and the best value, with
an EMA teacher too.  The pretrain flags are held against the JAX package:
the orderings its sampler yields for the same seed, and the features of the
train and eval steps.  Tiny sizes: 32^2 tiles and images, a few steps of
batch 2 to 4.
"""

import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from ssl_cr_histo_tpu.data.sampler import RSPTripletSampler as JSampler
from ssl_cr_histo_tpu.data.sampler import TripletIndex as JTripletIndex
from ssl_cr_histo_tpu.models import Classifier as JClassifier
from ssl_cr_histo_tpu.models import TripletNet as JTripletNet
from ssl_cr_histo_tpu.parallel import steps as JS
from ssl_cr_histo_tpu.train import optim as joptim
from ssl_cr_histo_tpu.train.init import init_triplet_state as j_init_state
from ssl_cr_histo_tpu_torch.cli import common as TC
from ssl_cr_histo_tpu_torch.cli import consistency, finetune, pretrain
from ssl_cr_histo_tpu_torch.cli.common import TASKS, make_optimizer
from ssl_cr_histo_tpu_torch.data import sampler as TSampler
from ssl_cr_histo_tpu_torch.ops import batch as TB
from ssl_cr_histo_tpu_torch.ops import fused as TF
from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK
from ssl_cr_histo_tpu_torch.parallel import steps as TS
from ssl_cr_histo_tpu_torch.train.checkpoint import from_jax_params, latest_checkpoint, save_checkpoint
from ssl_cr_histo_tpu_torch.train.init import init_finetune_state, init_teacher, init_triplet_state
from ssl_cr_histo_tpu_torch.train.loop import BestTracker
from torch_tmp import release, tmp_path  # noqa: F401  (a fixture)

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


def _same_ckpt(path_a, path_b, generators=("gen",)):
    """Two checkpoint files bit-equal, apart from the meta's record of the
    command line; each holds the named generators' states."""
    a, b = (torch.load(p, weights_only=False) for p in (path_a, path_b))
    assert set(a["generators"]) == set(b["generators"]) == set(generators)
    for m in (a["meta"], b["meta"]):
        m.pop("args", None)
    _same(a, b, os.path.basename(path_a))


# --- checkpoints and resume_training ------------------------------------------


def test_latest_checkpoint_orders_epochs_numerically(tmp_path):
    """'auto' picks the highest epoch as a number (ckpt_10 after ckpt_9),
    ignoring other files; none there, or no directory, gives None."""
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    for name in ("ckpt_9.pth", "ckpt_10.pth", "ckpt_2.pth", "best.pth", "final.pth", "ckpt_x.pth",
                 "teacher_ckpt_11.pth", "ckpt_12.pth.tmp"):
        (tmp_path / name).write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_10.pth")


@pytest.mark.parametrize("name,meta,want", [
    ("ckpt_3.pth", {"epoch": 3, "best_val": 0.5, "val_metric": 0.9}, 0.5),
    ("best.pth", {"epoch": 2, "best": 0.7, "val_metric": 0.7}, 0.7),
    ("final.pth", {"epoch": 4, "val_metric": 0.9}, 0.9),
])
def test_resume_training_restores_the_state_the_best_and_the_generators(tmp_path, name, meta, want):
    """resume_training on each kind of checkpoint the CLIs write: the start
    epoch is the meta's epoch + 1, the best value comes from best_val, else
    best, else val_metric; the weights, the optimizer (momentum), the step
    and the generator's state come back."""
    torch.manual_seed(0)
    saved = init_triplet_state("resnet18", CPU)
    saved.step = 7
    for p in saved.parameters():
        saved.optimizer.state[p]["momentum_buffer"] = torch.full_like(p, 0.25)
    gen = torch.Generator().manual_seed(3)
    torch.rand(5, generator=gen)
    save_checkpoint(str(tmp_path / name), saved, meta, {"gen": gen})
    torch.manual_seed(1)
    state = init_triplet_state("resnet18", CPU)
    fresh = torch.Generator().manual_seed(99)
    best = BestTracker(str(tmp_path), mode="min")
    args = type("A", (), {"resume": str(tmp_path / name), "save_dir": str(tmp_path)})
    start, path = TC.resume_training(args, state, best, {"gen": fresh})
    assert (start, path, best.best, state.step) == (meta["epoch"] + 1, str(tmp_path / name), want, 7)
    _same(state.model.state_dict(), saved.model.state_dict())
    assert all(torch.equal(state.optimizer.state[p]["momentum_buffer"], torch.full_like(p, 0.25))
               for p in state.parameters())
    assert torch.equal(torch.rand(5, generator=fresh), torch.rand(5, generator=gen))


def test_resume_training_auto_without_a_checkpoint_starts_fresh(tmp_path):
    args = type("A", (), {"resume": "auto", "save_dir": str(tmp_path)})
    assert TC.resume_training(args, None, None, {}) == (1, "")


# --- the pretrain CLI -----------------------------------------------------------


def _write_slides(d):
    """Two slides whose tissue passes the v1 foreground test."""
    rng = np.random.default_rng(0)
    os.makedirs(d)
    for i in range(2):
        level0 = np.full((1536, 1536, 3), 245, np.uint8)
        tissue = np.stack([np.full((1024, 1024), c) for c in (190, 80, 160)], axis=-1)
        level0[64:1088, 64:1088] = np.clip(tissue + rng.integers(-20, 20, tissue.shape), 0, 255)
        np.save(os.path.join(d, f"slide{i}.npy"), level0)


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume_wsis")
    d = str(root / "wsis")
    _write_slides(d)
    yield d
    release(root)


def _pretrain(slides, save_dir, *extra):
    return pretrain.main(["--train_image_pth", slides, "--save_dir", str(save_dir), "--device", "cpu",
                          "--tile_h", "32", "--tile_w", "32", "--tile_stride", "64", "--batch_size", "2",
                          "--steps_per_epoch", "2", "--validation_size", "2", "--save_freq", "1",
                          "--index_cache_dir", "", "--la_steps", "2", "--no-bf16", *extra])


def test_pretrain_resume_equals_an_uninterrupted_run(slides, tmp_path):
    """Two epochs straight against one epoch, then --resume auto for the
    second: ckpt_2.pth bit-equal (weights, SGD momentum, Lookahead's slow
    weights and count, synced at epoch 2 by --la_steps 2, the step, the
    generators, the best value) and the same CSV rows."""
    _pretrain(slides, tmp_path / "straight", "--num_epoch", "2")
    _pretrain(slides, tmp_path / "resumed", "--num_epoch", "1")
    _pretrain(slides, tmp_path / "resumed", "--num_epoch", "2", "--resume", "auto")
    _same_ckpt(tmp_path / "straight" / "ckpt_2.pth", tmp_path / "resumed" / "ckpt_2.pth", ("gen", "host_gen"))
    ck = torch.load(tmp_path / "resumed" / "ckpt_2.pth", weights_only=False)
    assert ck["la_count"] == 0 and ck["step"] == 4 and ck["meta"]["epoch"] == 2
    rows = [(tmp_path / d / "train_results.csv").read_text() for d in ("straight", "resumed")]
    assert rows[0] == rows[1] and len(rows[0].splitlines()) == 3



def test_pretrain_v2_resume_equals_an_uninterrupted_run(slides, tmp_path):
    """The same under ``--variant v2``, whose draws come from the host
    generator (the v2 pool's tables): ckpt_2.pth bit-equal, both
    generators restored."""
    for run, extra in (("straight", ["--num_epoch", "2"]), ("resumed", ["--num_epoch", "1"]),
                       ("resumed", ["--num_epoch", "2", "--resume", "auto"])):
        _pretrain(slides, tmp_path / run, "--variant", "v2", *extra)
    _same_ckpt(tmp_path / "straight" / "ckpt_2.pth", tmp_path / "resumed" / "ckpt_2.pth", ("gen", "host_gen"))

def test_pretrain_resume_keeps_a_better_best(slides, tmp_path):
    """With lr 0 the resumed epoch's validation loss equals epoch 1's: not
    better, so best.pth stays epoch 1's (``test_cli.py:662-706``)."""
    _pretrain(slides, tmp_path, "--num_epoch", "1", "--lr", "0")
    assert torch.load(tmp_path / "ckpt_1.pth", weights_only=False)["meta"]["best_val"] is not None
    _pretrain(slides, tmp_path, "--num_epoch", "2", "--lr", "0", "--resume", str(tmp_path / "ckpt_1.pth"))
    assert torch.load(tmp_path / "best.pth", weights_only=False)["meta"]["epoch"] == 1
    assert len((tmp_path / "train_results.csv").read_text().splitlines()) == 3


def test_cache_tiles_reads_each_position_once_and_changes_nothing(slides, tmp_path, monkeypatch):
    """--cache_tiles reads each triplet position once across both epochs'
    training and validation, and the run's checkpoint is bit-equal to an
    uncached run's."""
    reads = []
    real = TSampler.RSPTripletSampler.read_triplet
    monkeypatch.setattr(TSampler.RSPTripletSampler, "read_triplet",
                        lambda self, r, x, y: reads.append((id(r), x, y)) or real(self, r, x, y))
    _pretrain(slides, tmp_path / "plain", "--num_epoch", "2")
    uncached = len(reads)
    reads.clear()
    _pretrain(slides, tmp_path / "cached", "--num_epoch", "2", "--cache_tiles")
    assert len(reads) == len(set(reads)) < uncached
    _same_ckpt(tmp_path / "plain" / "ckpt_2.pth", tmp_path / "cached" / "ckpt_2.pth", ("gen", "host_gen"))


def test_expand_orderings_steps_on_the_jax_samplers_labels(slides, tmp_path, monkeypatch):
    """--expand_orderings: the steps take the tiles and ordering labels the
    JAX package's sampler yields for the same positions and seed (every
    position under each of the 6 orderings, so 6x the steps of an epoch)."""
    seen = []
    real = TS.pretrain_step
    monkeypatch.setattr(TS, "pretrain_step", lambda state, tiles, gen, labels=None, **kw: seen.append(
        (tiles.clone(), labels.clone())) or real(state, tiles, gen, labels=labels, **kw))
    _pretrain(slides, tmp_path, "--num_epoch", "1", "--steps_per_epoch", "0", "--tile_stride", "128",
              "--expand_orderings")
    args = pretrain.parse_args(["--train_image_pth", slides, "--tile_h", "32", "--tile_w", "32", "--tile_stride", "128",
                                "--validation_size", "2"])
    sampler = TSampler.RSPTripletSampler(tile=32, stride=128)
    train, _ = pretrain.split_validation(sampler.index_directory(slides, cache_dir=None), args)
    jtrain = [JTripletIndex(t.slide_path, t.coords) for t in train]
    want = list(JSampler(tile=32, stride=128).iter_batches(jtrain, 2, seed=args.seed + 1, expand_orderings=True))
    positions = sum(len(t.coords) for t in train)
    assert len(seen) == len(want) == 6 * positions // 2
    for (tiles, labels), (jt, jl) in zip(seen, want, strict=True):
        np.testing.assert_array_equal(tiles.numpy(), jt)
        np.testing.assert_array_equal(labels.numpy(), jl)


def test_tsne_writes_the_reference_artifacts(slides, tmp_path):
    """--tsne: at each new best, the train epoch's (steps x batch, 768)
    features and their orderings, and their plot; at the end tsne.png of
    the validation features under the 6 orderings, with its arrays."""
    with threadpool_limits(1):  # scikit-learn's t-SNE stalls on busy hosts with one OpenMP thread a core
        _pretrain(slides, tmp_path, "--num_epoch", "1", "--tsne")
    feats = np.load(tmp_path / "best_pre_trained_feats_1.npy")
    targets = np.load(tmp_path / "best_pre_trained_targets_1.npy")
    assert feats.shape == (4, 768) and feats.dtype == np.float32 and np.isfinite(feats).all()
    assert targets.shape == (4,) and targets.dtype == np.int32 and ((0 <= targets) & (targets < 6)).all()
    for name in ("best_tsne_feats_1.png", "tsne.png"):
        assert (tmp_path / name).stat().st_size > 0
    vt = np.load(tmp_path / "tsne_targets.npy")
    assert np.load(tmp_path / "tsne_feats.npy").shape == (12, 768)
    np.testing.assert_array_equal(np.sort(vt), np.repeat(np.arange(6), 2))


# --- the steps' features against the JAX package ------------------------------


IMG, B = 64, 2


@pytest.fixture(scope="module")
def setup():
    jm, jc = JTripletNet("resnet18"), JClassifier(num_classes=6)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    dummy = jnp.zeros((1, IMG, IMG, 3), jnp.float32)
    v = jm.init(k1, dummy, dummy, dummy, train=False)
    params = {"model": v["params"], "head": jc.init(k2, jnp.zeros((1, 768)))["params"]}
    rng = np.random.default_rng(5)
    tiles = rng.integers(0, 256, (B, 3, IMG, IMG, 3), dtype=np.uint8)
    return jm, jc, jax.device_get(params), jax.device_get(v["batch_stats"]), tiles


def _port_state(params, stats):
    sd, head_sd = from_jax_params(params["model"], stats, params["head"])
    state = init_triplet_state("resnet18", CPU)
    state.model.load_state_dict(sd)
    state.classifier.load_state_dict(head_sd)
    return state


def test_train_step_features_are_the_jax_models_on_the_callers_labels(setup):
    """pretrain_step(..., labels=, return_feats=True) returns the caller's
    labels and the features of its joint encode, which equal the flax
    TripletNet's forward_joint (train mode) on the same augmented views
    (rtol 1e-3 / atol 2e-4, the eval forwards' tolerance of
    tests/test_torch_models.py)."""
    jm, _, params, stats, tiles = setup
    labels = torch.tensor([4, 1], dtype=torch.int32)
    draws = {"geo": TF.draw_pretrain_geo_matrices(torch.Generator().manual_seed(3), B * 3, IMG),
             "params": torch.zeros(B * 3, PK.N_PARAMS), "noise": torch.zeros(B * 3, 3, IMG, IMG)}
    views = TB.normalize_batch(TB.augment_rsp_batch_v1(torch.Generator(), torch.from_numpy(tiles), draws=draws,
                                                       order=labels), channel_axis=2)
    m = TS.pretrain_step(_port_state(params, stats), torch.from_numpy(tiles), torch.Generator(), labels=labels,
                         draws=draws, return_feats=True)
    assert torch.equal(m["labels"], labels.long()) and m["feats"].shape == (B, 768)
    want, _ = jm.apply({"params": params["model"], "batch_stats": stats},
                       jnp.asarray(views.numpy().transpose(0, 1, 3, 4, 2)), train=True, mutable=["batch_stats"],
                       method=jm.forward_joint)
    np.testing.assert_allclose(m["feats"].numpy(), np.asarray(want), rtol=1e-3, atol=2e-4)


def test_eval_step_features_match_jax(setup):
    """pretrain_eval_step(..., return_feats=True)'s (6, B, 768) features
    under each ordering against the JAX package's make_pretrain_eval_step
    (..., return_feats=True), whose sums it keeps (rtol 1e-3 / atol
    2e-4)."""
    jm, jc, params, stats, tiles = setup
    jstate = j_init_state(jm, jc, joptim.sgd_nesterov(0.01), jax.random.PRNGKey(0), image_size=IMG)
    jstate = jstate.replace(params=params, batch_stats=stats)
    valid = np.array([1, 0], np.float32)
    want = JS.make_pretrain_eval_step(jm, jc, return_feats=True)(jstate, jnp.asarray(tiles), jnp.asarray(valid))
    got = TS.pretrain_eval_step(_port_state(params, stats), torch.from_numpy(tiles), torch.from_numpy(valid),
                                return_feats=True)
    assert got["feats"].shape == (6, B, 768)
    np.testing.assert_allclose(got["feats"].numpy(), np.asarray(want["feats"]), rtol=1e-3, atol=2e-4)
    assert float(got["count"]) == float(want["count"]) == 6.0


# --- the fine-tune and consistency CLIs ----------------------------------------


def _write_kather(root, n_per_class=6, size=32):
    import cv2

    rng = np.random.default_rng(0)
    for c, cls in enumerate(("ADI", "LYM", "TUM")):
        d = os.path.join(root, cls)
        os.makedirs(d)
        for i in range(n_per_class):
            img = np.clip(30 + 70 * c + rng.integers(0, 40, (size, size, 3)), 0, 255).astype(np.uint8)
            cv2.imwrite(os.path.join(d, f"p{i}.png"), img)


@pytest.fixture(scope="module")
def kather(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume_kather")
    data = str(root / "kather")
    _write_kather(data)
    cfg = TASKS["kather"]
    torch.manual_seed(5)
    state = init_finetune_state("resnet18", cfg.num_classes, CPU, lambda ps: make_optimizer("adam", ps, cfg.lr))
    ft = str(root / "ft" / "best.pth")
    save_checkpoint(ft, state, {"epoch": 1})
    yield data, ft
    release(root)


def test_finetune_resume_equals_an_uninterrupted_run(kather, tmp_path):
    """Two epochs straight against one epoch, then --resume auto: final.pth
    bit-equal (weights, Adam's moments and step counts, the MultiStep
    schedule, the step, the generator, the best value) and the same CSV."""
    data, _ = kather

    def run(save, *extra):
        finetune.main(["--task", "kather", "--train_path", data, "--save_dir", str(save), "--device", "cpu",
                       "--image_size", "32", "--batch_size", "4", "--save_freq", "1", "--modules", "45",
                       "--lr", "1e-3", "--validation_split", "0.25", "--no-bf16", *extra])

    run(tmp_path / "straight", "--num_epoch", "2")
    run(tmp_path / "resumed", "--num_epoch", "1")
    run(tmp_path / "resumed", "--num_epoch", "2", "--resume", "auto")
    _same_ckpt(tmp_path / "straight" / "final.pth", tmp_path / "resumed" / "final.pth")
    assert (tmp_path / "straight" / "fine_tuned_results.csv").read_text() == \
        (tmp_path / "resumed" / "fine_tuned_results.csv").read_text()


@pytest.mark.parametrize("ema", ["0", "0.5"], ids=["refresh", "ema"])
def test_consistency_resume_equals_an_uninterrupted_run(kather, tmp_path, ema):
    """Two epochs straight against one epoch, then --resume auto: the
    student's final.pth bit-equal with both generators (the views' device
    and host draws), and under --ema the teacher restored from
    teacher_ckpt_1.pth, so teacher_final.pth is bit-equal too."""
    data, ft = kather

    def run(save, *extra):
        consistency.main(["--task", "kather", "--train_path", data, "--finetune_ckpt", ft, "--save_dir", str(save),
                          "--device", "cpu", "--image_size", "32", "--batch_size", "2", "--mu", "2", "--NAug", "2",
                          "--labeled_train", "0.5", "--modules_student", "45", "--lr", "1e-3", "--save_freq", "1",
                          "--ema", ema, "--validation_split", "0.25", "--no-bf16", *extra])

    run(tmp_path / "straight", "--num_epoch", "2")
    run(tmp_path / "resumed", "--num_epoch", "1")
    run(tmp_path / "resumed", "--num_epoch", "2", "--resume", "auto")
    _same_ckpt(tmp_path / "straight" / "final.pth", tmp_path / "resumed" / "final.pth", ("gen", "host_gen"))
    if ema != "0":
        a, b = (torch.load(tmp_path / d / "teacher_final.pth", weights_only=False) for d in ("straight", "resumed"))
        _same(a["model"], b["model"])
        _same(a["classifier"], b["classifier"])
        s = torch.load(tmp_path / "straight" / "final.pth", weights_only=False)
        assert not torch.equal(a["model"]["fc.0.weight"], s["model"]["fc.0.weight"])


def test_consistency_resume_without_its_teacher_file_resets_the_ema_teacher(tmp_path, capsys):
    """Under --ema, a resume whose teacher_<name> file is missing warns and
    takes the student as the teacher; with the file, the teacher is the
    file's."""
    cfg = TASKS["kather"]
    torch.manual_seed(0)
    state = init_finetune_state("resnet18", cfg.num_classes, CPU, lambda ps: make_optimizer("adam", ps, cfg.lr))
    teacher = init_teacher(state)
    with torch.no_grad():
        teacher.head.classifier[0].weight.add_(1.0)
    args = type("A", (), {"ema": 0.5})
    consistency.resume_teacher(args, teacher, state, str(tmp_path / "ckpt_1.pth"))
    assert "no teacher checkpoint at" in capsys.readouterr().out
    _same(teacher.head.state_dict(), state.head.state_dict())
    with torch.no_grad():
        teacher.head.classifier[0].weight.add_(1.0)
    save_checkpoint(str(tmp_path / "teacher_ckpt_1.pth"), teacher, {"epoch": 1})
    want = {k: v.clone() for k, v in teacher.head.state_dict().items()}
    consistency.S.refresh_teacher(teacher, state)
    consistency.resume_teacher(args, teacher, state, str(tmp_path / "ckpt_1.pth"))
    _same(teacher.head.state_dict(), want)
