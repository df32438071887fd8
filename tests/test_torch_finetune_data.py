"""The fine-tune slice's host modules, the port's own copies, against the
JAX package's originals on the same inputs: the Kather and BreastPathQ
loaders on small written datasets, the splits and labeled-fraction
subsampling, epoch order and the prefetch thread, and the metrics.  All
comparisons are exact (the copies run the same numpy, cv2 and h5py calls),
except the metrics, which are compared to 1e-12."""

import os
import threading

import cv2
import numpy as np
import pytest
import torch

from ssl_cr_histo_tpu.data import datasets as JD
from ssl_cr_histo_tpu.data import pipeline as JP
from ssl_cr_histo_tpu.eval import metrics as JM
from ssl_cr_histo_tpu_torch.data import datasets as TD
from ssl_cr_histo_tpu_torch.data import pipeline as TP
from ssl_cr_histo_tpu_torch.eval import metrics as TM


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


@pytest.fixture(scope="module")
def kather_dir(tmp_path_factory):
    """Four class folders (one unknown name, which maps to TUM) of .tif and
    .png patches at 40^2, so that loading at 32^2 resizes."""
    root = tmp_path_factory.mktemp("kather")
    rng = np.random.default_rng(0)
    for cls in ("ADI", "DEB", "TUM", "OTHER"):
        d = root / cls
        os.makedirs(d)
        for i in range(5):
            img = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
            cv2.imwrite(str(d / f"p{i}.{'tif' if i % 2 else 'png'}"), img)
    return str(root)


@pytest.fixture(scope="module")
def bpq_dir(tmp_path_factory):
    import h5py

    root = tmp_path_factory.mktemp("bpq")
    rng = np.random.default_rng(1)
    for j in range(2):
        with h5py.File(root / f"train_{j}.h5", "w") as f:
            f["x"] = rng.random((7, 3, 40, 40)).astype(np.float32)
            f["y"] = rng.random((7, 1)).astype(np.float32)
    return str(root)


def _equal_ds(got, want):
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == want.labels.dtype and got.images.dtype == want.images.dtype


@pytest.mark.parametrize("size", [32, 40])
def test_kather_folder_matches_jax(kather_dir, size):
    got, want = TD.load_kather_folder(kather_dir, size), JD.load_kather_folder(kather_dir, size)
    _equal_ds(got, want)
    assert got.images.shape == (20, size, size, 3)
    assert sorted(set(got.labels.tolist())) == [TD.KATHER_LABELS[c] for c in ("ADI", "DEB", "TUM")]
    assert TD.KATHER_CLASSES == JD.KATHER_CLASSES


def test_lazy_kather_batches_match_jax(kather_dir):
    """The lazy dataset decodes per batch: the same batches, in the same
    seeded order, as the JAX package's."""
    got = TD.load_kather_folder(kather_dir, 32, lazy=True)
    want = JD.load_kather_folder(kather_dir, 32, lazy=True)
    assert isinstance(got, TD.LazyImageDataset) and got.paths == want.paths
    pairs = zip(got.subset([3, 1, 7, 19]).batches(3, seed=4, drop_last=False),
                want.subset([3, 1, 7, 19]).batches(3, seed=4, drop_last=False))
    n = 0
    for (gi, gl), (wi, wl) in pairs:
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
        n += 1
    assert n == 2
    _equal_ds(got.materialize(), want.materialize())


def test_breastpathq_h5_matches_jax(bpq_dir):
    for size in (32, 40):
        got = TD.load_breastpathq_h5(bpq_dir, size)
        _equal_ds(got, JD.load_breastpathq_h5(bpq_dir, size))
        assert got.images.shape == (14, size, size, 3) and got.labels.dtype == np.float32


@pytest.mark.parametrize("split,seed", [(0.2, 42), (0.25, 7), (0.0, 1)])
def test_train_val_split_matches_jax(kather_dir, split, seed):
    ds_t, ds_j = TD.load_kather_folder(kather_dir, 32), JD.load_kather_folder(kather_dir, 32)
    for got, want in zip(TD.train_val_split(ds_t, split, seed=seed), JD.train_val_split(ds_j, split, seed=seed)):
        _equal_ds(got, want)


@pytest.mark.parametrize("fraction", [0.1, 0.25, 0.5, 1.0])
@pytest.mark.parametrize("with_replacement", [False, True])
@pytest.mark.parametrize("per_class", [False, True])
def test_labeled_fraction_matches_jax(fraction, with_replacement, per_class):
    """Pooled and per-pool draws, with and without replacement; the pool
    key is the source-dir ``groups`` (grouping_key)."""
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (40, 4, 4, 3), dtype=np.uint8)
    labels = rng.integers(0, 2, 40).astype(np.int32)
    groups = (np.arange(40) % 2).astype(np.int32)
    got = TD.labeled_fraction(TD.ArrayDataset(images, labels, groups), fraction, seed=5,
                              with_replacement=with_replacement, per_class=per_class)
    want = JD.labeled_fraction(JD.ArrayDataset(images, labels, groups), fraction, seed=5,
                               with_replacement=with_replacement, per_class=per_class)
    _equal_ds(got, want)
    np.testing.assert_array_equal(got.groups, want.groups)
    np.testing.assert_array_equal(TD.grouping_key(got), JD.grouping_key(want))


def test_labeled_fraction_rejects_an_empty_draw():
    ds = TD.ArrayDataset(np.zeros((5, 2, 2, 3), np.uint8), np.arange(5, dtype=np.int32))
    for per_class in (False, True):
        with pytest.raises(ValueError, match="floors to zero"):
            TD.labeled_fraction(ds, 0.1, per_class=per_class)


@pytest.mark.parametrize("n,b,shuffle,drop_last", [(10, 3, True, True), (10, 3, True, False),
                                                   (9, 3, False, True), (2, 4, True, True)])
def test_epoch_order_matches_jax(n, b, shuffle, drop_last):
    got = list(TP.epoch_indices(n, b, shuffle, 11, drop_last))
    want = list(JP.epoch_indices(n, b, shuffle, 11, drop_last))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    arrays = (np.arange(n) * 10, np.arange(n) % 3)
    for g, w in zip(TP.batch_iterator(arrays, b, shuffle, 11, drop_last),
                    JP.batch_iterator(arrays, b, shuffle, 11, drop_last)):
        for ga, wa in zip(g, w):
            np.testing.assert_array_equal(ga, wa)


def test_prefetch_iter_order_errors_and_early_stop():
    """The items and their order are the JAX prefetch_iter's; a worker error
    reaches the consumer; a consumer that stops early stops the worker."""
    items = [np.full(3, i) for i in range(7)]
    got = list(TP.prefetch_iter(iter(items), size=2, map_fn=lambda a: a * 2))
    want = list(JP.prefetch_iter(iter(items), size=2, map_fn=lambda a: a * 2))
    assert [g.tolist() for g in got] == [w.tolist() for w in want] == [(a * 2).tolist() for a in items]

    def failing():
        yield 1
        raise RuntimeError("reader failed")

    with pytest.raises(RuntimeError, match="reader failed"):
        list(TP.prefetch_iter(failing()))

    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    before = threading.active_count()
    it = TP.prefetch_iter(endless(), size=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert threading.active_count() == before and len(produced) <= 3 + 2 + 2


def test_prefetch_to_device_on_the_cpu():
    """CPU tensors equal to the host arrays, in order, one batch at a time."""
    batches = [(np.full((2, 4, 4, 3), i, np.uint8), np.array([i, i + 1], np.int32)) for i in range(4)]
    got = list(TP.prefetch_to_device(iter(batches), torch.device("cpu")))
    assert len(got) == 4
    for (gi, gl), (wi, wl) in zip(got, batches):
        assert gi.device.type == "cpu" and gi.dtype == torch.uint8
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_array_equal(gl.numpy(), wl)


def test_metrics_match_jax():
    """Every function of the port's eval/metrics.py against the original on
    the same seeded inputs, to 1e-12."""
    rng = np.random.default_rng(8)
    a, b = rng.random(30), rng.random(30) * 0.8 + 0.1
    ratings = rng.random((20, 3))
    y_true = rng.integers(0, 4, 50)
    y_pred = np.where(rng.random(50) < 0.6, y_true, rng.integers(0, 4, 50))
    probs = rng.random((50, 4))
    probs /= probs.sum(1, keepdims=True)
    close = lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    for k, v in JM.icc_table(ratings).items():
        close(TM.icc_table(ratings)[k], v)
    for k, v in JM.icc_two_raters(a, b).items():
        close(TM.icc_two_raters(a, b)[k], v)
    close(TM.kendall_tau(a, b), JM.kendall_tau(a, b))
    close(np.array(list(vars(TM.bland_altman(a, b)).values())), np.array(list(vars(JM.bland_altman(a, b)).values())))
    cm = TM.confusion_matrix(y_true, y_pred, 4)
    np.testing.assert_array_equal(cm, JM.confusion_matrix(y_true, y_pred, 4))
    for k, v in JM.per_class_sens_spec_acc(cm).items():
        close(TM.per_class_sens_spec_acc(cm)[k], v)
    close(TM.weighted_f1(y_true, y_pred), JM.weighted_f1(y_true, y_pred))
    close(TM.multiclass_ovr_auc(y_true, probs), JM.multiclass_ovr_auc(y_true, probs))
    close(TM.binary_auc(y_true > 1, probs[:, 0]), JM.binary_auc(y_true > 1, probs[:, 0]))
    close(TM.accuracy(y_true, y_pred), JM.accuracy(y_true, y_pred))
    tm, jm = TM.AverageMeter(), JM.AverageMeter()
    for v, n in ((1.5, 4), (0.5, 2), (2.0, 1)):
        tm.update(v, n)
        jm.update(v, n)
    assert vars(tm) == vars(jm)
