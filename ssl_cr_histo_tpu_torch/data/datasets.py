"""Dataset readers for the three downstream tasks: the port's own copy of
the parts of ``ssl_cr_histo_tpu/data/datasets.py`` that fine-tuning and
consistency training use (numpy, with cv2 and h5py imported where an image
or an .h5 file is read, so importing this module needs neither).

Readers return raw uint8 HWC arrays and labels; augmentation runs on the
device inside the train step.  Contracts of the reference:
  * BreastPathQ  -- .h5 files with data['x'] float CHW in [0, 1] and
                    data['y'] cellularity scores (dataset.py:453-536)
  * Camelyon16   -- pre-sampled '{idx}.png' patches indexed by list.txt
                    lines 'pid,x_center,y_center'; labels from
                    point-in-polygon tests against per-WSI JSON
                    annotations (the port's ``data.annotations``);
                    fine-tune split rule Tumor_>25 / Normal_>35
                    (dataset.py:685-939)
  * Kather       -- folder-per-class patches, 9 classes ADI..TUM
                    (dataset.py:1002-1241)

Labeled-fraction subsampling defaults to sampling WITHOUT replacement; the
reference samples with replacement (eval_BreastPathQ_SSL.py:299):
``with_replacement=True`` reproduces it.
"""

from __future__ import annotations

import glob
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ssl_cr_histo_tpu_torch.data.annotations import Annotation
from ssl_cr_histo_tpu_torch.data.pipeline import epoch_indices

KATHER_CLASSES = ("ADI", "BACK", "DEB", "LYM", "MUC", "MUS", "NORM", "STR", "TUM")
KATHER_LABELS: Dict[str, int] = {c: i for i, c in enumerate(KATHER_CLASSES)}


@dataclass
class ArrayDataset:
    """Materialized (images uint8 NHWC, labels) pair.  ``groups``
    (optional) records each item's source pool (see ``grouping_key``)."""

    images: np.ndarray
    labels: np.ndarray
    groups: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.images)

    def subset(self, idx) -> "ArrayDataset":
        return ArrayDataset(self.images[idx], self.labels[idx],
                            None if self.groups is None else self.groups[idx])

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0, drop_last: bool = True):
        for sel in epoch_indices(len(self), batch_size, shuffle, seed, drop_last):
            yield self.images[sel], self.labels[sel]


@dataclass
class LazyImageDataset:
    """Path-backed dataset: labels are eager (splits need them), pixels
    decode per batch on a thread pool, as the reference's per-item decode in
    DataLoader workers does (dataset.py:1002-1071); decoding
    NCT-CRC-HE-100K eagerly would take ~15 GB of host RAM."""

    paths: list
    labels: np.ndarray
    image_size: int
    decode_threads: int = 8
    groups: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.paths)

    def subset(self, idx) -> "LazyImageDataset":
        idx = np.asarray(idx)
        return LazyImageDataset([self.paths[int(i)] for i in idx], self.labels[idx], self.image_size,
                                self.decode_threads, None if self.groups is None else self.groups[idx])

    def decode(self, idx) -> np.ndarray:
        import cv2

        def one(i):
            raw = cv2.imread(self.paths[int(i)], cv2.IMREAD_COLOR)
            if raw is None:
                raise FileNotFoundError(f"unreadable image {self.paths[int(i)]!r}")
            return _resize(cv2.cvtColor(raw, cv2.COLOR_BGR2RGB), self.image_size)

        return np.stack(list(self._executor().map(one, np.asarray(idx))))

    def _executor(self) -> ThreadPoolExecutor:
        # one pool per dataset: decode() runs once per batch
        pool = getattr(self, "_pool", None)
        if pool is None:
            pool = self._pool = ThreadPoolExecutor(max_workers=self.decode_threads)
        return pool

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0, drop_last: bool = True):
        for sel in epoch_indices(len(self), batch_size, shuffle, seed, drop_last):
            yield self.decode(sel), self.labels[sel]

    def materialize(self) -> ArrayDataset:
        return ArrayDataset(self.decode(np.arange(len(self))), self.labels, self.groups)


def grouping_key(ds) -> np.ndarray:
    """Pool key for per-class labeled subsampling: the dataset's source-dir
    ``groups`` when they distinguish two or more pools, else the labels
    (``datasets.py:132-145``)."""
    g = getattr(ds, "groups", None)
    if g is not None and len(np.unique(g)) >= 2:
        return np.asarray(g)
    return np.asarray(ds.labels)


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    if img.shape[0] == size and img.shape[1] == size:
        return img
    import cv2

    return cv2.resize(img, (size, size), interpolation=cv2.INTER_CUBIC)


def _breastpathq_items(x: np.ndarray, y: np.ndarray, image_size: int):
    """(uint8 HWC image resized to ``image_size``, float score) of each
    patch of one .h5 file's data['x'] (float CHW in [0, 1]) and data['y'];
    ``(x * 255).astype(np.uint8)`` truncates, as the reference's reader
    does."""
    for patch, score in zip(x, np.asarray(y).reshape(len(x), -1)[:, 0]):
        yield _resize((np.transpose(patch, (1, 2, 0)) * 255).astype(np.uint8), image_size), float(score)


def breastpathq_from_arrays(x: np.ndarray, y: np.ndarray, image_size: int = 256) -> ArrayDataset:
    """The dataset ``load_breastpathq_h5`` reads from one .h5 file holding
    ``x`` and ``y``, from the arrays themselves (no h5py)."""
    images, labels = zip(*_breastpathq_items(x, y, image_size))
    return ArrayDataset(np.stack(images), np.asarray(labels, np.float32))


def load_breastpathq_h5(dataset_path: str, image_size: int = 256) -> ArrayDataset:
    """Every .h5 under ``dataset_path``: data['x'] float CHW in [0, 1] ->
    uint8 HWC resized to ``image_size``; data['y'] float scores."""
    import h5py

    images: List[np.ndarray] = []
    labels: List[float] = []
    for path in sorted(glob.glob(os.path.join(dataset_path, "*.h5"))):
        with h5py.File(path, "r") as f:
            x = np.asarray(f["x"])
            y = np.asarray(f["y"])
        for img, score in _breastpathq_items(x, y, image_size):
            images.append(img)
            labels.append(score)
    return ArrayDataset(np.stack(images), np.asarray(labels, np.float32))


def load_breastpathq_eval_pair(dir_a: str, dir_b: str, image_size: int = 256) -> Tuple[ArrayDataset, np.ndarray]:
    """Two-rater eval set (``datasets.py:177-190``; reference
    dataset.py:539-599: TestSetSherine + TestSetSharon hold the same patches
    scored by two raters): the dataset labeled by rater A and rater B's
    label vector.  Sets of unequal size raise ValueError."""
    a = load_breastpathq_h5(dir_a, image_size)
    b = load_breastpathq_h5(dir_b, image_size)
    if len(a) != len(b):
        raise ValueError(f"rater sets differ in size: {len(a)} vs {len(b)}")
    return a, b.labels


def _camelyon_list(data_path: str) -> List[Tuple[int, str, int, int]]:
    """Parse list.txt -> [(line_idx, pid, x, y)].  Patch files are named by
    line index ('{idx}.png', reference dataset.py:737), so the pairing
    depends on list order, which is kept; short lines are skipped."""
    out = []
    with open(os.path.join(data_path, "list.txt")) as f:
        for i, line in enumerate(f):
            parts = line.strip("\n").split(",")
            if len(parts) < 3:
                continue
            out.append((i, parts[0], int(parts[1]), int(parts[2])))
    return out


_ANNS_CACHE: Dict[str, Tuple[tuple, Dict[str, Annotation]]] = {}


def _load_annotations(json_path: str) -> Dict[str, Annotation]:
    """Every per-WSI annotation JSON under ``json_path`` by slide id,
    memoised on the directory's (filename, mtime) listing: the train and
    validation loaders default to the same ``--json_path``
    (``datasets.py:220-238``)."""
    root = os.path.realpath(json_path)
    files = sorted(p for p in os.listdir(json_path) if p.endswith(".json"))
    stamp = tuple((p, os.path.getmtime(os.path.join(json_path, p))) for p in files)
    cached = _ANNS_CACHE.get(root)
    if cached is not None and cached[0] == stamp:
        return cached[1]
    anns = {p[: -len(".json")]: Annotation().from_json(os.path.join(json_path, p)) for p in files}
    _ANNS_CACHE[root] = (stamp, anns)
    return anns


def _finetune_split(pid: str) -> bool:
    """The reference's hard-coded rule (dataset.py:716-727): fine-tuning
    uses Tumor_>25 and Normal_>35; the other slides pretrain."""
    head, _, num = pid.partition("_")
    if not num.isdigit():
        return False
    if head == "Tumor":
        return int(num) > 25
    if head == "Normal":
        return int(num) > 35
    return False


def split_data_dirs(data_path: str) -> List[str]:
    """The comma-separated directories of a ``--*_path`` value: Camelyon16's
    tumor and normal patch directories, joined by ',' only (':' is legal in
    a POSIX path)."""
    return [d.strip() for d in data_path.split(",") if d.strip()]


def load_camelyon16_patches(data_path: str, json_path: str, image_size: int = 256,
                            split: Optional[str] = "finetune", lazy: "str | bool" = "auto",
                            lazy_threshold: int = 20000):
    """'{idx}.png' patches of one or more comma-separated directories, each
    with its own list.txt, labelled 1 where the patch centre lies in a
    positive polygon of its slide's annotation (``datasets.py:255-327``).

    split: 'finetune' keeps the Tumor_>25 / Normal_>35 slides, 'pretrain'
    the others, None all.  Every listed file's existence is checked here,
    so a list.txt longer than the extracted patch set fails at load.
    ``groups`` records each patch's directory index, the pool key of
    balanced batching and per-class subsampling (``grouping_key``).
    lazy=True (or 'auto' above ``lazy_threshold`` items) returns a
    LazyImageDataset that decodes per batch."""
    dirs = split_data_dirs(data_path)
    if not dirs:
        raise ValueError("empty Camelyon16 data_path (expected patch dir(s))")
    anns = _load_annotations(json_path)
    paths: List[str] = []
    labels: List[int] = []
    groups: List[int] = []
    for dir_i, d in enumerate(dirs):
        for idx, pid, x, y in _camelyon_list(d):
            keep = (split is None or (split == "finetune" and _finetune_split(pid))
                    or (split == "pretrain" and not _finetune_split(pid)))
            if not keep:
                continue
            p = os.path.join(d, f"{idx}.png")
            if not os.path.isfile(p):
                raise FileNotFoundError(f"list.txt line {idx} of {d!r} names a missing patch "
                                        f"file {p!r} (list longer than the extracted png set?)")
            paths.append(p)
            groups.append(dir_i)
            ann = anns.get(pid)
            labels.append(1 if (ann is not None and ann.inside_polygons((x, y), True)) else 0)
    if not paths:
        raise ValueError(
            f"no Camelyon16 patches survived the split={split!r} slide rule "
            f"{'(Tumor_>25/Normal_>35 fine-tune slides only)' if split == 'finetune' else ''} "
            f"in {dirs}; check the list.txt slide ids or pass split=None")
    ds = LazyImageDataset(paths, np.asarray(labels, np.int32), image_size, groups=np.asarray(groups, np.int32))
    if lazy is True or (lazy == "auto" and len(ds) > lazy_threshold):
        return ds
    return ds.materialize()


def load_kather_folder(dataset_path: str, image_size: int = 224,
                       exts: Sequence[str] = ("tif", "png", "jpg"), lazy: "str | bool" = "auto",
                       lazy_threshold: int = 20000):
    """Folder-per-class loader; an unknown folder name is TUM, as in the
    reference's else-branch (dataset.py:1050-1052).  lazy=True (or 'auto'
    above ``lazy_threshold`` items) returns a LazyImageDataset."""
    all_paths: List[str] = []
    labels: List[int] = []
    for cls_dir in sorted(glob.glob(os.path.join(dataset_path, "*/"))):
        label = KATHER_LABELS.get(os.path.basename(os.path.dirname(cls_dir)), 8)
        paths: List[str] = []
        for ext in exts:
            paths += glob.glob(os.path.join(cls_dir, f"*.{ext}"))
        for p in sorted(paths):
            all_paths.append(p)
            labels.append(label)
    ds = LazyImageDataset(all_paths, np.asarray(labels, np.int32), image_size)
    if lazy is True or (lazy == "auto" and len(ds) > lazy_threshold):
        return ds
    return ds.materialize()


def train_val_split(ds, validation_split: float = 0.1, seed: int = 42,
                    shuffle: bool = True) -> Tuple[object, object]:
    """Seeded holdout of floor(validation_split * n) items
    (eval_BreastPathQ_SSL.py:293-307): (train, val)."""
    idx = np.arange(len(ds))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    n_val = int(np.floor(validation_split * len(ds)))
    return ds.subset(idx[n_val:]), ds.subset(idx[:n_val])


def labeled_fraction(ds, fraction: float, seed: int = 42, with_replacement: bool = False,
                     per_class: bool = False):
    """Subsample a labeled fraction, floor-sized like the reference's
    int(frac * n) (eval_BreastPathQ_SSL.py:298).  ``per_class`` draws each
    pool of ``grouping_key`` separately; an empty draw raises."""
    rng = np.random.default_rng(seed)
    if per_class:
        parts = []
        key = grouping_key(ds)
        for cls in np.unique(key):
            cls_idx = np.where(key == cls)[0]
            k = int(fraction * len(cls_idx))
            if k == 0:
                raise ValueError(f"labeled fraction {fraction} of {len(cls_idx)} pool-{cls} samples "
                                 f"floors to zero -- raise --labeled_train or add data")
            parts.append(rng.choice(cls_idx, size=k, replace=with_replacement))
        idx = np.concatenate(parts)
    else:
        n = len(ds)
        idx = rng.choice(n, size=int(fraction * n), replace=with_replacement)
        if len(idx) == 0 and n > 0:
            raise ValueError(f"labeled fraction {fraction} of {n} samples floors to zero -- "
                             f"raise --labeled_train or add data")
    return ds.subset(idx)
