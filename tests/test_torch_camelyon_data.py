"""The port's Camelyon16 host modules against the JAX package's on the same
inputs: the annotation geometry (its own point-in-polygon against
matplotlib's, through the JAX ``Polygon`` / ``Annotation``), the XML -> JSON
converter, the patch loader with its splits and pools, per-class labeled
subsampling, the balanced batch iterator and its epoch length.  Inputs are
made with numpy from a seed; patch trees through tests/camelyon_fixtures.py.
Every comparison is exact."""

import json
import os

import numpy as np
import pytest

from camelyon_fixtures import class_entries, write_annotation_jsons, write_patch_dir
from ssl_cr_histo_tpu.cli import common as JC
from ssl_cr_histo_tpu.data import annotations as JA
from ssl_cr_histo_tpu.data import datasets as JD
from ssl_cr_histo_tpu.data import pipeline as JP
from ssl_cr_histo_tpu_torch.cli import common as TC
from ssl_cr_histo_tpu_torch.data import annotations as TA
from ssl_cr_histo_tpu_torch.data import datasets as TD
from ssl_cr_histo_tpu_torch.data import pipeline as TP


# --- point in polygon ----------------------------------------------------------


def _star_polygon(rng, n):
    """A simple concave polygon: n vertices at sorted angles around a
    centre, at radii that alternate between far and near."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = np.where(np.arange(n) % 2 == 0, rng.uniform(60, 100, n), rng.uniform(10, 40, n))
    centre = rng.uniform(-50, 50, 2)
    return centre + np.stack([rad * np.cos(ang), rad * np.sin(ang)], 1)


def _edge_distance(verts, pts):
    """Each point's distance to the nearest edge of the closed polygon."""
    a, b = verts, np.roll(verts, -1, 0)
    ab = b - a
    t = np.clip(((pts[:, None] - a) * ab).sum(-1) / (ab * ab).sum(-1), 0, 1)
    return np.linalg.norm(pts[:, None] - (a + t[..., None] * ab), axis=-1).min(1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_point_in_polygon_matches_matplotlib_off_the_edges(seed):
    """Random concave polygons (float vertices, either orientation), 4000
    points over their box and around it, those within 1e-6 of an edge
    dropped: the port's Polygon and the JAX package's agree point by point,
    one at a time and vectorised, and both answers occur."""
    rng = np.random.default_rng(seed)
    for k in range(4):
        verts = _star_polygon(rng, 5 + 4 * k + seed)
        if k % 2:
            verts = verts[::-1]
        pts = rng.uniform(verts.min(0) - 20, verts.max(0) + 20, (4000, 2))
        pts = pts[_edge_distance(verts, pts) > 1e-6]
        got, want = TA.Polygon("p", verts).inside_many(pts), JA.Polygon("p", verts).inside_many(pts)
        np.testing.assert_array_equal(got, want)
        assert 0.02 < got.mean() < 0.98
        for p in pts[:50]:
            assert TA.Polygon("p", verts).inside(tuple(p)) == JA.Polygon("p", verts).inside(tuple(p))


def test_point_in_polygon_on_integer_boundaries():
    """On integer polygons and integer points (exact arithmetic) the port
    gives matplotlib's answer on the edges and vertices too, and the answers
    the module docstring states for the square; degenerate polygons hold
    nothing."""
    sq = np.array([[0, 0], [100, 0], [100, 100], [0, 100]])
    grid = np.stack(np.meshgrid(np.arange(-2, 103), np.arange(-2, 103)), -1).reshape(-1, 2)
    rng = np.random.default_rng(3)
    polys = [sq, sq[::-1], np.array([[0, 0], [60, 0], [60, 60], [30, 20], [0, 60]]),
             np.round(_star_polygon(rng, 9)).astype(int)]
    for verts in polys:
        np.testing.assert_array_equal(TA.Polygon("p", verts).inside_many(grid),
                                      JA.Polygon("p", verts).inside_many(grid))
    stated = {(0, 0): False, (50, 0): False, (100, 0): False, (0, 50): True, (100, 50): True,
              (0, 100): True, (50, 100): True, (100, 100): True, (50, 50): True, (101, 50): False}
    for p, inside in stated.items():
        assert TA.Polygon("p", sq).inside(p) == inside, p
    for verts in (np.zeros((0, 2)), np.array([[0, 0], [5, 5]])):
        assert not TA.Polygon("d", verts).inside_many(grid[:10]).any()
        assert not JA.Polygon("d", verts).inside_many(grid[:10]).any()


def test_annotation_from_json_matches_jax(tmp_path):
    """Annotation.from_json with two positive and one negative polygon:
    inside_polygons (one point) and inside_polygons_many, both sets, and
    polygon_vertices, as the JAX package's."""
    rng = np.random.default_rng(4)
    pos = [np.round(_star_polygon(rng, 8)).astype(int) for _ in range(2)]
    neg = [np.round(_star_polygon(rng, 6) * 0.3).astype(int)]
    path = str(tmp_path / "a.json")
    TA.vertices2json(path, pos, neg)
    got, want = TA.Annotation().from_json(path), JA.Annotation().from_json(path)
    pts = rng.uniform(-160, 160, (3000, 2))
    for positive in (True, False):
        np.testing.assert_array_equal(got.inside_polygons_many(pts, positive),
                                      want.inside_polygons_many(pts, positive))
        for p in pts[:40]:
            assert got.inside_polygons(tuple(p), positive) == want.inside_polygons(tuple(p), positive)
        for a, b in zip(got.polygon_vertices(positive), want.polygon_vertices(positive)):
            np.testing.assert_array_equal(a, b)


_XML = """<?xml version="1.0"?>
<ASAP_Annotations>
  <Annotations>
    <Annotation Name="Annotation 0" Type="Polygon" PartOfGroup="Tumor">
      <Coordinates>
        <Coordinate Order="0" X="10.4" Y="20.6" /><Coordinate Order="1" X="110.5" Y="20.1" />
        <Coordinate Order="2" X="110.2" Y="90.9" /><Coordinate Order="3" X="12.0" Y="95.5" />
      </Coordinates>
    </Annotation>
    <Annotation Type="Polygon" PartOfGroup="_0">
      <Coordinates>
        <Coordinate Order="0" X="1000" Y="1000" /><Coordinate Order="1" X="1200.7" Y="1001" />
        <Coordinate Order="2" X="1100" Y="1300.2" />
      </Coordinates>
    </Annotation>
    <Annotation Name="Annotation 2" Type="Polygon" PartOfGroup="_1">
      <Coordinates>
        <Coordinate Order="0" X="5" Y="5" /><Coordinate Order="1" X="9" Y="5" /><Coordinate Order="2" X="7" Y="9" />
      </Coordinates>
    </Annotation>
    <Annotation Name="hole" Type="Polygon" PartOfGroup="_2">
      <Coordinates>
        <Coordinate Order="0" X="40" Y="40" /><Coordinate Order="1" X="60" Y="40" /><Coordinate Order="2" X="50" Y="60" />
      </Coordinates>
    </Annotation>
  </Annotations>
</ASAP_Annotations>
"""


def test_camelyon16xml2json_matches_jax(tmp_path):
    """The same XML (groups Tumor, _0, _1 and _2, with and without names,
    fractional coordinates) gives byte-equal JSON; vertices2json too."""
    xml = tmp_path / "t.xml"
    xml.write_text(_XML)
    TA.camelyon16xml2json(str(xml), str(tmp_path / "port.json"))
    JA.camelyon16xml2json(str(xml), str(tmp_path / "jax.json"))
    got = (tmp_path / "port.json").read_bytes()
    assert got == (tmp_path / "jax.json").read_bytes()
    doc = json.loads(got)
    assert len(doc["positive"]) == 3 and len(doc["negative"]) == 1
    verts = [np.arange(8).reshape(4, 2) * 3.7]
    TA.vertices2json(str(tmp_path / "pv.json"), verts, verts[:0])
    JA.vertices2json(str(tmp_path / "jv.json"), verts, verts[:0])
    assert (tmp_path / "pv.json").read_bytes() == (tmp_path / "jv.json").read_bytes()


# --- the patch loader ----------------------------------------------------------


@pytest.fixture(scope="module")
def patch_tree(tmp_path_factory):
    """A tumor dir and a normal dir: fine-tune slides (Tumor_026,
    Normal_040) and pretrain slides (Tumor_010, Normal_020); tumor-dir
    patches inside the origin polygon (coord 50) and outside it (coord
    500), so the tumor pool holds polygon-negative patches too."""
    root = tmp_path_factory.mktemp("cam")
    jsons = write_annotation_jsons(root / "jsons", pids=("Tumor_026", "Normal_040", "Tumor_010", "Normal_020"))
    tumor = write_patch_dir(root / "tumor", class_entries("Tumor_026", 50, 9, seed=1)
                            + class_entries("Tumor_026", 500, 3, seed=2) + class_entries("Tumor_010", 50, 4, seed=3))
    normal = write_patch_dir(root / "normal", class_entries("Normal_040", 500, 11, seed=4)
                             + class_entries("Normal_020", 500, 5, seed=5))
    return str(tumor), str(normal), str(jsons)


def _load_both(tree, split, lazy=False, size=32):
    tumor, normal, jsons = tree
    path = f"{tumor},{normal}"
    return (TD.load_camelyon16_patches(path, jsons, size, split=split, lazy=lazy),
            JD.load_camelyon16_patches(path, jsons, size, split=split, lazy=lazy))


@pytest.mark.parametrize("split", ["finetune", "pretrain", None])
def test_load_camelyon16_patches_matches_jax(patch_tree, split):
    """Paths, labels and groups (lazy), and the decoded images (eager, at
    32^2 and resized to 24^2), for each split rule."""
    got, want = _load_both(patch_tree, split, lazy=True)
    assert isinstance(got, TD.LazyImageDataset) and got.paths == want.paths
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.groups, want.groups)
    assert got.labels.dtype == want.labels.dtype and got.groups.dtype == want.groups.dtype
    n = {"finetune": 23, "pretrain": 9, None: 32}[split]
    assert len(got) == n and set(got.groups.tolist()) == {0, 1}
    for size in (32, 24):
        g, w = _load_both(patch_tree, split, size=size)
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.labels, w.labels)
    if split == "finetune":
        assert got.labels.tolist() == [1] * 9 + [0] * 14
    assert TD.split_data_dirs(" a, b ,,c ") == JD.split_data_dirs(" a, b ,,c ") == ["a", "b", "c"]
    pids = ["Tumor_025", "Tumor_026", "Normal_035", "Normal_036", "Tumor_x", "Other_99", "Normal"]
    assert [TD._finetune_split(p) for p in pids] == [JD._finetune_split(p) for p in pids]


def test_load_camelyon16_patches_errors_match_jax(tmp_path):
    """A list.txt longer than its patches fails at load with the JAX
    package's message; a split that keeps nothing raises the same
    ValueError."""
    jsons = str(write_annotation_jsons(tmp_path / "jsons"))
    d = write_patch_dir(tmp_path / "t", class_entries("Tumor_026", 50, 3))
    with open(d / "list.txt", "a") as f:
        f.write("Tumor_026,50,50\n")
    errs = []
    for load in (TD.load_camelyon16_patches, JD.load_camelyon16_patches):
        with pytest.raises(FileNotFoundError) as e:
            load(str(d), jsons, 32)
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "3.png" in errs[0]
    d2 = write_patch_dir(tmp_path / "p", class_entries("Tumor_001", 50, 2))
    errs = []
    for load in (TD.load_camelyon16_patches, JD.load_camelyon16_patches):
        with pytest.raises(ValueError) as e:
            load(str(d2), jsons, 32)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_annotations_are_memoised_like_jax(patch_tree):
    """The (name, mtime) memo returns the same parse on a second load."""
    jsons = patch_tree[2]
    a = TD._load_annotations(jsons)
    assert TD._load_annotations(jsons) is a
    assert sorted(a) == sorted(JD._load_annotations(jsons))


@pytest.mark.parametrize("with_replacement", [False, True])
def test_labeled_fraction_per_class_matches_jax(patch_tree, with_replacement):
    """Per-pool subsampling (the source dirs) draws the same items as the
    JAX package's for three seeds and two fractions; grouping_key is the
    dirs here and the labels for a one-dir dataset."""
    got, want = _load_both(patch_tree, "finetune")
    np.testing.assert_array_equal(TD.grouping_key(got), JD.grouping_key(want))
    np.testing.assert_array_equal(TD.grouping_key(got), got.groups)
    one = TD.ArrayDataset(got.images, got.labels, np.zeros_like(got.groups))
    np.testing.assert_array_equal(TD.grouping_key(one), got.labels)
    for seed in (0, 1, 42):
        for frac in (0.25, 0.5):
            g = TD.labeled_fraction(got, frac, seed=seed, with_replacement=with_replacement, per_class=True)
            w = JD.labeled_fraction(want, frac, seed=seed, with_replacement=with_replacement, per_class=True)
            np.testing.assert_array_equal(g.images, w.images)
            np.testing.assert_array_equal(g.labels, w.labels)
            np.testing.assert_array_equal(g.groups, w.groups)
    with pytest.raises(ValueError, match="floors to zero"):
        TD.labeled_fraction(got, 0.05, per_class=True)


# --- balanced batches and their epoch ------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 1042])
@pytest.mark.parametrize("lazy", [False, True])
def test_balanced_batch_iterator_matches_jax(patch_tree, seed, lazy):
    """The same batches (images and polygon labels, in order) as the JAX
    package's for the seed, eager and lazy; each batch takes batch_size
    rows from each pool; the epoch is the smaller pool's batch count."""
    got, want = _load_both(patch_tree, None, lazy=lazy)
    for bs in (2, 4):
        pairs = list(zip(TP.balanced_batch_iterator(got, bs, seed=seed),
                         JP.balanced_batch_iterator(want, bs, seed=seed), strict=True))
        assert len(pairs) == min(np.bincount(got.groups)) // bs
        for (gi, gl), (wi, wl) in pairs:
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
            assert gi.shape[0] == 2 * bs
    # the pools, through the tumor-dir patches' colour (bright) and the normal dir's (dark)
    imgs, _ = next(TP.balanced_batch_iterator(got, 4, seed=seed))
    assert (imgs.reshape(8, -1).mean(1) > 128).sum() == 4
    with pytest.raises(ValueError, match="two pools"):
        next(TP.balanced_batch_iterator(TD.ArrayDataset(imgs, np.zeros(8, np.int32)), 2))


def test_balanced_epoch_len_matches_jax():
    """Steps per epoch for several pool keys and batch sizes (the JAX
    package's unclamped count, 0 included); SystemExit with the JAX
    package's message for one or three pools; rows_per_step per task."""
    rng = np.random.default_rng(5)
    for _ in range(20):
        key = rng.integers(0, 2, rng.integers(2, 200))
        if len(np.unique(key)) != 2:
            continue
        for bs in (1, 3, 16, 500):
            assert TC.balanced_epoch_len(key, bs) == JC.balanced_epoch_len(key, bs, clamp=False)
    assert TC.balanced_epoch_len([0, 1, 1], 4) == 0
    for key in ([1, 1, 1], [0, 1, 2, 2]):
        msgs = []
        for fn in (TC.balanced_epoch_len, JC.balanced_epoch_len):
            with pytest.raises(SystemExit) as e:
                fn(key, 2)
            msgs.append(str(e.value).replace("—", "--"))
        assert msgs[0] == msgs[1]
    for name, cfg in TC.TASKS.items():
        for bs in (1, 8, 16):
            assert cfg.rows_per_step(bs) == JC.TASKS[name].rows_per_step(bs)
    assert TC.TASKS["camelyon16"].rows_per_step(16) == 32


def test_loader_reads_png_patches_in_list_order(tmp_path):
    """'{idx}.png' pairs with list.txt's line idx, short lines skipped: the
    port's _camelyon_list is the JAX package's."""
    d = write_patch_dir(tmp_path / "d", class_entries("Tumor_030", 7, 3))
    with open(d / "list.txt", "a") as f:
        f.write("bad line\n")
    assert TD._camelyon_list(str(d)) == JD._camelyon_list(str(d))
    assert [e[0] for e in TD._camelyon_list(str(d))] == [0, 1, 2]
    assert os.path.exists(d / "2.png")
