"""The port's serving path against the JAX package's on the CPU: WSI/mask
pairing, the work list, the probability map from one set of weights, the
serving loop's order, the artifacts, every FROC function, the heatmap CLI
then the FROC CLI from a port checkpoint, and the annotation converter.

Slides and masks are made with numpy from a seed; weights by flax, carried
to the port with ``from_jax_params``, or saved by the port as a ``.pth``
that the JAX package reads.  Maps are compared within 1e-5 (float32
forwards on both sides); everything else exactly."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssl_cr_histo_tpu.data import wsi as JW
from ssl_cr_histo_tpu.eval import froc as JF
from ssl_cr_histo_tpu.eval import heatmap as JH
from ssl_cr_histo_tpu.models import FinetuneHead as JFinetuneHead
from ssl_cr_histo_tpu.models import TripletNet as JTripletNet
from ssl_cr_histo_tpu.parallel import steps as JS
from ssl_cr_histo_tpu.train.checkpoint import load_torch_linear_head, load_torch_triplet_checkpoint
from ssl_cr_histo_tpu.train.state import TrainState as JTrainState
from ssl_cr_histo_tpu_torch.cli.common import make_optimizer
from ssl_cr_histo_tpu_torch.data import wsi as TW
from ssl_cr_histo_tpu_torch.eval import froc as TF
from ssl_cr_histo_tpu_torch.eval import heatmap as TH
from ssl_cr_histo_tpu_torch.parallel import steps as TS
from ssl_cr_histo_tpu_torch.train.checkpoint import from_jax_params, save_checkpoint
from ssl_cr_histo_tpu_torch.train.init import init_finetune_state


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


IMG = 64
CPU = torch.device("cpu")


def _slide(seed, size=512):
    """A white slide with a noisy pink tissue block over its left part."""
    rng = np.random.default_rng(seed)
    s = np.full((size, size, 3), 245, np.uint8)
    s[:, : size * 5 // 8] = np.clip(np.array([190, 80, 160]) + rng.integers(-40, 40, (size, size * 5 // 8, 3)),
                                    0, 255)
    return s


def _mask(seed, n=16):
    return (np.random.default_rng(seed).random((n, n)) < 0.5).astype(np.uint8)


def _jax_state(mparams, stats, head):
    return JTrainState(params={"model": mparams, "head": head}, batch_stats=stats, opt_state=(),
                       step=jnp.zeros([], jnp.int32))


@pytest.fixture(scope="module")
def weights():
    """flax TripletNet + 2-way FinetuneHead weights from a seed."""
    jm = JTripletNet("resnet18")
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False, method=jm.encode_single)
    head = JFinetuneHead(2).init(jax.random.PRNGKey(2), jnp.zeros((1, 768)))["params"]
    return jax.device_get(v["params"]), jax.device_get(v["batch_stats"]), jax.device_get(head)


def _port_state(weights):
    sd, head_sd = from_jax_params(*weights)
    state = init_finetune_state("resnet18", 2, CPU, lambda ps: make_optimizer("sgd", ps, 5e-4))
    state.model.load_state_dict(sd)
    state.head.load_state_dict(head_sd)
    return state


# --- pairing and the work list ---------------------------------------------------


def test_pair_wsi_masks_matches_jax():
    """Pairs by basename (id, id_mask, id_tissue) as the JAX package's;
    unmatched files raise with both lists in the JAX package's text."""
    wsis = ["/w/b.tif", "/w/a.npy", "/w/c.svs"]
    masks = ["/m/c_tissue.npy", "/m/a.npy", "/m/b_mask.npy"]
    assert TH.pair_wsi_masks(wsis, masks) == JH.pair_wsi_masks(wsis, masks)
    assert TH.pair_wsi_masks(wsis, masks)[0] == ("/w/a.npy", "/m/a.npy")
    msgs = []
    for fn in (TH.pair_wsi_masks, JH.pair_wsi_masks):
        with pytest.raises(ValueError) as e:
            fn(wsis + ["/w/d.tif", "/w/e.tif"], masks + ["/m/zz.npy"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "['d', 'e']" in msgs[0] and "['zz']" in msgs[0]


def test_mask_work_list_matches_jax():
    """Indices and resolution as the JAX package's; a slide/mask aspect
    mismatch and a resolution that is not a power of 2 raise as there."""
    slide, mask = _slide(0), _mask(1)
    got = TH.mask_work_list(TW.ArrayPyramid(slide, levels=1), mask)
    want = JH.mask_work_list(JW.ArrayPyramid(slide, levels=1), mask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2] == 32
    for bad in (np.zeros((16, 8), np.uint8), np.zeros((24, 24), np.uint8)):
        msgs = []
        for mod, W in ((TH, TW), (JH, JW)):
            with pytest.raises(ValueError) as e:
                mod.mask_work_list(W.ArrayPyramid(slide, levels=1), bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# --- the map -----------------------------------------------------------------------


@pytest.mark.parametrize("batch_size", [24, 256])
def test_compute_probs_map_matches_jax(weights, batch_size):
    """One set of weights, float32, image size 64, a 512^2 slide and a
    16 x 16 mask (resolution 32; patches cross the slide's border): the
    port's map is the JAX package's (compute_probs_map with make_forward_fn)
    within 1e-5; 0 outside the mask; the probabilities inside it differ
    from cell to cell."""
    slide, mask = _slide(2), _mask(3)
    forward = JS.make_forward_fn(JTripletNet("resnet18"), JFinetuneHead(2))
    jstate = _jax_state(*weights)
    want = JH.compute_probs_map(JW.ArrayPyramid(slide, levels=1), mask, lambda p: forward(jstate, p),
                                image_size=IMG, batch_size=batch_size)
    state = _port_state(weights)
    got = TH.compute_probs_map(TW.ArrayPyramid(slide, levels=1), mask, lambda x: TS.forward(state, x), CPU,
                               image_size=IMG, batch_size=batch_size)
    assert got.shape == mask.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[mask == 0].any()
    inside = got[mask > 0]
    assert inside.max() - inside.min() > 0.03 and (inside > 0).all()


def test_serving_loop_drains_each_batch_after_the_next_forward(monkeypatch):
    """Batch k's logits are drained only after batch k+1's forward was
    issued; each forward gets a uint8 batch on the device, the last one
    short; every cell of the mask is written once."""
    events = []
    real_drain = TH._drain

    def forward(x):
        assert x.dtype == torch.uint8 and x.shape[1:] == (8, 8, 3)
        events.append(("forward", len(x)))
        return torch.stack([torch.zeros(len(x)), x.float().mean((1, 2, 3)) / 64], 1)

    def drain(pending, probs_map):
        events.append(("drain", len(pending[2])))
        real_drain(pending, probs_map)

    monkeypatch.setattr(TH, "_drain", drain)
    mask = np.ones((8, 8), np.uint8)
    pm = TH.compute_probs_map(TW.ArrayPyramid(_slide(4, 64), levels=1), mask, forward, CPU, image_size=8,
                              batch_size=10)
    assert [e[0] for e in events] == ["forward"] + ["forward", "drain"] * 6 + ["drain"]
    assert [e[1] for e in events if e[0] == "forward"] == [10] * 6 + [4]
    assert (pm > 0.5).all()


def test_heatmap_artifacts_match_jax(tmp_path):
    """The .npy, the grey PNG and the jet PNG are byte-equal to the JAX
    package's (matplotlib's jet and Pillow here); the jet table is
    matplotlib's; the colour-bar figure is written where matplotlib is."""
    import matplotlib

    pm = np.random.default_rng(5).random((40, 30)).astype(np.float32)
    pm[0, 0], pm[1, 1], pm[2, 2] = 1.0, 0.0, 0.999999
    TH.save_heatmap_artifacts(pm, str(tmp_path / "port"), "s")
    JH.save_heatmap_artifacts(pm, str(tmp_path / "jax"), "s")
    for name in ("s.npy", "s.png", "s_heatmap.png"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    assert (tmp_path / "port" / "s_heatmap_bar.png").exists()
    cmap = matplotlib.colormaps["jet"]
    np.testing.assert_array_equal(TH.jet_rgba(pm), np.uint8(cmap(pm) * 255))
    x = np.linspace(0, 1, 1001, dtype=np.float32)
    np.testing.assert_array_equal(TH.jet_rgba(x), np.uint8(cmap(x) * 255))


def test_heatmap_artifacts_without_matplotlib(tmp_path, monkeypatch):
    """Without matplotlib the .npy and both PNGs are still written and the
    colour-bar figure is not."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    pm = np.random.default_rng(6).random((12, 9)).astype(np.float32)
    assert TH.save_heatmap_artifacts(pm, str(tmp_path), "n") is False
    assert sorted(os.listdir(tmp_path)) == ["n.npy", "n.png", "n_heatmap.png"]
    np.testing.assert_array_equal(np.load(tmp_path / "n.npy"), pm)


# --- FROC ---------------------------------------------------------------------------


def _blob_map(rng, n=64, blobs=6):
    pm = rng.random((n, n)).astype(np.float32) * 0.4
    for _ in range(blobs):
        y, x = rng.integers(4, n - 4, 2)
        r = rng.integers(1, 4)
        pm[y - r: y + r + 1, x - r: x + r + 1] = rng.uniform(0.5, 1.0, (2 * r + 1, 2 * r + 1))
    return pm


def _gt_mask(rng, n=64):
    gt = np.zeros((n, n), np.uint8)
    for _ in range(4):
        y, x = rng.integers(2, n - 8, 2)
        gt[y: y + rng.integers(1, 7), x: x + rng.integers(1, 7)] = 1
    return gt


def _equal_result(got, want):
    assert set(got) == set(want)
    for k in got:
        if isinstance(got[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_froc_functions_match_jax(seed, tmp_path):
    """detect_candidates, _major_axis_px, lesion_labels (with and without
    the ITC cutoff), evaluate_froc, evaluate_probs_maps and
    rasterize_annotation give the JAX package's results exactly on seeded
    maps, masks and annotations."""
    rng = np.random.default_rng(seed)
    maps = [_blob_map(rng) for _ in range(3)]
    gts = [_gt_mask(rng), None, _gt_mask(rng)]
    for pm in maps:
        for thr in (0.5, 0.8):
            for g, w in zip(TF.detect_candidates(pm, thr), JF.detect_candidates(pm, thr)):
                np.testing.assert_array_equal(g, w)
                assert g.dtype == w.dtype
    ys, xs = np.nonzero(gts[0])
    assert TF._major_axis_px(ys, xs) == JF._major_axis_px(ys, xs)
    assert TF._major_axis_px(ys[:1], xs[:1]) == JF._major_axis_px(ys[:1], xs[:1]) == 0.0
    for itc in (0.0, 3.0):
        g, w = TF.lesion_labels(gts[0], itc), JF.lesion_labels(gts[0], itc)
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1:] == w[1:]
        slides = [TF.SlideDetections(*TF.detect_candidates(pm, 0.5), gt) for pm, gt in zip(maps, gts)]
        jslides = [JF.SlideDetections(*JF.detect_candidates(pm, 0.5), gt) for pm, gt in zip(maps, gts)]
        _equal_result(TF.evaluate_froc(slides, itc), JF.evaluate_froc(jslides, itc))
        _equal_result(TF.evaluate_probs_maps(list(zip(maps, gts)), 0.6, itc),
                      JF.evaluate_probs_maps(list(zip(maps, gts)), 0.6, itc))
    assert TF.FP_RATES == JF.FP_RATES
    path = str(tmp_path / "a.json")
    with open(path, "w") as f:
        json.dump({"positive": [{"name": "p", "vertices": (rng.integers(0, 2000, (7, 2))).tolist()}],
                   "negative": [{"name": "n", "vertices": [[500, 500], [900, 520], [700, 950]]}]}, f)
    for res in (32, 64):
        np.testing.assert_array_equal(TF.rasterize_annotation(path, (48, 40), res),
                                      JF.rasterize_annotation(path, (48, 40), res))


# --- the CLIs -------------------------------------------------------------------------


def test_heatmap_then_froc_cli_from_a_port_checkpoint(tmp_path, capsys):
    """The heatmap CLI on the CPU (--device cpu, float32, image size 64,
    batch 32) over a tumor and a normal slide from a port .pth with a 2-way
    head: each map is the JAX package's map from the same .pth (read by
    load_torch_triplet_checkpoint and load_torch_linear_head) within 1e-5,
    0 off the mask; the artifacts are written; then the FROC CLI on the
    maps writes the JAX FROC CLI's report."""
    from ssl_cr_histo_tpu.cli import froc as jfroc_cli
    from ssl_cr_histo_tpu_torch.cli import froc as froc_cli
    from ssl_cr_histo_tpu_torch.cli import heatmap as heatmap_cli

    wsis, masks, gt, out = (tmp_path / d for d in ("wsis", "masks", "gt", "maps"))
    for d in (wsis, masks, gt):
        os.makedirs(d)
    for i, name in enumerate(("tumor_001", "normal_001")):
        np.save(wsis / f"{name}.npy", _slide(10 + i))
        np.save(masks / f"{name}_tissue.npy", _mask(20 + i))
    np.save(gt / "tumor_001.npy", _gt_mask(np.random.default_rng(7), 16))
    torch.manual_seed(4)
    state = init_finetune_state("resnet18", 2, CPU, lambda ps: make_optimizer("sgd", ps, 5e-4))
    with torch.no_grad():
        state.head.classifier[0].weight.mul_(50.0)
    ckpt = str(tmp_path / "cr" / "best.pth")
    save_checkpoint(ckpt, state, {"epoch": 1})

    maps = heatmap_cli.main(["--test_image_pth", str(wsis), "--test_mask_pth", str(masks), "--probs_map_path",
                             str(out), "--finetune_ckpt", ckpt, "--device", "cpu", "--no-bf16", "--image_size",
                             str(IMG), "--batch_size", "32"])
    assert sorted(maps) == ["normal_001", "tumor_001"]
    mparams, mstats = load_torch_triplet_checkpoint(ckpt)
    jstate = _jax_state(mparams, mstats, load_torch_linear_head(ckpt, "classifier"))
    forward = JS.make_forward_fn(JTripletNet("resnet18"), JFinetuneHead(2))
    for i, name in enumerate(("tumor_001", "normal_001")):
        want = JH.compute_probs_map(JW.ArrayPyramid(_slide(10 + i), levels=1), _mask(20 + i),
                                    lambda p: forward(jstate, p), image_size=IMG, batch_size=32)
        np.testing.assert_allclose(maps[name], want, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(np.load(out / f"{name}.npy"), maps[name])
        assert not maps[name][_mask(20 + i) == 0].any()
        for suffix in (".png", "_heatmap.png", "_heatmap_bar.png"):
            assert (out / f"{name}{suffix}").exists()
    assert "patches/s" in capsys.readouterr().out

    common = ["--probs_map_path", str(out), "--gt_path", str(gt), "--threshold", "0.5"]
    froc_cli.main(common + ["--out", str(tmp_path / "port.json")])
    jfroc_cli.main(common + ["--out", str(tmp_path / "jax.json")])
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    report = json.loads((tmp_path / "port.json").read_text())
    assert report["n_slides"] == 2 and report["slides"] == ["normal_001", "tumor_001"]
    assert "ITC exclusion is OFF" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="mask_mpp"):
        froc_cli.main(common + ["--itc_um", "275"])


def test_heatmap_cli_needs_a_gpu_by_default(tmp_path, monkeypatch):
    """Without --device the CLI asks for CUDA and fails when there is none."""
    from ssl_cr_histo_tpu_torch.cli import heatmap as heatmap_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        heatmap_cli.main(["--test_image_pth", str(tmp_path), "--test_mask_pth", str(tmp_path),
                          "--probs_map_path", str(tmp_path), "--finetune_ckpt", "x.pth"])


def test_convert_annotations_matches_jax(tmp_path, capsys):
    """The converter CLI writes the JAX package's JSON for each XML."""
    from ssl_cr_histo_tpu.cli import convert_annotations as jconv
    from ssl_cr_histo_tpu_torch.cli import convert_annotations as tconv
    from test_torch_camelyon_data import _XML

    xml = tmp_path / "xml"
    os.makedirs(xml)
    (xml / "tumor_001.xml").write_text(_XML)
    (xml / "tumor_002.xml").write_text(_XML.replace('PartOfGroup="_1"', 'PartOfGroup="_2"'))
    tconv.main(["--xml_dir", str(xml), "--json_dir", str(tmp_path / "port")])
    jconv.main(["--xml_dir", str(xml), "--json_dir", str(tmp_path / "jax")])
    for name in ("tumor_001.json", "tumor_002.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert "converted 2 annotations" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no .xml"):
        tconv.main(["--xml_dir", str(tmp_path / "port"), "--json_dir", str(tmp_path / "x")])
