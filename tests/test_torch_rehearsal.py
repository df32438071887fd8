"""The port's rehearsal tool (``ssl_cr_histo_tpu_torch/tools/rehearsal.py``)
against the JAX package's (``tools/rehearsal.py``): every synthetic
generator writes the same bytes from the same arguments, the bands and the
recipe table are the same, ``check_bands`` and the partial report behave
alike, and BreastPathQ's in-memory route (``--bpq_data arrays``) hands the
CLIs the datasets the .h5 files give.  The recipe end to end is
``tests/test_torch_rehearsal_recipe.py``."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from ssl_cr_histo_tpu.data import datasets as JD

import rehearsal as R  # noqa: E402  (tools/ path injected above)

from ssl_cr_histo_tpu_torch.data import datasets as TD
from ssl_cr_histo_tpu_torch.tools import rehearsal as P


def tree_bytes(root: str) -> dict:
    """{path relative to ``root``: the file's bytes} of every file under it."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


GENERATORS = {
    "pretrain_wsis": lambda m, o: m.make_pretrain_wsis(os.path.join(o, "wsis"), n_slides=2, size=320, seed=4),
    "camelyon_patches": lambda m, o: m.make_camelyon_patches(o, os.path.join(o, "jsons"), n_per_class=6,
                                                             n_valid_per_class=3, size=32, seed=2),
    "heatmap_slide": lambda m, o: m.make_heatmap_slide(os.path.join(o, "wsi"), os.path.join(o, "mask"),
                                                       os.path.join(o, "gt"), size=384, resolution=32, seed=9),
    "breastpathq_h5": lambda m, o: m.make_breastpathq_h5(os.path.join(o, "train"), os.path.join(o, "a"),
                                                         os.path.join(o, "b"), n_train=8, n_eval=4, size=32,
                                                         seed=6),
    "kather_folder": lambda m, o: m.make_kather_folder(os.path.join(o, "kather"), n_per_class=3, size=32, seed=8),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_writes_the_same_bytes(tmp_path, name):
    """Each generator of the port writes, file for file, the bytes the JAX
    tool's writes from the same arguments: .npy slides, masks and ground
    truth, PNG and TIF patches, list.txt, annotation JSONs, .h5 files.
    The returned values (paths, the grid size) correspond too."""
    gen = GENERATORS[name]
    ret_jax = gen(R, str(tmp_path / "jax"))
    ret_port = gen(P, str(tmp_path / "port"))
    want, got = tree_bytes(str(tmp_path / "jax")), tree_bytes(str(tmp_path / "port"))
    assert want and sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []
    swap = lambda v: v if not isinstance(v, str) else v.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    if isinstance(ret_jax, tuple):
        assert tuple(map(swap, ret_jax)) == ret_port
    else:
        assert swap(ret_jax) == ret_port


def test_generator_constants_and_lesions_match():
    for k in ("TUMOR_BASE", "NORMAL_BASE", "TUMOR_T", "NORMAL_T", "LABEL_NOISE", "KATHER_BASES", "KATHER_JITTER"):
        assert getattr(P, k) == getattr(R, k), k
    for g in (4, 8, 13, 32):
        assert P._lesion_boxes(g) == R._lesion_boxes(g)


def test_breastpathq_h5_datasets_match(tmp_path):
    """The .h5 datasets themselves, read back with h5py: x float32 CHW in
    [0, 1] and y float32, equal to the JAX tool's."""
    import h5py

    for m, tag in ((R, "jax"), (P, "port")):
        m.make_breastpathq_h5(str(tmp_path / tag / "t"), str(tmp_path / tag / "a"), str(tmp_path / tag / "b"),
                              n_train=6, n_eval=3, size=24)
    for rel in ("t/train.h5", "a/eval.h5", "b/eval.h5"):
        with h5py.File(tmp_path / "jax" / rel) as fj, h5py.File(tmp_path / "port" / rel) as fp:
            for key in ("x", "y"):
                want, got = np.asarray(fj[key]), np.asarray(fp[key])
                assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
                np.testing.assert_array_equal(got, want)


def test_bands_and_recipes_match_the_original():
    assert P.BANDS == R.BANDS
    assert sorted(P.RECIPES) == sorted(R.RECIPES)
    for recipe, (run, name, ft, cr) in P.RECIPES.items():
        _, want_name, want_ft, want_cr = R.RECIPES[recipe]
        assert callable(run) and (name, ft, cr) == (want_name, want_ft, want_cr)


def test_main_flags_and_defaults_match_the_original(tmp_path, monkeypatch):
    """Every flag of the original with its default (the work dir lies under
    the temp dir, the report under the work dir), plus --device and
    --bpq_data."""
    seen = {}

    def capture(mod):
        def run(args, W, report):
            seen[mod] = dict(vars(args))
            raise SystemExit("stop")
        return run

    for mod in (R, P):
        _, out, ft, cr = mod.RECIPES["kather"]
        monkeypatch.setitem(mod.RECIPES, "kather", (capture(mod), out, ft, cr))
        monkeypatch.setattr(mod, "_finalize_report", lambda args, report: None)
        with pytest.raises(SystemExit, match="stop"):
            mod.main(["--recipe", "kather", "--workdir", str(tmp_path / mod.__name__.split(".")[-1])])
    want, got = seen[R], seen[P]
    assert got.pop("device") == "cuda" and got.pop("bpq_data") == "h5"
    assert got.pop("out") == str(tmp_path / "rehearsal" / "REHEARSAL_KATHER.json")
    assert want.pop("out") == "REHEARSAL_KATHER.json"
    assert {k: v for k, v in got.items() if k != "workdir"} == {k: v for k, v in want.items() if k != "workdir"}


def test_check_bands_detects_violations():
    report = {"stages": {
        "pretrain": {"val_acc_best": 0.55},
        "finetune": {"val_range": 0.1},
        "consistency": {"val_range": 0.05},
        "evaluation": {"auc": 0.995, "accuracy": 0.85, "weighted_f1": 0.85},
        "froc": {"froc": 0.5},
        "heatmap": {"strong_lesion_mean_prob": 0.7, "normal_slide_mean_prob": 0.1},
    }}
    v = P.check_bands("camelyon16", report, enforce=True)
    assert v == ["evaluation.auc=0.995 not in [0.8, 0.99]"]
    assert v == R.check_bands("camelyon16", json.loads(json.dumps(report)), enforce=True)
    # the bands are recorded in the report, enforced or not
    assert report["expected_bands"]["evaluation.auc"] == [0.80, 0.99]
    assert P.check_bands("camelyon16", dict(report), enforce=False) == []


def test_check_bands_dotted_keys_reuse_and_missing_metric():
    report = {"stages": {
        "pretrain": {"reused": "/some/ckpt_25.pth"},  # --stage1_ckpt: gate skipped
        "evaluation": {"icc_MA": {"ICC2": 0.80}, "icc_AB": {"ICC2": 0.90}, "tau_MA": 0.70},
    }}
    assert P.check_bands("breastpathq", report, enforce=True) == []
    report["stages"]["evaluation"]["icc_AB"]["ICC2"] = 0.99
    assert P.check_bands("breastpathq", report, enforce=True) == ["evaluation.icc_AB.ICC2=0.99 not in [0.7, 0.98]"]
    report["stages"]["evaluation"]["icc_AB"]["ICC2"] = 0.90
    # a missing metric is a violation, not a pass
    del report["stages"]["evaluation"]["tau_MA"]
    assert P.check_bands("breastpathq", report, enforce=True) == ["evaluation.tau_MA=None not in [0.4, 0.97]"]
    # Kather's bands have no pretrain entry; a missing stage reads None
    assert P.check_bands("kather", {"stages": {}}, enforce=True) == [
        "evaluation.accuracy=None not in [0.6, 0.99]", "evaluation.weighted_f1=None not in [0.6, 0.99]",
        "evaluation.ovr_auc=None not in [0.8, 0.999]"]


def test_partial_report_written_on_stage_abort(tmp_path, monkeypatch):
    """A mid-recipe abort still writes the report with the stage data so far
    and the platform ('cpu' under --device cpu), then re-raises."""

    def boom(args, W, report):
        report["stages"]["pretrain"] = {"seconds": 3.0, "val_acc": [0.16]}
        report["stages"]["data"] = {"seconds": 1.5}
        raise SystemExit("pretrain FAILED to learn (simulated)")

    _, out, ft, cr = P.RECIPES["camelyon16"]
    monkeypatch.setitem(P.RECIPES, "camelyon16", (boom, out, ft, cr))
    out_path = str(tmp_path / "reports" / "fail.json")
    with pytest.raises(SystemExit, match="simulated"):
        P.main(["--recipe", "camelyon16", "--out", out_path, "--workdir", str(tmp_path / "w"), "--device", "cpu"])
    with open(out_path) as f:
        d = json.load(f)
    assert d["failed"].startswith("SystemExit")
    assert d["stages"]["pretrain"]["val_acc"] == [0.16]
    assert d["total_seconds"] == 4.5 and d["platform"] == "cpu"
    assert "band_violations" not in d and "notes" not in d


def test_breastpathq_arrays_equal_the_h5_route(tmp_path):
    """``--bpq_data arrays`` builds, without a file, the datasets the h5
    route's loaders read back from the .h5 files, bit for bit, through the
    port's reader and the JAX package's: the arrays go through the reader's
    own conversion (float32 CHW in [0, 1] -> ``(x * 255).astype(uint8)``,
    which truncates, then the resize)."""
    size = 32
    arrays = P.breastpathq_arrays(n_train=10, n_eval=5, size=size, seed=3)
    P.make_breastpathq_h5(str(tmp_path / "t"), str(tmp_path / "a"), str(tmp_path / "b"), n_train=10, n_eval=5,
                          size=size, seed=3)
    train = TD.breastpathq_from_arrays(*arrays["train"], size)
    a = TD.breastpathq_from_arrays(*arrays["eval_a"], size)
    labels_b = TD.breastpathq_from_arrays(*arrays["eval_b"], size).labels
    for loader in (TD, JD):
        h5_train = loader.load_breastpathq_h5(str(tmp_path / "t"), size)
        h5_a, h5_labels_b = loader.load_breastpathq_eval_pair(str(tmp_path / "a"), str(tmp_path / "b"), size)
        for got, want in ((train, h5_train), (a, h5_a)):
            assert got.images.dtype == want.images.dtype == np.uint8
            assert got.labels.dtype == want.labels.dtype == np.float32
            np.testing.assert_array_equal(got.images, want.images)
            np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(labels_b, h5_labels_b)
    # with numpy's correctly rounded float32 division, v / 255 * 255
    # truncates back to v for every uint8 level v, so the round trip keeps
    # the generator's pixels
    levels = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal((levels.astype(np.float32) / 255.0 * 255).astype(np.uint8), levels)


def test_bpq_data_h5_without_h5py_exits_naming_the_flag(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(SystemExit, match="--bpq_data arrays"):
        P.main(["--recipe", "breastpathq", "--workdir", str(tmp_path / "w"), "--device", "cpu"])
    with open(tmp_path / "w" / "REHEARSAL_BREASTPATHQ.json") as f:
        d = json.load(f)
    assert "--bpq_data h5" in d["failed"] and d["stages"] == {}
    assert not os.path.exists(tmp_path / "w" / "bpq_train")


def test_evaluation_plots_recorded_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is missing (the card's machine), the evaluation's
    plot writers are swapped for recorders for the block and restored
    after; with it, nothing is swapped."""
    from ssl_cr_histo_tpu_torch.eval import reporting as RP

    real = RP.save_scatter_plot
    with P._plots_where_drawable() as not_drawn:
        assert RP.save_scatter_plot is real
    assert not_drawn == []
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with P._plots_where_drawable() as not_drawn:
        RP.save_scatter_plot(np.zeros(2), np.ones(2), "a", "b", str(tmp_path / "sc.png"))
        RP.save_confusion_matrix_plot(np.eye(2), ["n", "t"], str(tmp_path / "cm.png"))
    assert not_drawn == ["sc.png", "cm.png"] and RP.save_scatter_plot is real
    assert not os.path.exists(tmp_path / "sc.png")


def test_stage_cli_on_arrays_matches_its_main(tmp_path):
    """``_run_stage_cli`` with a loaded dataset makes the split, the
    labeled subsample and the ``run`` call the CLI's ``main`` makes from
    --train_path (recorded, not trained)."""
    from ssl_cr_histo_tpu_torch.cli import consistency, finetune

    arrays = P.breastpathq_arrays(n_train=20, n_eval=2, size=16, seed=1)
    P.make_breastpathq_h5(str(tmp_path / "t"), str(tmp_path / "a"), str(tmp_path / "b"), n_train=20, n_eval=2,
                          size=16, seed=1)
    data = TD.breastpathq_from_arrays(*arrays["train"], 16)
    for cli, stage in ((finetune, "finetune"), (consistency, "consistency")):
        calls = []
        real = cli.run
        cli.run = lambda *a: calls.append(a)
        try:
            argv = ["--task", "breastpathq", "--device", "cpu", "--image_size", "16", "--labeled_train", "0.5",
                    "--validation_split", "0.1", "--finetune_ckpt", "x.pth", "--save_dir", str(tmp_path / "s")]
            P._run_stage_cli(cli, stage, argv + ["--train_path", str(tmp_path / "t")])
            P._run_stage_cli(cli, stage, argv, data)
        finally:
            cli.run = real
        (h5_args, *h5_sets), (arr_args, *arr_sets) = calls
        assert len(h5_sets) == len(arr_sets) == (3 if stage == "finetune" else 4)
        assert h5_sets[0] == arr_sets[0]  # the task config
        for want, got in zip(h5_sets[1:], arr_sets[1:]):
            np.testing.assert_array_equal(got.images, want.images)
            np.testing.assert_array_equal(got.labels, want.labels)
        assert {k: v for k, v in vars(h5_args).items() if k != "train_path"} == \
            {k: v for k, v in vars(arr_args).items() if k != "train_path"}
