"""The port's Camelyon16 rehearsal end to end on the CPU, through the port's
CLIs (pretrain -> fine-tune -> consistency -> evaluation -> heatmap ->
FROC) at 32^2: every stage's report keys, the bands recorded and not
enforced below the 256^2 config of record, the heatmap's and the FROC's
artifacts.  A file of its own, so that the test runner's ``--dist
loadfile`` spreads it apart from ``tests/test_torch_rehearsal.py``."""

import json
import math
import os

import numpy as np
import pytest
import torch

from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK
from ssl_cr_histo_tpu_torch.ops import rsp_augment_kernel as RK
from ssl_cr_histo_tpu_torch.tools import rehearsal as P
from torch_tmp import tmp_path  # noqa: F401  (a fixture)


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
def two_torch_threads():
    """The suite runs several files at once: two intra-op threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_camelyon16_recipe_end_to_end_on_cpu(tmp_path):
    W = str(tmp_path / "w")
    out = str(tmp_path / "report.json")
    PK.launches = RK.launches = 0
    report = P.main(["--device", "cpu", "--image_size", "32", "--pretrain_epochs", "1",
                     "--pretrain_steps_per_epoch", "2", "--finetune_epochs", "1", "--cr_epochs", "1",
                     "--n_patches_per_class", "64", "--workdir", W, "--out", out])
    # on the CPU the kernels' wrappers run their plain versions and count nothing
    assert PK.launches == RK.launches == 0
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(report))
    st = report["stages"]
    assert list(st) == ["data", "pretrain", "finetune", "consistency", "evaluation", "heatmap", "froc"]
    assert report["platform"] == "cpu" and report["config"]["device"] == "cpu"

    pre = st["pretrain"]
    # the steps the checkpoint counts: at 32^2 the slides hold more than 2 batches
    assert (pre["epochs"], pre["steps"], pre["steps_per_epoch_cap"], pre["batch"], pre["tile"]) == (1, 2, 2, 64, 32)
    assert len(pre["train_loss"]) == len(pre["val_loss"]) == len(pre["val_acc"]) == 1
    assert 0.0 <= pre["val_acc_best"] <= 1.0 and pre["aug_patches_per_sec_incl_io"] > 0
    assert pre["checkpoint"] == os.path.join(W, "stage1", "ckpt_1.pth") and os.path.isfile(pre["checkpoint"])

    ft = st["finetune"]
    assert ft["labeled_batch_per_step"] == 32 and len(ft["val_err"]) == 1 and ft["val_range"] == 0.0
    assert ft["checkpoint"] == os.path.join(W, "stage2", "final.pth") and os.path.isfile(ft["checkpoint"])
    cr = st["consistency"]
    assert (cr["labeled_batch_per_step"], cr["unlabeled_batch_per_step"]) == (16, 112)
    assert all(len(cr[k]) == 1 and math.isfinite(cr[k][0]) for k in ("train_loss", "sup_loss", "cons_loss"))
    assert cr["checkpoint"] == os.path.join(W, "stage3", "best.pth")

    ev = st["evaluation"]
    assert {"seconds", "auc", "accuracy", "weighted_f1"} <= set(ev)
    assert 0.0 <= ev["auc"] <= 1.0 and 0.0 <= ev["accuracy"] <= 1.0
    assert os.path.isfile(os.path.join(W, "stage3", "camelyon16_eval.json"))

    hm = st["heatmap"]
    assert hm["grid"] == [32, 32] and hm["slides"] == 2 and hm["patches"] == 2 * 22 * 22
    assert {"t1.npy", "t1.png", "t1_heatmap.png", "n1.npy", "n1.png", "n1_heatmap.png"} <= set(hm["artifacts"])
    probs = np.load(os.path.join(W, "probs", "t1.npy"))
    assert probs.shape == (32, 32) and ((probs >= 0) & (probs <= 1)).all()
    for k in ("tumor_region_mean_prob", "strong_lesion_mean_prob", "subtle_lesion_mean_prob",
              "normal_region_mean_prob", "normal_slide_mean_prob"):
        assert 0.0 <= hm[k] <= 1.0, k

    fr = st["froc"]
    assert fr["total_lesions"] == 2 and 0.0 <= fr["froc"] <= 1.0
    assert sorted(fr["sens_at_fp"], key=float) == ["0.25", "0.5", "1.0", "2.0", "4.0", "8.0"]
    with open(os.path.join(W, "froc.json")) as f:
        assert json.load(f)["froc"] == fr["froc"]

    # recorded at every size, enforced at 256^2 only
    assert report["expected_bands"] == {f"{s}.{k}": [lo, hi] for (s, k), (lo, hi) in P.BANDS["camelyon16"].items()}
    assert report["band_violations"] == []
