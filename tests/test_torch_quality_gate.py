"""The port's label-efficiency gate (``ssl_cr_histo_tpu_torch/tools/
quality_gate.py``) against the JAX package's test of the same claim
(``tests/test_quality_gate.py``): its data byte for byte against the
``gate_data`` fixture's code rebuilt on the JAX package's
``synthetic_wsi``, its stage argv and thresholds against the JAX test's own
functions run with the stage CLIs recorded (no training), and both gates
on the CPU in the slow tier, as the JAX test's are."""

import importlib.util
import os

import cv2
import numpy as np
import pytest

from ssl_cr_histo_tpu_torch.tools import quality_gate as Q

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_gate_module():
    """``tests/test_quality_gate.py`` as a module of its own name (its test
    functions are plain functions of the fixture's root)."""
    spec = importlib.util.spec_from_file_location("jax_quality_gate", os.path.join(REPO, "tests",
                                                                                   "test_quality_gate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fixture_files(root) -> None:
    """The ``gate_data`` fixture's body (``tests/test_quality_gate.py:43-75``)
    on the JAX package's ``synthetic_wsi``, writing under ``root``."""
    from ssl_cr_histo_tpu.data.wsi import synthetic_wsi

    wsi_dir = root / "wsis"
    os.makedirs(wsi_dir)
    for i in range(3):
        np.save(wsi_dir / f"s{i}.npy", synthetic_wsi(1024, 1024, seed=i)._levels[0])

    rng = np.random.default_rng(99)

    def make_scale_folder(split_seed, n_per_class, out_dir):
        pyr = synthetic_wsi(1024, 1024, seed=split_seed)
        lvl0 = pyr._levels[0]
        for cls, span in (("ADI", 32), ("TUM", 128)):
            d = out_dir / cls
            os.makedirs(d)
            k = 0
            while k < n_per_class:
                yx = rng.integers(0, 1024 - span, 2)
                p = lvl0[yx[0] : yx[0] + span, yx[1] : yx[1] + span]
                if p.std() < 8:  # skip background-only crops
                    continue
                if span != 32:
                    p = cv2.resize(p, (32, 32), interpolation=cv2.INTER_AREA)
                cv2.imwrite(str(d / f"p{k}.tif"), p[:, :, ::-1])
                k += 1

    make_scale_folder(10, 80, root / "train_scale")
    make_scale_folder(11, 24, root / "test_scale")


def tree_bytes(root) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_gate_data_matches_the_fixture(tmp_path):
    """File for file the bytes the JAX test's fixture writes: three .npy
    slides, 2 x 80 train and 2 x 24 test .tif crops."""
    fixture_files(tmp_path / "jax")
    assert Q.make_gate_data(str(tmp_path / "port")) == str(tmp_path / "port")
    want, got = tree_bytes(tmp_path / "jax"), tree_bytes(tmp_path / "port")
    assert len(want) == 3 + 2 * 80 + 2 * 24
    assert sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []


# Each stage's result, by the run's --save_dir basename; a scenario
# overrides some of them and names the verdicts (main gate, aug-on gate).
PASSING = {"stage1": 0.5, "ft_scratch": 0.7, "ft_pre": 0.95, "cr": 0.9, "stage1_aug": 0.5, "ft_aug": 0.9}
SCENARIOS = {
    "pass": ({}, ["pass", "pass"]),
    "pretext_at_threshold": ({"stage1": 0.30}, ["fail", "pass"]),
    "scratch_at_threshold": ({"ft_scratch": 0.5}, ["fail", "pass"]),
    "pretrained_below": ({"ft_pre": 0.849}, ["fail", "pass"]),
    "pretrained_at_threshold": ({"ft_pre": 0.85, "ft_scratch": 0.6}, ["pass", "pass"]),
    "gap_below": ({"ft_pre": 0.88, "ft_scratch": 0.79}, ["fail", "pass"]),
    "gap_at_threshold": ({"ft_pre": 0.85, "ft_scratch": 0.75}, ["pass", "pass"]),
    "cr_below": ({"cr": 0.79}, ["fail", "pass"]),
    "cr_at_threshold": ({"cr": 0.8}, ["pass", "pass"]),
    "aug_pretext_at_threshold": ({"stage1_aug": 0.30}, ["pass", "fail"]),
    "aug_transfer_below": ({"ft_aug": 0.79}, ["pass", "fail"]),
    "aug_transfer_at_threshold": ({"ft_aug": 0.80}, ["pass", "pass"]),
}


def fake_clis(monkeypatch, modules: tuple, results: dict, calls: list) -> None:
    """Each stage CLI's ``main`` records its argv and writes the result the
    gate reads: a pretraining's CSV whose last field is its val acc, an
    evaluation's ``kather_eval.json``."""
    import json

    def make(name):
        def main(argv):
            argv = [str(a) for a in argv]
            calls.append((name, argv))
            save_dir = argv[argv.index("--save_dir") + 1]
            os.makedirs(save_dir, exist_ok=True)
            tag = os.path.basename(save_dir)
            if name == "pretrain":
                with open(os.path.join(save_dir, "train_results.csv"), "w") as f:
                    f.write(f"epoch, train_loss, train_acc, val_loss, val_acc\n1,1.0,0.5,1.0,{results[tag]}\n")
            elif "evaluation" in argv:
                with open(os.path.join(save_dir, "kather_eval.json"), "w") as f:
                    json.dump({"accuracy": results[tag]}, f)
        return main

    for mod, name in zip(modules, ("pretrain", "finetune", "consistency"), strict=True):
        monkeypatch.setattr(mod, "main", make(name))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_gate_argv_and_thresholds_match_the_jax_test(tmp_path, monkeypatch, scenario):
    """The JAX test's two gate functions and the port's, each over its
    package's stage CLIs recorded with the same results: the same CLIs
    with the same argv but for --device and the .pth names, and the same
    verdict, stopping at the same gate.  The scenarios put results on and
    just past each threshold."""
    from ssl_cr_histo_tpu.cli import consistency as jc, finetune as jf, pretrain as jp

    from ssl_cr_histo_tpu_torch.cli import consistency as pc, finetune as pf, pretrain as pp

    overrides, verdicts_want = SCENARIOS[scenario]
    results = {**PASSING, **overrides}
    jt = jax_gate_module()
    seen = {}
    for side, modules, gates in (("jax", (jp, jf, jc), (jt.test_label_efficiency_pretrain_finetune_cr,
                                                        jt.test_aug_on_pretrain_gate)),
                                 ("port", (pp, pf, pc), (Q.main_gate, Q.aug_gate))):
        root = tmp_path / side
        os.makedirs(root)
        calls, verdicts = [], []
        fake_clis(monkeypatch, modules, results, calls)
        for gate in gates:
            try:
                gate(root) if side == "jax" else gate(str(root), "cpu")
                verdicts.append("pass")
            except AssertionError as exc:
                verdicts.append("fail")
                if side == "port":
                    assert isinstance(exc, Q.GateFailed) and str(exc).split(":")[0] in {
                        "pretext", "scratch", "pretrained", "label-efficiency", "cr", "aug-pretext",
                        "aug-transfer"}
        seen[side] = (calls, verdicts)
    (jcalls, jverdicts), (pcalls, pverdicts) = seen["jax"], seen["port"]
    assert pverdicts == jverdicts == verdicts_want
    assert [c for c, _ in pcalls] == [c for c, _ in jcalls]
    for (_, want), (_, got) in zip(jcalls, pcalls, strict=True):
        i = got.index("--device")
        assert got[i + 1] == "cpu"
        got = [a.replace(str(tmp_path / "port"), str(tmp_path / "jax")) for a in got[:i] + got[i + 2:]]
        assert [a[:-len(".pth")] if a.endswith(".pth") else a for a in got] == want


def test_main_names_the_failed_gate_and_defaults_to_cuda(tmp_path, monkeypatch):
    """``main`` runs both gates on --device (default cuda) and turns a
    missed threshold into SystemExit naming its gate."""
    seen = []
    monkeypatch.setattr(Q, "make_gate_data", lambda root: os.makedirs(root))
    monkeypatch.setattr(Q, "main_gate", lambda root, device: seen.append(device) or {"cr": 1.0})

    def failing(root, device):
        seen.append(device)
        raise Q.GateFailed("aug-transfer: aug-pretrained transfer too weak: 0.5")

    monkeypatch.setattr(Q, "aug_gate", failing)
    with pytest.raises(SystemExit, match="quality gate FAILED: aug-transfer"):
        Q.main(["--workdir", str(tmp_path / "w")])
    assert seen == ["cuda", "cuda"]


@pytest.fixture(scope="module")
def gate_root(tmp_path_factory):
    return Q.make_gate_data(str(tmp_path_factory.mktemp("quality_gate")))


@pytest.mark.slow
def test_main_gate_on_cpu(gate_root):
    """The main gate through the port's CLIs on the CPU, every threshold
    enforced (~1.5 min)."""
    acc = Q.main_gate(gate_root, "cpu")
    assert set(acc) == {"pretext_val_acc", "scratch", "pretrained", "cr"}


@pytest.mark.slow
def test_aug_on_gate_on_cpu(gate_root):
    """The aug-on gate through the port's CLIs on the CPU (~20 s)."""
    acc = Q.aug_gate(gate_root, "cpu")
    assert set(acc) == {"pretext_val_acc", "transfer"}
