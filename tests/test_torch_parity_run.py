"""The port's label-efficiency protocol tool
(``ssl_cr_histo_tpu_torch/tools/parity_run.py``) against the JAX package's
(``tools/parity_run.py``, imported through ``sys.path`` as
``tests/test_parity_run.py`` does; the port may not): the table and the
dotted-path lookup byte for byte, the flags, every stage CLI's argv with
the CLIs recorded instead of run (equal but for ``--device`` and the port's
``.pth`` names), BreastPathQ's in-memory ``--bpq_data arrays`` route against
its .h5 route, the dryrun's data counts, and the dryrun end to end on the
CPU."""

import argparse
import json
import math
import os
import sys

import numpy as np
import pytest
import torch
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


sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import parity_run as J  # noqa: E402  (tools/ path injected above)

from ssl_cr_histo_tpu_torch.tools import parity_run as P
from ssl_cr_histo_tpu_torch.tools import rehearsal as R

BPQ_ROWS = [{
    "fraction": 0.1,
    "ssl": {"icc_MA.ICC2": 0.81, "icc_MB.ICC2": 0.78, "tau_MA": 0.70, "mse_MA": 0.012, "seconds": 10.0},
    "ssl_cr": {"icc_MA.ICC2": 0.85, "icc_MB.ICC2": 0.80, "tau_MA": 0.74, "mse_MA": 0.010, "seconds": 12.0},
}, {"fraction": 1.0, "ssl": {"tau_MA": 0.70}}]

TABLE_CASES = {
    "no_reference": ("breastpathq", BPQ_ROWS, None),
    "reference": ("breastpathq", BPQ_ROWS, {"0.1": {"ssl": {"icc_MA": {"ICC2": 0.84}, "tau_MA": 0.72},
                                                    "ssl_cr": {"icc_MA": {"ICC2": 0.87}}}}),
    "numeric_key": ("breastpathq", BPQ_ROWS, {"1.0": {"ssl": {"tau_MA": 0.75}}}),
    "missing_metrics": ("kather", [{"fraction": 0.25, "ssl": {"accuracy": 0.5}, "ssl_cr": {}},
                                   {"fraction": 0.5, "ssl": {"weighted_f1": None, "ovr_auc": 0.9}}],
                        {"0.25": {"ssl": {"accuracy": 0.6, "ovr_auc": None}}, "0.5": {}}),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_render_table_matches_the_original(case):
    task, rows, reference = TABLE_CASES[case]
    assert P.HEADLINE == J.HEADLINE
    assert P.render_table(task, rows, reference) == J.render_table(task, rows, reference)


def test_render_table_reference_columns_and_dig():
    """The cases above are not vacuous: reference columns with their
    deltas, the "1.0" key paired with fraction 1, the dotted lookup."""
    t = P.render_table(*TABLE_CASES["reference"])
    assert "ref_icc_MA.ICC2" in t and "max_abs_delta" in t and "0.0300" in t
    t = P.render_table(*TABLE_CASES["numeric_key"])
    assert "| 1 | SSL | — | — | 0.7 | — | — | — | 0.75 | — | 0.0500 |" in t
    for d, key in (({"icc_MA": {"ICC2": 0.5}}, "icc_MA.ICC2"), ({"icc_MA": {}}, "icc_MA.ICC2"),
                   ({"icc_MA": 0.5}, "icc_MA.ICC2"), ({"a": 1}, "a"), ({}, "a"), (None, "a")):
        assert P._dig(d, key) == J._dig(d, key)


def test_main_flags_and_defaults_match_the_original(tmp_path, monkeypatch):
    """Every flag of the original with its default, plus --device (cuda)
    and --bpq_data (h5)."""
    seen = {}

    def capture(mod):
        def run(args, frac, extra, *rest):
            seen[mod] = dict(vars(args))
            raise SystemExit("stop")
        return run

    argv = ["--task", "kather", "--pretrained", "p.pt", "--train_path", "t", "--test_path", "t",
            "--out", str(tmp_path / "out.json"), "--workdir", str(tmp_path / "w")]
    for mod in (J, P):
        monkeypatch.setattr(mod, "run_fraction", capture(mod))
        with pytest.raises(SystemExit, match="stop"):
            mod.main(argv)
    got = seen[P]
    assert got.pop("device") == "cuda" and got.pop("bpq_data") == "h5"
    assert got == seen[J]


@pytest.mark.parametrize("extra, message", [
    (["--task", "breastpathq", "--bpq_data", "arrays"], "dryrun's in-memory data"),
    (["--task", "kather", "--dryrun", "--bpq_data", "arrays"], "dryrun's in-memory data"),
    (["--task", "kather", "--pretrained", "DIR"], "convert_checkpoint"),
])
def test_main_rejects_arrays_outside_the_dryrun_and_a_directory(tmp_path, capsys, extra, message):
    """--bpq_data arrays only for the BreastPathQ dryrun; a directory as
    --pretrained points to the JAX package's converter."""
    argv = ["--pretrained", "p.pt", "--train_path", "t", "--test_path", "t", "--workdir", str(tmp_path / "w"),
            *[str(tmp_path) if a == "DIR" else a for a in extra]]
    with pytest.raises(SystemExit):
        P.main(argv)
    assert message in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "w")


def fake_eval(task: str) -> dict:
    """An evaluation report holding each headline metric."""
    return {"breastpathq": {"icc_MA": {"ICC2": 0.5}, "icc_MB": {"ICC2": 0.4}, "tau_MA": 0.3, "mse_MA": 0.1},
            "camelyon16": {"auc": 0.9, "accuracy": 0.8, "weighted_f1": 0.7},
            "kather": {"accuracy": 0.8, "weighted_f1": 0.7, "ovr_auc": 0.95}}[task]


def recorder(calls: list, name: str, best: str):
    """A stage CLI's ``main`` that records its argv; in --mode evaluation it
    writes a report holding each headline metric, in training it leaves
    ``best`` (a run's best checkpoint) in --save_dir when given."""
    def main(argv):
        calls.append((name, list(argv)))
        save_dir = argv[argv.index("--save_dir") + 1]
        os.makedirs(save_dir, exist_ok=True)
        if "evaluation" in argv:
            task = argv[argv.index("--task") + 1]
            with open(os.path.join(save_dir, f"{task}_eval.json"), "w") as f:
                json.dump(fake_eval(task), f)
        elif best == "best":
            os.makedirs(os.path.join(save_dir, "best"))
        elif best:
            open(os.path.join(save_dir, best), "w").close()
    return main


def port_to_original(argv: list) -> list:
    """A port argv as the JAX tool's would read: without --device, the
    .pth names without their suffix."""
    i = argv.index("--device")
    argv = argv[:i] + argv[i + 2:]
    return [a[:-len(".pth")] if a.endswith(".pth") else a for a in argv]


def record_both(tmp_path, monkeypatch, argv: list, best: bool) -> tuple:
    """Each tool's ``main(argv)`` with its stage CLIs recorded: ([(cli,
    argv)], report) for the JAX tool and the port."""
    from ssl_cr_histo_tpu.cli import consistency as jc, finetune as jf, pretrain as jp

    from ssl_cr_histo_tpu_torch.cli import consistency as pc, finetune as pf, pretrain as pp

    out = {}
    for mod, clis, best_name in ((J, (jp, jf, jc), "best"), (P, (pp, pf, pc), "best.pth")):
        calls = []
        for cli, name in zip(clis, ("pretrain", "finetune", "consistency"), strict=True):
            monkeypatch.setattr(cli, "main", recorder(calls, name, best_name if best else ""))
        extra = ["--device", "cpu"] if mod is P else []
        report = mod.main(argv + extra)
        out[mod] = (calls, report)
    return out[J], out[P]


ARGV_CASES = {
    "breastpathq": ["--task", "breastpathq", "--train_path", "TR", "--test_path", "TA"],
    "breastpathq_rater_b": ["--task", "breastpathq", "--train_path", "TR", "--test_path", "TA",
                            "--test_path_b", "TB", "--cr_epochs", "0", "--image_size", "64"],
    "camelyon16": ["--task", "camelyon16", "--train_path", "T,N", "--test_path", "VT,VN"],
    "camelyon16_json_val": ["--task", "camelyon16", "--train_path", "T,N", "--test_path", "VT,VN",
                            "--json_path", "J", "--val_path", "VT,VN", "--seed", "7"],
    "kather": ["--task", "kather", "--train_path", "K", "--test_path", "KT", "--eval_batch_size", "32"],
    "kather_val": ["--task", "kather", "--train_path", "K", "--test_path", "KT", "--val_path", "KV",
                   "--finetune_epochs", "3", "--cr_epochs", "2"],
}


@pytest.mark.parametrize("best", [True, False], ids=["best", "final"])
@pytest.mark.parametrize("case", sorted(ARGV_CASES))
def test_stage_argv_match_the_original(tmp_path, monkeypatch, case, best):
    """Both tools' stage CLIs recorded, not run: the same CLIs in the same
    order with the same argv, but for --device and the .pth names (the
    best checkpoint where the run wrote one, else the final one); the same
    rows and table."""
    argv = ARGV_CASES[case] + ["--pretrained", "/ckpts/rsp.pt", "--fractions", "0.1,1.0",
                               "--workdir", str(tmp_path / "w"), "--out", str(tmp_path / "out.json")]
    (jcalls, jreport), (pcalls, preport) = record_both(tmp_path, monkeypatch, argv, best)
    assert [c for c, _ in pcalls] == [c for c, _ in jcalls]
    assert len(jcalls) == (4 if case == "breastpathq_rater_b" else 8)  # --cr_epochs 0 skips CR and its eval
    for (_, want), (_, got) in zip(jcalls, pcalls, strict=True):
        assert got[got.index("--device") + 1] == "cpu"
        assert port_to_original(got) == want
    ckpts = [a for _, got in pcalls for a in got if a.endswith(".pth")]
    assert ckpts and all(os.path.basename(c) == ("best.pth" if best else "final.pth") for c in ckpts)
    strip = lambda rows: [{k: ({m: v for m, v in s.items() if m != "seconds"} if isinstance(s, dict) else s)
                           for k, s in r.items()} for r in rows]
    assert strip(preport["rows"]) == strip(jreport["rows"])
    assert preport["table"] == jreport["table"]
    with open(tmp_path / "out.json") as f:
        assert json.load(f)["table"] == preport["table"]


@pytest.mark.parametrize("task", ["breastpathq", "camelyon16", "kather"])
def test_dryrun_argv_match_the_original(tmp_path, monkeypatch, task):
    """The dryrun's stage-1 pretraining and every later stage CLI, recorded,
    against the JAX tool's at 32^2 and fraction 1: the same argv but for
    --device and ``ckpt_1.pth``.  Where the JAX tool's data counts give
    every stage a step (BreastPathQ, Kather) the data is its data, byte for
    byte."""
    argv = ["--task", task, "--dryrun", "--pretrained", "dryrun", "--train_path", "x", "--test_path", "x",
            "--fractions", "1.0", "--workdir", str(tmp_path / "w"), "--out", str(tmp_path / "out.json")]
    trees = {}
    real = {}
    for mod in (J, P):
        real[mod] = mod._setup_dryrun

    def snapshot(mod):
        def setup(args):
            out = real[mod](args)
            trees[mod] = data_tree(str(tmp_path / "w"))
            return out
        return setup

    monkeypatch.setattr(J, "_setup_dryrun", snapshot(J))
    monkeypatch.setattr(P, "_setup_dryrun", snapshot(P))
    (jcalls, _), (pcalls, _) = record_both(tmp_path, monkeypatch, argv, best=True)
    assert [c for c, _ in pcalls] == [c for c, _ in jcalls] == ["pretrain", "finetune", "finetune", "consistency",
                                                                 "finetune"]
    assert pcalls[0][1][-2:] == ["--device", "cpu"]
    for (_, want), (_, got) in zip(jcalls, pcalls, strict=True):
        assert port_to_original(got) == want
    assert pcalls[1][1][pcalls[1][1].index("--model_path") + 1].endswith(os.path.join("stage1", "ckpt_1.pth"))
    if task == "camelyon16":
        # 48 a pool give the consistency stage no step of 8 * mu 7 unlabeled patches: the port takes 56
        assert {k: len(v) for k, v in trees[J].items() if k.startswith("patches_")} == \
            {"patches_normal": 49, "patches_tumor": 49}  # each with its list.txt
        assert {k: len(v) for k, v in trees[P].items() if k.startswith("patches_")} == \
            {"patches_normal": 57, "patches_tumor": 57}
    else:
        assert trees[P] == trees[J]


def data_tree(root: str) -> dict:
    """{top-level dir under ``root``: {relative path: bytes}} of the
    dryrun's data (not its runs)."""
    out = {}
    for top in sorted(os.listdir(root)):
        if top == "stage1" or top.startswith("frac_") or not os.path.isdir(os.path.join(root, top)):
            continue
        files = {}
        for d, _, names in os.walk(os.path.join(root, top)):
            for n in names:
                with open(os.path.join(d, n), "rb") as f:
                    files[os.path.relpath(os.path.join(d, n), root)] = f.read()
        out[top] = files
    return out


@pytest.mark.parametrize("fractions", ["1.0", "0.5", "0.25,1.0", "0.1,0.25,0.5,1.0", "0.05"])
def test_dryrun_counts_give_every_stage_a_step(tmp_path, monkeypatch, fractions):
    """The dryrun's counts are the JAX tool's, raised to the least count
    whose smallest labeled fraction fills a fine-tune batch of the task's
    config of record (after the 20% validation hold-out) and whose
    Camelyon16 pools fill a consistency step's unlabeled patches."""
    from ssl_cr_histo_tpu_torch.cli.common import TASKS

    seen = {}
    monkeypatch.setattr(R, "make_breastpathq_h5", lambda *a, **kw: seen.update(breastpathq=a[3]))
    monkeypatch.setattr(R, "make_kather_folder", lambda *a, **kw: seen.update(kather=kw["n_per_class"]))
    monkeypatch.setattr(R, "make_camelyon_patches", lambda *a, **kw: (seen.update(camelyon16=kw["n_per_class"]),
                                                                       ("T,N", "VT,VN"))[1])
    f = min(float(x) for x in fractions.split(","))
    train = lambda n: n - int(np.floor(0.2 * n))
    rows = {"breastpathq": train, "kather": lambda n: train(9 * n), "camelyon16": lambda n: n}
    jax_counts = {"breastpathq": 240, "kather": 24, "camelyon16": 48}
    for task in rows:
        args = argparse.Namespace(task=task, image_size=16, workdir=str(tmp_path), fractions=fractions,
                                  pretrained="p.pth", bpq_data="h5", train_path="x", test_path="x",
                                  test_path_b="", val_path="", json_path="")
        assert P._setup_dryrun(args) == (None, None)
        least = jax_counts[task]
        while int(f * rows[task](least)) < TASKS[task].batch_size:
            least += 1
        if task == "camelyon16":
            least = max(least, TASKS[task].cr_batch * 7)
        assert seen[task] == least


def test_bpq_arrays_route_matches_the_h5_route(tmp_path, monkeypatch):
    """``--bpq_data arrays`` hands the fine-tune and consistency runs and
    the evaluation the datasets the .h5 files give, with the same parsed
    flags but the paths (recorded, not trained)."""
    from ssl_cr_histo_tpu_torch.cli import consistency, finetune

    runs = {}

    def record(route, name):
        def run(args, cfg, *sets):
            runs[route].append((name, vars(args), cfg, sets))
        return run

    def evaluate(route):
        def ev(args, cfg, ckpt, test=None):
            test = test if test is not None else finetune.load_test_set(args, cfg)
            runs[route].append(("evaluate", vars(args), cfg, (test[0], test[1], ckpt)))
            os.makedirs(args.save_dir, exist_ok=True)
            with open(os.path.join(args.save_dir, "breastpathq_eval.json"), "w") as f:
                json.dump(fake_eval("breastpathq"), f)
        return ev

    for route in ("h5", "arrays"):
        runs[route] = []
        monkeypatch.setattr(finetune, "run", record(route, "finetune"))
        monkeypatch.setattr(consistency, "run", record(route, "consistency"))
        monkeypatch.setattr(finetune, "evaluate", evaluate(route))
        P.main(["--task", "breastpathq", "--dryrun", "--pretrained", str(tmp_path / "rsp.pth"),
                "--train_path", "x", "--test_path", "x", "--image_size", "16", "--fractions", "0.5",
                "--bpq_data", route, "--device", "cpu", "--workdir", str(tmp_path / route),
                "--out", str(tmp_path / f"{route}.json")])
    assert [r[0] for r in runs["arrays"]] == [r[0] for r in runs["h5"]] == ["finetune", "evaluate", "consistency",
                                                                           "evaluate"]
    paths = ("train_path", "test_path", "test_path_b", "save_dir", "finetune_ckpt")
    for (_, a_args, a_cfg, a_sets), (_, h_args, h_cfg, h_sets) in zip(runs["arrays"], runs["h5"], strict=True):
        assert a_cfg == h_cfg
        assert a_args["train_path"] == a_args["test_path"] == a_args["test_path_b"] == ""
        assert {k: v for k, v in a_args.items() if k not in paths} == \
            {k: v for k, v in h_args.items() if k not in paths}
        for a, h in zip(a_sets, h_sets, strict=True):
            if isinstance(a, str):
                assert os.path.relpath(a, str(tmp_path / "arrays")) == os.path.relpath(h, str(tmp_path / "h5"))
            elif isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, h)
            else:
                assert len(a) == len(h) > 0
                np.testing.assert_array_equal(a.images, h.images)
                np.testing.assert_array_equal(a.labels, h.labels)


@pytest.fixture
def two_torch_threads():
    """The suite runs several files at once: two intra-op threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def check_report(report: dict, task: str, fractions: list) -> None:
    assert [r["fraction"] for r in report["rows"]] == fractions
    for row in report["rows"]:
        for stage in ("ssl", "ssl_cr"):
            for m in P.HEADLINE[task]:
                v = row[stage][m]
                assert isinstance(v, float) and math.isfinite(v), (row["fraction"], stage, m, v)
            assert row[stage]["seconds"] >= 0
    lines = report["table"].splitlines()
    assert lines[0] == "| " + " | ".join(["fraction", "stage", *P.HEADLINE[task]]) + " |"
    assert len(lines) == 2 + 2 * len(fractions) and "—" not in report["table"]


def test_dryrun_end_to_end_on_cpu(tmp_path, two_torch_threads):
    """The dryrun is the tool's self-test: Kather at 32^2 and the
    protocol's smallest fraction (its data raised to 89 images a class so
    that 10% fills a batch of 64), one epoch a stage, strict
    --reference_exact, on the CPU."""
    out = tmp_path / "PARITY_RUN.json"
    report = P.main(["--task", "kather", "--dryrun", "--pretrained", "dryrun", "--train_path", "x",
                     "--test_path", "x", "--image_size", "32", "--fractions", "0.1", "--finetune_epochs", "1",
                     "--cr_epochs", "1", "--device", "cpu", "--workdir", str(tmp_path / "w"), "--out", str(out)])
    check_report(report, "kather", [0.1])
    assert len(os.listdir(tmp_path / "w" / "kather" / "ADI")) == 89
    assert os.path.isfile(tmp_path / "w" / "stage1" / "ckpt_1.pth")
    assert report["config"]["pretrained"] == str(tmp_path / "w" / "stage1" / "ckpt_1.pth")
    assert json.loads(out.read_text())["table"] == report["table"]


@pytest.mark.slow
@pytest.mark.parametrize("task, extra", [("breastpathq", ["--bpq_data", "arrays"]), ("breastpathq", []),
                                         ("camelyon16", []), ("kather", [])])
def test_full_dryrun_on_cpu(tmp_path, two_torch_threads, task, extra):
    """Each task's dryrun at 32^2 over the protocol's smallest and largest
    fractions, one epoch a stage."""
    report = P.main(["--task", task, "--dryrun", "--pretrained", "dryrun", "--train_path", "x", "--test_path", "x",
                     "--image_size", "32", "--fractions", "0.1,1.0", "--finetune_epochs", "1", "--cr_epochs", "1",
                     "--device", "cpu", "--workdir", str(tmp_path / "w"), "--out", str(tmp_path / "out.json"),
                     *extra])
    check_report(report, task, [0.1, 1.0])
