"""The port's bench tools (``ssl_cr_histo_tpu_torch/tools/{bench,bench_suite,
bench_scaling,reference_baseline}.py``) on the CPU, small: the regression
guard equal to the JAX suite's ``check_bands``, the committed artifact's
bands, each measurement at tiny sizes with the JAX tools' keys, the
configurations of record pinned against the JAX tools' lines, the
reference augmentation byte-equal to the JAX tool's, the scaling tool's
rows and exit code, and ``bench.main``'s one JSON line."""

import functools
import importlib
import json
import math
import os
import random
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ssl_cr_histo_tpu_torch.tools import bench as B
from ssl_cr_histo_tpu_torch.tools import bench_scaling as SC
from ssl_cr_histo_tpu_torch.tools import bench_suite as BS
from ssl_cr_histo_tpu_torch.tools import reference_baseline as R
from torch_tmp import tmp_path  # noqa: F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_KEYS = {"metric", "value", "unit", "ms_per_step", "config"}
TINY = dict(device="cpu", iters=1)


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


def jax_tool(name: str):
    """A JAX-side tool of ``tools/``, imported as ``tests/test_bench_suite.py``
    imports it."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


# ---------------------------------------------------------------------------
# the regression guard
# ---------------------------------------------------------------------------

COMMITTED = {"results": [
    {"metric": "rsp_pretrain_aug_patches_per_sec_per_chip", "value": 4000.0},
    {"metric": "finetune_step_samples_per_sec_per_chip", "value": 1800.0},
]}
FRESH = [
    {"metric": "rsp_pretrain_aug_patches_per_sec_per_chip", "value": 3400.0},
    {"metric": "finetune_step_samples_per_sec_per_chip", "value": 1710.0},
    {"metric": "brand_new_metric", "value": 1.0},
]


@pytest.mark.parametrize("results, committed, kw", [
    (FRESH, COMMITTED, {"tolerance": 0.10}),  # a 15% drop flagged, a 5% drop inside, a new metric never
    ([{"metric": "finetune_step_samples_per_sec_per_chip", "value": 2500.0}], COMMITTED, {}),  # an improvement
    (FRESH, None, {}),  # the first run
], ids=["throttled", "improved", "first_run"])
def test_check_bands_equals_the_jax_suite(results, committed, kw):
    """``tests/test_bench_suite.py``'s three cases."""
    want = jax_tool("bench_suite").check_bands(results, committed, **kw)
    assert BS.check_bands(results, committed, **kw) == want
    if committed is None:
        assert want == ([], {})


METRICS = st.sampled_from(["a", "b", "c", "rsp_pretrain_aug_patches_per_sec_per_chip"])
VALUES = st.floats(min_value=0.0, max_value=1e5, allow_nan=False)
RESULTS = st.lists(st.fixed_dictionaries({"metric": METRICS, "value": VALUES}), max_size=6)


@settings(max_examples=60, deadline=None)
@given(results=RESULTS, committed=st.one_of(st.none(), st.fixed_dictionaries({"results": RESULTS})),
       tolerance=st.floats(min_value=0.0, max_value=0.5))
def test_check_bands_equals_the_jax_suite_on_drawn_runs(results, committed, tolerance):
    want = jax_tool("bench_suite").check_bands(results, committed, tolerance)
    assert BS.check_bands(results, committed, tolerance) == want


def test_committed_artifact_carries_bands():
    """The port's artifact of record was measured on an NVIDIA card and
    records what it was guarded against, with no violation."""
    with open(B.SUITE) as f:
        report = json.load(f)
    assert report["violations"] == []
    assert report["bands"]["tolerance"] > 0
    assert "NVIDIA" in report["platform"]
    names = [r["metric"] for r in report["results"]]
    assert names == [m for m, _ in METRIC_OF_RECORD.values()]
    assert set(report["bands"]) - {"tolerance"} <= set(names)
    assert all(r["value"] > 0 and "NVIDIA" in r["platform"] for r in report["results"])


# ---------------------------------------------------------------------------
# each measurement, tiny, on the CPU
# ---------------------------------------------------------------------------

# the JAX tools' metric names and units (bench.py:99-101, tools/bench_suite.py:100-102, :143-145, :183-185)
METRIC_OF_RECORD = {
    "pretrain": ("rsp_pretrain_aug_patches_per_sec_per_chip", "patches/s/chip"),
    "consistency_fused": ("cr_step_samples_per_sec_per_chip_fused", "samples/s/chip"),
    "consistency_fast": ("cr_step_samples_per_sec_per_chip_fast", "samples/s/chip"),
    "finetune": ("finetune_step_samples_per_sec_per_chip", "samples/s/chip"),
    "serving": ("serving_eval_forward_patches_per_sec_per_chip", "patches/s/chip"),
}
TINY_CALLS = {
    "pretrain": lambda: B.measure_pretrain(**TINY, batch_size=2, tile=32, k_steps=2),
    "consistency_fused": lambda: BS.bench_consistency("fused", **TINY, b_l=2, mu=2, tile=32, k_steps=2),
    "consistency_fast": lambda: BS.bench_consistency("fast", **TINY, b_l=2, mu=2, tile=32, k_steps=2),
    "finetune": lambda: BS.bench_finetune(**TINY, b=2, size=32, k_steps=2),
    "serving": lambda: BS.bench_serving(**TINY, b=2, size=32),
}


@pytest.mark.parametrize("name", list(TINY_CALLS))
def test_each_measurement_returns_the_jax_keys(name):
    r = TINY_CALLS[name]()
    assert JAX_KEYS <= set(r)
    assert (r["metric"], r["unit"]) == METRIC_OF_RECORD[name]
    assert math.isfinite(r["value"]) and r["value"] > 0 and r["ms_per_step"] > 0
    assert r["platform"] == "cpu"
    assert r["launches"] == {"rsp_augment": 0, "photometric_chain": 0, "strong_views": 0}  # the CPU runs the plain versions


def test_scaling_measure_returns_the_jax_keys():
    r = SC.measure("resnet18", 2, k_steps=2, iters=1, tile=32, device="cpu")
    assert {"model", "batch", "ms_per_step", "patches_per_sec"} <= set(r)
    assert (r["model"], r["batch"]) == ("resnet18", 2)
    assert math.isfinite(r["patches_per_sec"]) and r["patches_per_sec"] > 0


def spy(monkeypatch, module, name: str, calls: list):
    real = getattr(module, name)

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        calls.append((a, kw, out))
        return out

    monkeypatch.setattr(module, name, wrapped)


def test_steps_and_optimizers_of_record(monkeypatch):
    """The steps each measurement builds and their optimizers: the pretrain
    step of ``bench.py:69-77`` (v1 pool, Pallas -> the fused kernel, joint
    encode, bf16, SGD-Nesterov 0.01 / 0.9 / 1e-4); the consistency step of
    ``tools/bench_suite.py:80-87`` (NAug 7, SGD-Nesterov 5e-4 / 1e-4, two
    classes); the fine-tune step of ``:126-132`` (Adam 1e-5, nine classes,
    the 3-view stack); the serving forward of ``:167-172`` (bf16)."""
    from ssl_cr_histo_tpu_torch.parallel import steps as S

    calls = {k: [] for k in ("pretrain", "consistency", "finetune", "forward")}
    spy(monkeypatch, S, "make_pretrain_multi_step", calls["pretrain"])
    spy(monkeypatch, S, "make_consistency_multi_step", calls["consistency"])
    spy(monkeypatch, S, "make_finetune_multi_step", calls["finetune"])
    spy(monkeypatch, S, "forward", calls["forward"])
    for name in TINY_CALLS:
        TINY_CALLS[name]()

    (a, kw, _), = calls["pretrain"]
    assert (a[2], kw) == (2, dict(augment="v1", aug_mode="fused", joint_encode=True, bf16=True))
    group = a[0].optimizer.param_groups[0]
    assert (type(a[0].optimizer).__name__, group["lr"], group["momentum"], group["nesterov"],
            group["weight_decay"]) == ("SGD", 0.01, 0.9, True, 1e-4)
    assert a[0].classifier.classifier[-1].out_features == 6

    assert [kw["aug_mode"] for _, kw, _ in calls["consistency"]] == ["fused", "fast"]
    for a, kw, _ in calls["consistency"]:
        assert (a[4], kw["n_aug"], kw["bf16"]) == ("classification", 7, True)
        group = a[0].optimizer.param_groups[0]
        assert (type(a[0].optimizer).__name__, group["lr"], group["nesterov"], group["weight_decay"]) == \
            ("SGD", 5e-4, True, 1e-4)
        assert a[0].head.classifier[0].out_features == 2

    (a, kw, _), = calls["finetune"]
    group = a[0].optimizer.param_groups[0]
    assert (type(a[0].optimizer).__name__, group["lr"], a[3], kw["bf16"]) == ("Adam", 1e-5, "classification", True)
    assert a[0].head.classifier[0].out_features == 9
    assert all(kw == {"bf16": True} for _, kw, _ in calls["forward"])


def sig(fn) -> dict:
    import inspect

    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


def test_defaults_are_the_jax_configurations_of_record():
    """Each default pinned as a literal beside the JAX tool's line that
    holds it; the port's device is the card."""
    # bench.py:45 (iters), :63-64 (batch, tile), :69 (resnet18), :73 (k_steps)
    assert sig(B.measure_pretrain) == dict(iters=3, device="cuda", model="resnet18", batch_size=64, tile=256,
                                           k_steps=8)
    # tools/bench_suite.py:60 (iters 20 single steps; here chunks of K = 8, cli/consistency.py:90), :73 (16, 7, 256)
    assert sig(BS.bench_consistency) == dict(iters=3, device="cuda", b_l=16, mu=7, tile=256, k_steps=8)
    # tools/bench_suite.py:108 (iters), :120 (64, 224, 8)
    assert sig(BS.bench_finetune) == dict(iters=3, device="cuda", b=64, size=224, k_steps=8)
    # tools/bench_suite.py:151 (iters), :164 (256, 256)
    assert sig(BS.bench_serving) == dict(iters=20, device="cuda", b=256, size=256)
    # tools/bench_scaling.py:20-21
    assert sig(SC.measure) == dict(k_steps=4, iters=3, tile=256, device="cuda")
    # tools/bench_scaling.py:55-61
    want = (("resnet18", 64), ("resnet18", 128), ("resnet18", 256), ("resnet50", 64), ("resnet50", 128))
    assert SC.CONFIGS == want == jax_tool("bench_scaling").CONFIGS
    # tools/measure_reference_baseline.py:130 (tile), :278 (triplets), :283 (workers)
    assert (R.S, R.TRIPLETS, R.WORKERS) == (256, 8, 8)
    assert B.SUITE.endswith(os.path.join("ssl_cr_histo_tpu_torch", "tools", "reports", "bench_suite.json"))
    assert R.OUT.endswith(os.path.join("ssl_cr_histo_tpu_torch", "tools", "reports", "baseline_local.json"))


@pytest.mark.parametrize("main", [B.main, BS.main, SC.main], ids=["bench", "bench_suite", "bench_scaling"])
def test_default_device_is_the_card(main, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(SC, "CONFIGS", ())  # the scaling tool's configs run in processes of their own
    argv = ["--one", "resnet18", "2"] if main is SC.main else ["--out", str(tmp_path / "s.json")] \
        if main is BS.main else []
    with pytest.raises(SystemExit, match="CUDA is not available"):
        main(argv)


# ---------------------------------------------------------------------------
# the reference augmentation baseline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_reference_augmentation_is_byte_equal_to_the_jax_tools(seed):
    J = jax_tool("measure_reference_baseline")
    rng = np.random.default_rng(0)
    tiles = [(rng.random((R.S, R.S, 3)) * 255).astype(np.uint8) for _ in range(3)]
    state = random.getstate(), np.random.get_state()
    try:
        outs = []
        for fn in (J.augment_triplet, R.augment_triplet):
            random.seed(seed)
            np.random.seed(seed)
            outs.append(fn([t.copy() for t in tiles]))
    finally:
        random.setstate(state[0])
        np.random.set_state(state[1])
    want, got = outs
    assert [t.shape for t in got] == [(R.S, R.S, 3)] * 3
    assert all(a.dtype == b.dtype == np.uint8 and np.array_equal(a, b) for a, b in zip(want, got))
    assert [op.__name__ for op in R.POOL] == [op.__name__ for op in J.POOL]


def test_reference_baseline_writes_its_report(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(R, "S", 32)
    monkeypatch.setattr(R, "TRIPLETS", 1)
    out = tmp_path / "reports" / "baseline.json"
    r = R.main(["--out", str(out)])
    with open(out) as f:
        assert json.load(f) == r
    assert r["reference_aug_patches_per_sec"] > 0 and r["assumed_workers"] == 8 and r["tile_size"] == 32
    assert r["host_cpu_count"] == os.cpu_count() and r["host_cpu"] and r["host_arch"]
    assert '"reference_aug_patches_per_sec"' in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the tools' command lines
# ---------------------------------------------------------------------------

ROW = re.compile(r"^resnet18 b=2: [0-9.]+ ms/step, [0-9]+ patches/s/chip$")


def test_scaling_one_prints_one_row():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "ssl_cr_histo_tpu_torch.tools.bench_scaling", "--one", "resnet18",
                          "2", "--device", "cpu", "--tile", "32"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert ROW.match(lines[-1]), lines
    r = json.loads(lines[-2])
    assert (r["model"], r["batch"], r["platform"]) == ("resnet18", 2, "cpu")


def test_scaling_main_exits_nonzero_on_a_failed_config(monkeypatch, capsys):
    """Each config in a process of its own; a FAILED row fails the run."""
    monkeypatch.setattr(SC, "CONFIGS", (("resnet18", 2), ("no_such_backbone", 2)))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(SystemExit, match=r"1 of 2 configs failed: \[\('no_such_backbone', 2\)\]"):
        SC.main(["--device", "cpu", "--tile", "32"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and ROW.match(lines[0]) and lines[1].startswith("no_such_backbone b=2: FAILED (")


def test_bench_main_prints_one_json_line(monkeypatch, tmp_path, capsys):
    """Without the baseline artifact no ``vs_baseline``; with it and the
    suite artifact, both ratios."""
    monkeypatch.setattr(B, "measure_pretrain", functools.partial(B.measure_pretrain, batch_size=2, tile=32,
                                                                 k_steps=2, iters=1))
    paths = ["--device", "cpu", "--baseline", str(tmp_path / "baseline.json"), "--suite", str(tmp_path / "suite.json")]
    B.main(paths)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu" and len(lines) == 2
    out = json.loads(lines[-1])
    assert set(out) == {"metric", "value", "unit"} and out["metric"] == METRIC_OF_RECORD["pretrain"][0]

    (tmp_path / "baseline.json").write_text(json.dumps({"reference_aug_patches_per_sec": 10.0}))
    (tmp_path / "suite.json").write_text(json.dumps({"results": [{"metric": out["metric"], "value": 20.0}]}))
    B.main(paths)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "vs_committed"}
    assert out["vs_baseline"] == round(out["value"] / 10.0, 2)
    assert out["vs_committed"] == round(out["value"] / 20.0, 3)


def test_suite_main_guards_against_its_committed_artifact(monkeypatch, tmp_path, capsys):
    """A first run writes the artifact with no bands; a run 15% slower on
    one metric fails and records the violation; ``--accept-regression``
    writes it and passes."""
    rate = {"v": 100.0}

    def fake(metric):
        return lambda *a, **kw: {"metric": metric, "value": rate["v"], "unit": "u", "ms_per_step": 1.0,
                                 "config": "c", "platform": "cpu", "launches": {}}

    monkeypatch.setattr(BS, "bench_pretrain", fake("p"))
    monkeypatch.setattr(BS, "bench_consistency", lambda mode, **kw: fake(f"cr_{mode}")())
    monkeypatch.setattr(BS, "bench_finetune", fake("f"))
    monkeypatch.setattr(BS, "bench_serving", fake("s"))
    out = str(tmp_path / "suite.json")
    first = BS.main(["--out", out, "--device", "cpu"])
    assert [r["metric"] for r in first["results"]] == ["p", "cr_fused", "cr_fast", "f", "s"]
    assert first["bands"] == {"tolerance": 0.1} and first["violations"] == [] and first["platform"] == "cpu"
    rate["v"] = 85.0
    with pytest.raises(SystemExit) as e:
        BS.main(["--out", out, "--device", "cpu"])
    assert e.value.code == 1
    with open(out) as f:
        report = json.load(f)
    assert len(report["violations"]) == 5 and report["violations"][0]["drop_pct"] == 15.0
    assert "REGRESSION" in capsys.readouterr().out
    assert BS.main(["--out", out, "--device", "cpu", "--tolerance", "0.2"])["violations"] == []
    rate["v"] = 50.0
    assert len(BS.main(["--out", out, "--device", "cpu", "--accept-regression"])["violations"]) == 5
