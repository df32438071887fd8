"""Whole runs of each cell's stage on the CPU at a small size (float32, the
kernels' plain versions), past the harness's look for a card: a sound run
comes out correct; with the timed path broken underneath (a step that
returns its state unchanged; half of the batch left out, the mean taken
over the rest), and with the control (``calibrate``'s float8 reference in
the program's place), ``correct`` comes out false.  On the card, the cell
itself once, at its own size.

    python3 -m pytest port_bench/tests -q
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from port_bench import compare, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SMALL = {"batch": 4, "tile": 32, "k": 4, "slides": 2, "slide_px": 512, "tissue": [64, 320], "trace_chunks": 1,
         "labeled": 2, "mu": 2, "size": 32, "distinct_steps": 4, "bf16": False}
SEED = 2**31 + 11


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def small_spec(bench, cell):
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        spec = run.resolve(bench, cell)
    finally:
        os.chdir(cwd)
    spec["traffic"].update({k: v for k, v in SMALL.items() if k in spec["traffic"] or k == "bf16"})
    return spec


def cpu_run(spec, root, trace=False):
    return run.run_cell(spec, SEED, 0.5, trace, torch.device("cpu"), str(root), time.time())


def unchanged_update(state, loss):
    """A step that returns its state unchanged: the gradients and the
    optimizer's step, then every parameter put back."""
    before = [p.detach().clone() for g in state.optimizer.param_groups for p in g["params"]]
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    with torch.no_grad():
        for p, b in zip((p for g in state.optimizer.param_groups for p in g["params"]), before):
            p.copy_(b)


def half_mean(logits, labels):
    """Half of the batch left out, the mean taken over the rest."""
    n = logits.shape[0] // 2
    return torch.nn.functional.cross_entropy(logits[:n].float(), labels[:n].long())


@pytest.mark.parametrize("cell", cells())
def test_sound_run_is_correct(bench, cell, tmp_path):
    out = cpu_run(small_spec(bench, cell), tmp_path, trace=True)
    assert out["correct"], out["rows"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"], out


def test_first_run_in_a_checkout_is_marked(bench, tmp_path):
    """The first run writes the slides into the benchmark's directory and
    says so; the second finds them, builds nothing and notes each step of
    its set-up."""
    spec = small_spec(bench, "pretrain.resnet18")
    first, second = cpu_run(spec, tmp_path / "port_bench"), cpu_run(spec, tmp_path / "port_bench")
    assert first["built"] == ["port_bench"] and second["built"] == []
    names = [name for name, _ in second["marks"]]
    assert names[0] == "start" and "tile cache" in names and "first chunk" in names
    times = [t for _, t in second["marks"]]
    assert times == sorted(times)


@pytest.mark.parametrize("fault", ["unchanged", "half"])
@pytest.mark.parametrize("cell", cells())
def test_broken_step_is_not_correct(bench, cell, fault, tmp_path, monkeypatch):
    from ssl_cr_histo_tpu_torch.parallel import steps as S

    if fault == "unchanged":
        monkeypatch.setattr(S, "_update", unchanged_update)
    else:
        monkeypatch.setattr(S, "cross_entropy", half_mean)
    out = cpu_run(small_spec(bench, cell), tmp_path)
    assert not out["correct"], out["rows"]


@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct(bench, cell, tmp_path):
    from port_bench import calibrate

    spec = small_spec(bench, cell)
    spec["traffic"]["bf16"] = True
    cls = __import__(f"port_bench.stages.{spec['traffic']['stage']}", fromlist=["Stage"]).Stage
    stage = cls(spec["cfg"], spec["traffic"], SEED, torch.device("cpu"), str(tmp_path))
    readings = calibrate.readings(stage, "control")
    ok, rows = compare.verdict({k: (v, "") for k, v in readings.items()}, spec["limits"])
    assert not ok, rows


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell runs at its own size")
    proc = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", cell, "--seed", str(SEED),
                           "--seconds", "5", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
