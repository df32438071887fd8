"""The port's step profiler (``ssl_cr_histo_tpu_torch/tools/profile_step.py``)
on the CPU: each stage at resnet18, 32^2, batch 2, one traced step of its
``StepGraph`` fed by the CLIs' feed writes a ``torch.profiler`` trace and
reports ms/step, its top operations, the feed's ``port.feed.wait`` span
and the step's and feed's counters; the pretrain step's trace holds the
fused augmentation's plain path (the CPU has no kernel) and no kernel
launch; without --device the tool asks for the card.  ``span_times``, the
spans' host time and the card's idle time inside them, against hand-made
traces and a brute-force count over a microsecond grid.  The card's
``port.step.prologue`` reading is in tests/test_torch_cuda_kernels.py."""

import json
import os

import numpy as np
import pytest
import torch

from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK
from ssl_cr_histo_tpu_torch.ops import rsp_augment_kernel as RK
from ssl_cr_histo_tpu_torch.tools import profile_step as P
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


def run(tmp_path, stage: str, *extra) -> dict:
    return P.main(["--stage", stage, "--model", "resnet18", "--image_size", "32", "--batch_size", "2",
                   "--mu", "2", "--steps", "1", "--device", "cpu", "--logdir", str(tmp_path / "trace"), *extra])


def trace_names(path: str) -> list:
    with open(path) as f:
        return [e.get("name", "") for e in json.load(f)["traceEvents"]]


@pytest.mark.parametrize("stage", ["pretrain", "finetune", "consistency"])
def test_each_stage_writes_a_trace(tmp_path, capsys, stage):
    out = run(tmp_path, stage)
    assert out["stage"] == stage and out["ms_per_step"] > 0
    assert os.path.dirname(out["trace"]) == str(tmp_path / "trace")
    names = trace_names(out["trace"])
    assert "aten::convolution_backward" in names and any(n.startswith("Optimizer.step") for n in names)
    assert len(out["top"]) == 10 and all(ms >= 0 and calls > 0 for _, calls, ms in out["top"])
    assert [r[2] for r in out["top"]] == sorted((r[2] for r in out["top"]), reverse=True)
    printed = capsys.readouterr().out
    assert f"traced 1 {stage} steps (" in printed and "ms/step at --multi_step 8" in printed and "[cpu]" in printed
    assert "top 10 operations by self CPU time:" in printed
    # the CPU's StepGraph is eager; one chunk of 8 fed the traced step
    assert out["multi_step"] == 8
    assert {key: out["counts"][key] for key in ("eager_steps", "replays", "captures")} == {
        "eager_steps": 1, "replays": 0, "captures": 0}
    assert set(out["feed"]) == {"starved", "starved_s", "read_s", "pin_s"}
    assert list(out["spans"]["spans"]) == ["port.feed.wait"]
    wait = out["spans"]["spans"]["port.feed.wait"]
    assert wait["calls"] == 1 and wait["host_ms"] >= 0 and wait["idle_ms"] is None
    assert out["spans"]["device_idle_share"] is None
    assert "port spans a step" in printed and "port.feed.wait" in printed and "traced steps: feed starved" in printed
    # the CPU's views are the kernel's plain version
    assert out["strong_views_launches"] == 0 and "; strong_views kernel 0 launches" in printed


def test_pretrain_trace_holds_the_plain_augmentation(tmp_path, monkeypatch):
    """The pretrain step reaches ``rsp_augment_plain`` on the CPU: the
    traced step holds its region (a ``record_function`` put around it
    here), once, and no kernel is launched or counted."""
    plain = RK.rsp_augment_plain

    def annotated(*a, **kw):
        with torch.profiler.record_function("rsp_augment_plain"):
            return plain(*a, **kw)

    monkeypatch.setattr(RK, "rsp_augment_plain", annotated)
    PK.launches = RK.launches = 0
    names = trace_names(run(tmp_path, "pretrain")["trace"])
    assert names.count("rsp_augment_plain") == 1
    assert not [n for n in names if "rsp_augment_kernel" in n or "photometric_chain_kernel" in n]
    assert PK.launches == RK.launches == 0


def test_default_device_is_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        P.main(["--logdir", str(tmp_path / "trace")])


def test_one_step_a_chunk_waits_a_chunk_a_step(tmp_path):
    """At ``--multi_step 1`` (the per-batch feed) each traced step waits
    once for its batch: three ``port.feed.wait`` spans in three steps."""
    out = run(tmp_path, "finetune", "--multi_step", "1", "--steps", "3")
    assert out["counts"]["eager_steps"] == 3 and out["spans"]["spans"]["port.feed.wait"]["calls"] == 3


def x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_span_times_of_a_hand_made_trace():
    """Two prologue spans, 0-40 and 100-140 us, over 2 steps in a 200 us
    window; the card busy 30-50 (a kernel), 45-60 (a copy) and 120-200:
    the card idles 30 of the first span and 20 of the second, 90 of the
    window.  Device-side annotations, other host ops and instant events
    count as neither span nor card work."""
    events = [
        x("port.step.prologue", "cpu_op", 0, 40), x("port.step.prologue", "cpu_op", 100, 40),
        x("port.feed.wait", "cpu_op", 60, 10),
        x("aten::bmm", "cpu_op", 5, 10), x("port.step.prologue", "gpu_user_annotation", 0, 200),
        x("k0", "kernel", 30, 20), x("Memcpy HtoD", "gpu_memcpy", 45, 15), x("k1", "kernel", 120, 80),
        {"ph": "i", "name": "port.mark", "cat": "cpu_op", "ts": 10},
    ]
    got = P.span_times(events, steps=2)
    assert got["window_ms"] == pytest.approx(0.2)
    assert got["device_idle_share"] == pytest.approx(90 / 200)
    assert list(got["spans"]) == ["port.feed.wait", "port.step.prologue"]
    pro = got["spans"]["port.step.prologue"]
    assert pro["calls"] == 2
    assert pro["host_ms"] == pytest.approx(80 / 1e3 / 2)
    assert pro["idle_ms"] == pytest.approx(50 / 1e3 / 2)
    assert pro["idle_share"] == pytest.approx(50 / 200)
    wait = got["spans"]["port.feed.wait"]
    assert wait["idle_ms"] == pytest.approx(10 / 1e3 / 2) and wait["idle_share"] == pytest.approx(10 / 200)


def test_span_times_with_no_card_work():
    """A CPU trace: host times, and no idle time where no card works."""
    got = P.span_times([x("port.feed.wait", "cpu_op", 3, 4), x("aten::add", "cpu_op", 0, 20)], steps=1)
    assert got["device_idle_share"] is None and got["window_ms"] == pytest.approx(0.02)
    assert got["spans"] == {"port.feed.wait": {"calls": 1, "host_ms": pytest.approx(0.004), "idle_ms": None,
                                               "idle_share": None}}
    assert P.span_times([], steps=1) == {"window_ms": 0.0, "device_idle_share": None, "spans": {}}


@pytest.mark.parametrize("seed", range(6))
def test_span_times_against_a_microsecond_grid(seed):
    """Random kernels, copies and spans (overlapping spans of one name
    too) on whole microseconds: each span's host time and the card's idle
    time inside it equal a count over the grid, and no span's idle share
    exceeds the card's."""
    rng = np.random.default_rng(seed)
    events = []
    for cat in ("kernel", "gpu_memcpy", "gpu_memset"):
        for _ in range(rng.integers(1, 12)):
            events.append(x(cat, cat, int(rng.integers(0, 400)), int(rng.integers(1, 60))))
    for name in ("port.a", "port.b"):
        for _ in range(rng.integers(1, 6)):
            events.append(x(name, "cpu_op", int(rng.integers(0, 400)), int(rng.integers(1, 80))))
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    grid = np.arange(lo, hi)
    busy = np.zeros(len(grid), bool)
    for e in events:
        if e["cat"] != "cpu_op":
            busy[e["ts"] - lo:e["ts"] + e["dur"] - lo] = True
    got = P.span_times(events, steps=4)
    assert got["device_idle_share"] == pytest.approx(1 - busy.mean())
    for name in ("port.a", "port.b"):
        inside = np.zeros(len(grid), bool)
        for e in events:
            if e["name"] == name:
                inside[e["ts"] - lo:e["ts"] + e["dur"] - lo] = True
        t = got["spans"][name]
        assert t["calls"] == sum(e["name"] == name for e in events)
        assert t["host_ms"] == pytest.approx(inside.sum() / 1e3 / 4)
        assert t["idle_ms"] == pytest.approx((inside & ~busy).sum() / 1e3 / 4)
        assert t["idle_share"] == pytest.approx((inside & ~busy).sum() / len(grid))
        assert t["idle_share"] <= got["device_idle_share"] + 1e-12
