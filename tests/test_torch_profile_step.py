"""The port's step profiler (``ssl_cr_histo_tpu_torch/tools/profile_step.py``)
on the CPU: each stage at resnet18, 32^2, batch 2, one traced step writes a
``torch.profiler`` trace and reports ms/step and its top operations; the
pretrain step's trace holds the fused augmentation's plain path (the CPU
has no kernel) and no kernel launch; without --device the tool asks for
the card."""

import json
import os

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


def run(tmp_path, stage: str) -> dict:
    return P.main(["--stage", stage, "--model", "resnet18", "--image_size", "32", "--batch_size", "2",
                   "--mu", "2", "--steps", "1", "--device", "cpu", "--logdir", str(tmp_path / "trace")])


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
    assert f"traced 1 {stage} steps (" in printed and "ms/step" in printed and "[cpu]" in printed
    assert "top 10 operations by self CPU time:" in printed


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
