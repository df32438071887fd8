"""The ViT family (``port_bench/reference/vit.py``) and the UNI2-h cell.

The family module's forward is held to the port's test reference
(``tests/torch_vit_reference.py``) at a tiny shape, so the two copies
cannot drift apart; its counts and spec to hand counts, torch's FLOP
counter and the port's model at the published widths (on the meta
device); the cell's FLOPs a step are frozen; ``attention_roofline``'s
reader runs on a made-up trace.  Whole runs of the cell's stage at the
tiny shape on the CPU (the port's ViT registered under the name
``vit_tiny``) come out correct, and not correct with the step broken
(state unchanged; half of the batch left out) or with the control in the
program's place, under the cell's own limits.

    python3 -m pytest port_bench/tests/test_port_bench_vit.py -q
"""

import json
import math
import os
import sys
import time

import pytest
import torch

from port_bench import calibrate, compare, run, weights, yardstick
from port_bench.metrics import attention_roofline
from port_bench.reference import nets, vit

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "finetune.uni2h.kather"
FLOPS = 106787995066368  # 96 views x 1,112,374,948,608
TINY = {"img_size": 56, "embed_dim": 64, "depth": 2, "num_heads": 4, "head_dim": 16, "mlp_ratio": 4.0,
        "mlp_hidden": 256, "pair_fc": [128, 32, 16], "program_model": "vit_tiny"}
SMALL = {"batch": 4, "k": 4, "distinct_steps": 4, "size": 56, "trace_chunks": 1, "bf16": False}
SEED = 2**31 + 11


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def load(kind, name):
    with open(os.path.join(ROOT, "port_bench", kind, f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture
def tiny_cfg():
    return dict(load("configs", "uni2h"), **TINY)


@pytest.fixture
def reference_module():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        import torch_vit_reference
    finally:
        sys.path.remove(os.path.join(ROOT, "tests"))
    return torch_vit_reference


def test_family_forward_matches_the_test_reference(tiny_cfg, reference_module):
    """Both plain forwards in float64 at the tiny shape, with every LayerNorm
    and LayerScale off its seeded value: rounding apart (~1e-15), equal.
    With gradients on, the family recomputes each block in the backward
    pass; the features and the gradients are those without it."""
    p = weights.make_weights(nets.param_spec(tiny_cfg), 3, "cpu")
    g = torch.Generator().manual_seed(4)
    p = {k: (v + 0.05 * torch.randn(v.shape, generator=g)).double() for k, v in p.items()}
    x = torch.rand(3, 3, 56, 56, generator=g, dtype=torch.float64)
    want = reference_module.forward({k.removeprefix("net.model."): v for k, v in p.items()}, x, tiny_cfg)
    with torch.no_grad():
        got = vit.backbone(tiny_cfg, p, x, True, lambda t: t)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    leaves = {k: v.requires_grad_(True) for k, v in p.items() if k.startswith("net.model.")}
    recomputed = torch.autograd.grad(vit.backbone(tiny_cfg, p, x, True, lambda t: t).square().sum(),
                                     list(leaves.values()))
    kept = torch.autograd.grad(reference_module.forward({k.removeprefix("net.model."): v for k, v in p.items()},
                                                        x, tiny_cfg).square().sum(), list(leaves.values()))
    for k, a, b in zip(leaves, recomputed, kept):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12 * max(1.0, float(b.abs().max())), msg=k)


def test_spec_is_the_ports_model_at_published_widths():
    """Names and shapes in the port's order (the TripletNet on the meta
    device), 681,394,176 backbone tensors, and the weight kinds the
    configuration assumes."""
    from ssl_cr_histo_tpu_torch.models import TripletNet

    cfg = load("configs", "uni2h")
    spec = [e for e in nets.param_spec(cfg, head_classes=9) if e[0].startswith("net.")]
    with torch.device("meta"):
        net = TripletNet(cfg["program_model"])
    assert [(e[0], tuple(e[1])) for e in spec] == [(f"net.{k}", tuple(v.shape)) for k, v in net.named_parameters()]
    assert sum(math.prod(e[1]) for e in spec if e[0].startswith("net.model.")) == 681_394_176
    kinds = {e[0].split(".")[-1] + ":" + e[2] for e in spec if e[0].startswith("net.model.")}
    assert kinds == {"cls_token:normal", "reg_token:normal", "pos_embed:normal", "weight:conv", "bias:bias",
                     "weight:fill", "weight:linear", "gamma:fill"}
    fills = {e[3] for e in spec if e[2] == "fill" and e[0].endswith("gamma")}
    assert fills == {0.1} and {e[3] for e in spec if e[2] == "normal"} == {0.02}


def test_macs_by_hand_and_by_torch(tiny_cfg):
    """UNI2-h at 224^2: 256 patches of 14x14x3 -> 1536; 265 tokens; a
    block's qkv, proj, fc1 and fc2 on each token, QK^T and PV over 265^2
    pairs of 1536; and the tiny shape's count is what torch's FLOP counter
    sees, halved."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = load("configs", "uni2h")
    first = 256 * 1536 * 588
    block = 265 * 1536 * (4608 + 1536 + 8192 + 4096) + 2 * 265 * 265 * 1536
    assert vit.backbone_macs(cfg, 224) == (first + 24 * block, first) == (185470230528, 231211008)
    with pytest.raises(ValueError, match="224\\^2"):
        vit.backbone_macs(cfg, 256)
    p = weights.make_weights(nets.param_spec(tiny_cfg), 0, "cpu")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        vit.backbone(tiny_cfg, p, torch.rand(1, 3, 56, 56), False, lambda t: t)
    assert counter.get_total_flops() == 2 * yardstick.backbone_macs(tiny_cfg, 56)[0]


def test_cell_flops_per_step_frozen():
    cfg, tr = load("configs", "uni2h"), load("mixes", "finetune_b32")
    assert yardstick.finetune_step_flops(cfg, 3 * tr["batch"], tr["size"], tr["classes"]) == FLOPS
    assert FLOPS / 96 == 1112374948608


def test_attention_roofline_reader():
    """14 V H T^2 d over the bf16 peak, over the flash kernels' time per
    forward launch; None without one, or off the ViT."""
    cfg, tr = load("configs", "uni2h"), load("mixes", "finetune_b32")
    fwd, bwd = vit.attention_flops(cfg, 96)
    assert (fwd, bwd) == (4 * 96 * 24 * 265**2 * 64, 10 * 96 * 24 * 265**2 * 64)
    names = {"pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, 128, 64": (0.0096, 48),
             "pytorch_flash::flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel<Flash_bwd": (0.024, 48),
             "pytorch_flash::flash_bwd_dot_do_o_kernel<true, Flash_bwd_kernel_traits": (0.0024, 48),
             "pytorch_flash::flash_bwd_convert_dq_kernel<Flash_bwd_kernel_traits<64,": (0.0012, 48),
             "nvjet_tst_256x128_64x4_1x2_h_bz_coopB_TNT": (0.9, 192)}
    trace = {"kernel_s": {k: s for k, (s, _) in names.items()}, "kernel_count": {k: n for k, (_, n) in names.items()}}
    ctx = {"stage": "finetune", "cfg": cfg, "traffic": tr, "trace": trace}
    per_block = (0.0096 + 0.024 + 0.0024 + 0.0012) / 48
    assert attention_roofline.read(ctx) == pytest.approx(100 * (fwd + bwd) / yardstick.BF16_FLOPS / per_block)
    assert 0 < attention_roofline.read(ctx) <= 100
    assert attention_roofline.read(dict(ctx, trace=None)) is None
    assert attention_roofline.read(dict(ctx, cfg=load("configs", "resnet18"))) is None
    no_fwd = {k: v for k, v in trace["kernel_s"].items() if "fwd" not in k}
    assert attention_roofline.read(dict(ctx, trace={"kernel_s": no_fwd, "kernel_count": trace["kernel_count"]})) is None


# ---------------------------------------------------------------------------
# Whole runs of the cell's stage at the tiny shape on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny_spec(tiny_cfg, monkeypatch):
    """The cell as ``run.resolve`` finds it, at the tiny shape; the port's
    ViT at that shape registered as ``vit_tiny``."""
    from ssl_cr_histo_tpu_torch.models import nets as port_nets
    from ssl_cr_histo_tpu_torch.models import vit as port_vit

    monkeypatch.setitem(port_vit.CONFIGS, "vit_tiny", dict(
        img_size=56, patch_size=14, embed_dim=64, depth=2, num_heads=4, mlp_ratio=4.0, reg_tokens=8,
        init_values=1e-5))
    monkeypatch.setitem(port_nets._FC_DIMS, "vit_tiny", tuple(TINY["pair_fc"]))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    monkeypatch.chdir(ROOT)
    spec = run.resolve(bench, CELL)
    spec["cfg"] = tiny_cfg
    spec["traffic"].update(SMALL)
    return spec


def cpu_run(spec, root, trace=False):
    return run.run_cell(spec, SEED, 0.5, trace, torch.device("cpu"), str(root), time.time())


def test_sound_run_is_correct(tiny_spec, tmp_path):
    out = cpu_run(tiny_spec, tmp_path, trace=True)
    assert out["correct"], out["rows"]
    assert out["attempted"] > 0 and out["failed"] == 0
    # a traced run reads the per-layer metrics; the CPU has no flash kernel
    assert {"mfu.finetune", "idle_share.finetune"} <= set(out["metrics"])
    assert "attention_roofline" not in out["metrics"]


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_broken_step_is_not_correct(tiny_spec, fault, tmp_path, monkeypatch):
    from ssl_cr_histo_tpu_torch.parallel import steps as S

    from port_bench.tests.test_port_bench_runs import half_mean, unchanged_update

    if fault == "unchanged":
        monkeypatch.setattr(S, "_update", unchanged_update)
    else:
        monkeypatch.setattr(S, "cross_entropy", half_mean)
    out = cpu_run(tiny_spec, tmp_path)
    assert not out["correct"], out["rows"]


def test_control_is_not_correct(tiny_spec, tmp_path):
    from port_bench.stages.finetune import Stage

    tiny_spec["traffic"]["bf16"] = True
    stage = Stage(tiny_spec["cfg"], tiny_spec["traffic"], SEED, torch.device("cpu"), str(tmp_path))
    readings = calibrate.readings(stage, "control")
    ok, rows = compare.verdict({k: (v, "") for k, v in readings.items()}, tiny_spec["limits"])
    assert not ok, rows
