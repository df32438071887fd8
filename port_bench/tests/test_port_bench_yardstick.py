"""The yardstick's counts against hand counts."""

import json
import math
import os

import pytest

from port_bench import yardstick
from port_bench.reference.nets import param_spec

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def cfg(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


def test_basic_block_by_hand():
    # resnet18 at 64^2: conv1 32^2 x 64 x 3 x 49, then 16^2 after the pool;
    # layer1.0 is two 3x3 convs of 64 -> 64 at 16^2
    r18 = cfg("resnet18")
    one = dict(r18, stage_sizes=[1], stage_widths=[64])
    macs, first = yardstick.backbone_macs(one, 64)
    assert first == 32 * 32 * 64 * 3 * 49
    assert macs == first + 2 * 16 * 16 * 64 * 64 * 9


def test_bottleneck_block_by_hand():
    r50 = cfg("resnet50")
    one = dict(r50, stage_sizes=[1], stage_widths=[64])
    macs, first = yardstick.backbone_macs(one, 64)
    s = 16
    block = s * s * 64 * 64 + s * s * 64 * 64 * 9 + s * s * 256 * 64 + s * s * 256 * 64  # + projection
    assert macs == first + block


@pytest.mark.parametrize("name,gmacs", [("resnet18", 1.8136), ("resnet50", 4.0878)])
def test_published_backbone_cost(name, gmacs):
    # the published multiply-adds at 224^2, less the 1000-way fc
    macs, _ = yardstick.backbone_macs(cfg(name), 224)
    assert abs(macs / 1e9 - gmacs) / gmacs < 0.005


def test_parameter_counts():
    # torchvision's trunks without their fc: 11.18 M and 23.51 M
    for name, million in (("resnet18", 11.1765), ("resnet50", 23.5081)):
        spec = [s for s in param_spec(cfg(name)) if s[0].startswith("net.model.") and s[2] not in
                ("bn_mean", "bn_var", "bn_count")]
        n = sum(math.prod(shape) for _, shape, _ in spec)
        assert abs(n / 1e6 - million) < 0.001, (name, n)


def test_pretrain_step_flops():
    r18 = cfg("resnet18")
    macs, first = yardstick.backbone_macs(r18, 256)
    head = 3 * (1024 * 512 + 512 * 256) + 768 * 128 + 128 * 6
    want = 64 * 3 * 2 * (3 * macs - first) + 64 * 2 * 3 * head
    assert yardstick.pretrain_step_flops(r18, 64, 256) == pytest.approx(want, rel=1e-12)


def test_rsp_augment_least_time():
    ops = (70 + 12 + 60 + 0.5 * (45 + 12 + 126 + 18 + 15)) * 192 * 65536
    n_bytes = 192 * 65536 * 3 + 192 * 3 * 65536 * 2 + 192 * 26 * 4
    assert ops / 67e12 > n_bytes / 3.35e12
    assert yardstick.rsp_augment_least_s(64, 256) == pytest.approx(ops / 67e12, rel=1e-12)
