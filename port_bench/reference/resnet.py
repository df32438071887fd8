"""The ResNet family (``"family": "resnet"``): ResNet-18/50 backbones from a
configuration file's numbers.

He et al. 2016 (arXiv:1512.03385), Table 1: a 7x7 stride-2 stem, 3x3
stride-2 max pool, four stages of BasicBlocks (3x3, 3x3) or Bottlenecks
(1x1, 3x3 carrying the stride, 1x1 x4) with projection shortcuts where the
shape changes, global average pool.  Each BatchNorm takes batch statistics
in train mode (eps 1e-5), its running statistics otherwise.

The family contract is in ``port_bench.reference.nets``.
"""

from __future__ import annotations

import torch.nn.functional as F


def _conv_out(size: int, k: int, stride: int) -> int:
    return (size + 2 * ((k - 1) // 2) - k) // stride + 1


def blocks(cfg: dict):
    """(prefix, cin, filters, stride) of each residual block, in order."""
    cin = cfg["stem_width"]
    for i, (count, width) in enumerate(zip(cfg["stage_sizes"], cfg["stage_widths"])):
        for j in range(count):
            yield f"layer{i + 1}.{j}", cin, width, (2 if i > 0 and j == 0 else 1)
            cin = width * cfg["expansion"]


def embed_dim(cfg: dict) -> int:
    return cfg["stage_widths"][-1] * cfg["expansion"]


def backbone_spec(cfg: dict) -> list:
    """kind 'conv' (lecun normal weights), 'bn_w' (1), 'bn_b' (0),
    'bn_mean' (0), 'bn_var' (1), 'bn_count' (0, int64)."""
    spec = []

    def conv(name, cout, cin, k):
        spec.append((f"net.model.{name}.weight", (cout, cin, k, k), "conv"))

    def bn(name, c):
        for suffix, kind in (("weight", "bn_w"), ("bias", "bn_b"), ("running_mean", "bn_mean"),
                             ("running_var", "bn_var")):
            spec.append((f"net.model.{name}.{suffix}", (c,), kind))
        spec.append((f"net.model.{name}.num_batches_tracked", (), "bn_count"))

    stem = cfg["stem_width"]
    conv("conv1", stem, 3, 7)
    bn("bn1", stem)
    exp = cfg["expansion"]
    for prefix, cin, f, stride in blocks(cfg):
        if cfg["block"] == "basic":
            conv(f"{prefix}.conv1", f, cin, 3)
            bn(f"{prefix}.bn1", f)
            conv(f"{prefix}.conv2", f, f, 3)
            bn(f"{prefix}.bn2", f)
        else:
            conv(f"{prefix}.conv1", f, cin, 1)
            bn(f"{prefix}.bn1", f)
            conv(f"{prefix}.conv2", f, f, 3)
            bn(f"{prefix}.bn2", f)
            conv(f"{prefix}.conv3", f * exp, f, 1)
            bn(f"{prefix}.bn3", f * exp)
        if stride != 1 or cin != f * exp:
            conv(f"{prefix}.downsample.0", f * exp, cin, 1)
            bn(f"{prefix}.downsample.1", f * exp)
    return spec


def backbone(cfg: dict, p: dict, x, train: bool, q):
    """(N, 3, H, W) -> (N, embed_dim) pooled features."""

    def conv(name, x, stride):
        w = p[f"net.model.{name}.weight"]
        return q(F.conv2d(q(x), q(w), stride=stride, padding=(w.shape[-1] - 1) // 2))

    def bn(name, x):
        g = lambda s: p[f"net.model.{name}.{s}"]
        if train:
            return q(F.batch_norm(x, None, None, g("weight"), g("bias"), training=True, eps=1e-5))
        return q(F.batch_norm(x, g("running_mean"), g("running_var"), g("weight"), g("bias"), training=False,
                              eps=1e-5))

    x = F.relu(bn("bn1", conv("conv1", x, 2)))
    x = F.max_pool2d(x, 3, 2, 1)
    basic = cfg["block"] == "basic"
    for prefix, cin, f, stride in blocks(cfg):
        if basic:
            y = F.relu(bn(f"{prefix}.bn1", conv(f"{prefix}.conv1", x, stride)))
            y = bn(f"{prefix}.bn2", conv(f"{prefix}.conv2", y, 1))
        else:
            y = F.relu(bn(f"{prefix}.bn1", conv(f"{prefix}.conv1", x, 1)))
            y = F.relu(bn(f"{prefix}.bn2", conv(f"{prefix}.conv2", y, stride)))
            y = bn(f"{prefix}.bn3", conv(f"{prefix}.conv3", y, 1))
        if f"net.model.{prefix}.downsample.0.weight" in p:
            x = bn(f"{prefix}.downsample.1", conv(f"{prefix}.downsample.0", x, stride))
        x = F.relu(q(y + x))
    return x.mean(dim=(2, 3))


def backbone_macs(cfg: dict, size: int) -> tuple:
    """(multiply-adds of one image's backbone forward at ``size``^2, those
    of its first convolution)."""
    stem = cfg["stem_width"]
    s = _conv_out(size, 7, 2)
    first = s * s * stem * 3 * 49
    macs = first
    s = (s + 2 - 3) // 2 + 1  # max pool 3, stride 2, pad 1
    exp = cfg["expansion"]
    for _, cin, f, stride in blocks(cfg):
        out = _conv_out(s, 3, stride)
        if cfg["block"] == "basic":
            macs += out * out * f * cin * 9 + out * out * f * f * 9
        else:
            macs += s * s * f * cin + out * out * f * f * 9 + out * out * f * exp * f
        if stride != 1 or cin != f * exp:
            macs += out * out * f * exp * cin
        s = out
    return macs, first
