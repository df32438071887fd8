"""Plain functional ResNet-18/50 with the RSP pair head, the 6-way
classifier and the fine-tune head, from a configuration file's numbers.

He et al. 2016 (arXiv:1512.03385), Table 1: a 7x7 stride-2 stem, 3x3
stride-2 max pool, four stages of BasicBlocks (3x3, 3x3) or Bottlenecks
(1x1, 3x3 carrying the stride, 1x1 x4) with projection shortcuts where the
shape changes, global average pool.  Each BatchNorm takes batch statistics
in train mode (eps 1e-5).  The pair head maps each pair of view embeddings
(concatenated) through Linear-ReLU-Linear, and the triplet feature is the
three pairs' outputs (12, 23, 13) side by side; a single image's feature is
its embedding paired with itself, three times.

Parameters live in one flat dict under the names the port's state_dicts
use, prefixed ``net.`` (the TripletNet), ``clf.`` (the RSP classifier) and
``head.`` (the fine-tune head), so the same tensors load into both sides.

``quant`` (``fp8_train``), when given, rounds both operands and the
result of every convolution and linear layer, and every BatchNorm's and
residual sum's result: the control's lower precision for every tensor the
program keeps in bfloat16.
"""

from __future__ import annotations

import math

import torch
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


def feature_dim(cfg: dict) -> int:
    return 3 * cfg["pair_fc"][2]


def param_spec(cfg: dict, rsp_classes: int = 0, head_classes: int = 0) -> list:
    """[(name, shape, kind)] of every tensor: kind 'conv' / 'linear' (lecun
    normal weights), 'bias' (0), 'bn_w' (1), 'bn_b' (0), 'bn_mean' (0),
    'bn_var' (1), 'bn_count' (0, int64)."""
    spec = []

    def conv(name, cout, cin, k):
        spec.append((f"net.model.{name}.weight", (cout, cin, k, k), "conv"))

    def bn(name, c):
        for suffix, kind in (("weight", "bn_w"), ("bias", "bn_b"), ("running_mean", "bn_mean"),
                             ("running_var", "bn_var")):
            spec.append((f"net.model.{name}.{suffix}", (c,), kind))
        spec.append((f"net.model.{name}.num_batches_tracked", (), "bn_count"))

    def linear(name, dout, din):
        spec.append((f"{name}.weight", (dout, din), "linear"))
        spec.append((f"{name}.bias", (dout,), "bias"))

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
    d_in, d_hidden, d_out = cfg["pair_fc"]
    linear("net.fc.0", d_hidden, d_in)
    linear("net.fc.2", d_out, d_hidden)
    if rsp_classes:
        linear("clf.classifier.0", cfg["rsp_hidden"], feature_dim(cfg))
        linear("clf.classifier.2", rsp_classes, cfg["rsp_hidden"])
    if head_classes:
        linear("head.classifier.0", head_classes, feature_dim(cfg))
    return spec


def lecun_std(shape) -> float:
    """flax's default kernel initialiser: variance 1 / fan_in, from a
    normal truncated at two standard deviations (whose own standard
    deviation, 0.8796..., is divided out)."""
    return 1.0 / math.sqrt(math.prod(shape[1:])) / 0.87962566103423978


class Net:
    """The functional network over a parameter dict ``p``."""

    def __init__(self, cfg: dict, p: dict, quant=None):
        self.cfg, self.p = cfg, p
        self.q = quant or (lambda t: t)

    def conv(self, name, x, stride):
        w = self.p[f"net.model.{name}.weight"]
        return self.q(F.conv2d(self.q(x), self.q(w), stride=stride, padding=(w.shape[-1] - 1) // 2))

    def bn(self, name, x, train: bool):
        g = lambda s: self.p[f"net.model.{name}.{s}"]
        if train:
            return self.q(F.batch_norm(x, None, None, g("weight"), g("bias"), training=True, eps=1e-5))
        return self.q(F.batch_norm(x, g("running_mean"), g("running_var"), g("weight"), g("bias"), training=False,
                                   eps=1e-5))

    def linear(self, name, x):
        return self.q(F.linear(self.q(x), self.q(self.p[f"{name}.weight"]), self.p[f"{name}.bias"]))

    def backbone(self, x, train: bool = True):
        x = F.relu(self.bn("bn1", self.conv("conv1", x, 2), train))
        x = F.max_pool2d(x, 3, 2, 1)
        basic = self.cfg["block"] == "basic"
        for prefix, cin, f, stride in blocks(self.cfg):
            if basic:
                y = F.relu(self.bn(f"{prefix}.bn1", self.conv(f"{prefix}.conv1", x, stride), train))
                y = self.bn(f"{prefix}.bn2", self.conv(f"{prefix}.conv2", y, 1), train)
            else:
                y = F.relu(self.bn(f"{prefix}.bn1", self.conv(f"{prefix}.conv1", x, 1), train))
                y = F.relu(self.bn(f"{prefix}.bn2", self.conv(f"{prefix}.conv2", y, stride), train))
                y = self.bn(f"{prefix}.bn3", self.conv(f"{prefix}.conv3", y, 1), train)
            if f"net.model.{prefix}.downsample.0.weight" in self.p:
                x = self.bn(f"{prefix}.downsample.1", self.conv(f"{prefix}.downsample.0", x, stride), train)
            x = F.relu(self.q(y + x))
        return x.mean(dim=(2, 3))

    def pair(self, a, b):
        return self.linear("net.fc.2", F.relu(self.linear("net.fc.0", torch.cat([a, b], -1))))

    def triplet_features(self, views, train: bool = True):
        """(B, 3, C, H, W) views -> (B, 3 * d_out); one backbone pass over
        the B*3 views, so BatchNorm pools the three views."""
        b = views.shape[0]
        e = self.backbone(views.reshape(b * 3, *views.shape[2:]), train).reshape(b, 3, -1)
        e1, e2, e3 = e.unbind(1)
        return torch.cat([self.pair(e1, e2), self.pair(e2, e3), self.pair(e1, e3)], -1)

    def single_features(self, x, train: bool = True):
        f = self.pair(*(2 * (self.backbone(x, train),)))
        return torch.cat([f, f, f], -1)

    def rsp_logits(self, feats):
        return self.linear("clf.classifier.2", F.relu(self.linear("clf.classifier.0", feats)))

    def head(self, feats):
        return self.linear("head.classifier.0", feats)


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``t`` rounded to the float8 ``dtype`` with a per-tensor scale that
    maps its largest magnitude to the format's ``top``."""
    scale = top / t.abs().amax().float().clamp_min(1e-30)
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    """Forward e4m3, backward e5m2, each with a per-tensor scale: float8
    training's usual split."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8_train(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 in the forward pass and the gradient
    flowing back through it to e5m2, each with a per-tensor scale."""
    return _Fp8.apply(t)
