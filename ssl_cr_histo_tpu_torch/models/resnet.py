"""torchvision-shaped ResNet-18/50 trunks (final fc stripped), NCHW.

Counterpart of ``ssl_cr_histo_tpu/models/resnet.py:50-171``; written out
here because the GPU machine has no torchvision.  Module names follow
torchvision's, so state_dicts use the reference's keys
(``conv1``, ``layer1.0.conv1``, ``layer2.0.downsample.0``, ...).

BatchNorm2d(momentum=0.1, eps=1e-5) is flax's BatchNorm(momentum=0.9,
epsilon=1e-5) (``resnet.py:24-31``): torch weights the new batch statistic
by ``momentum``, flax weights the old running value by it.  Convs pad
symmetrically by (k-1)//2, as torch and the JAX package's explicit padding
both do.
"""

from __future__ import annotations

import torch
from torch import nn


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=False)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    """3x3 -> 3x3 with an identity or projection shortcut."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride)
        self.bn1 = _bn(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = _bn(filters)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.Sequential(_conv(cin, filters, 1, stride), _bn(filters))

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        idt = x if self.downsample is None else self.downsample(x)
        return self.relu(y + idt)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int):
        super().__init__()
        cout = filters * self.expansion
        self.conv1 = _conv(cin, filters, 1)
        self.bn1 = _bn(filters)
        self.conv2 = _conv(filters, filters, 3, stride)
        self.bn2 = _bn(filters)
        self.conv3 = _conv(filters, cout, 1)
        self.bn3 = _bn(cout)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride), _bn(cout))

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        idt = x if self.downsample is None else self.downsample(x)
        return self.relu(y + idt)


class ResNet(nn.Module):
    """forward(x (B, 3, H, W)) -> (B, feature_dim) globally pooled features,
    float32 (float64 for a float64 model)."""

    def __init__(self, stage_sizes, block_cls, num_filters: int = 64):
        super().__init__()
        self.conv1 = _conv(3, num_filters, 7, 2)
        self.bn1 = _bn(num_filters)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = num_filters
        for i, count in enumerate(stage_sizes):
            blocks = []
            for j in range(count):
                filters = num_filters * 2**i
                blocks.append(block_cls(cin, filters, 2 if i > 0 and j == 0 else 1))
                cin = filters * block_cls.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        # torchvision's initialisation (the reference builds torchvision
        # models); BatchNorm2d already starts at weight 1, bias 0
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in range(self.n_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        # heads take float32 features under bf16 autocast (float64 stays
        # float64, for the float64 parity tests)
        x = x.mean(dim=(2, 3))
        return x.to(torch.promote_types(x.dtype, torch.float32))


def ResNet18() -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock)


def ResNet50() -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck)


def make_backbone(name: str) -> ResNet:
    if name == "resnet18":
        return ResNet18()
    if name == "resnet50":
        return ResNet50()
    raise NotImplementedError(f"not supported model type: {name}")

