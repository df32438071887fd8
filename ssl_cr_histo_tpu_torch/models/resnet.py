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

``remat`` recomputes each residual block's activations in the backward pass
instead of keeping them (``resnet.py:123-137``, ``nn.remat`` per block):
``torch.utils.checkpoint`` without re-entry, autocast restored for the
recomputation by the checkpoint itself.  The recomputation runs the block's
BatchNorms in train mode a second time; their running statistics and
``num_batches_tracked`` are put back as the first pass left them, so a step
with ``remat`` leaves the state a step without it leaves (flax's batch stats
are outputs of the forward pass, and ``nn.remat`` has no such effect).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


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


@contextlib.contextmanager
def _keep_bn_statistics(block: nn.Module):
    """Put each BatchNorm's running statistics and batch count in ``block``
    back as they were on entry (around a checkpoint's recomputation)."""
    saved = [(b, [t.clone() for t in (b.running_mean, b.running_var, b.num_batches_tracked)])
             for b in block.modules() if isinstance(b, nn.BatchNorm2d) and b.track_running_stats]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, ts in saved:
                for dst, src in zip((b.running_mean, b.running_var, b.num_batches_tracked), ts):
                    dst.copy_(src)


class ResNet(nn.Module):
    """forward(x (B, 3, H, W)) -> (B, feature_dim) globally pooled features,
    float32 (float64 for a float64 model).  ``remat``: recompute each block
    in the backward pass of a training forward (see the module docstring)."""

    def __init__(self, stage_sizes, block_cls, num_filters: int = 64, remat: bool = False):
        super().__init__()
        self.remat = remat
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
        remat = self.remat and self.training and torch.is_grad_enabled()
        for i in range(self.n_stages):
            for block in getattr(self, f"layer{i + 1}"):
                if remat:
                    x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False,
                                   context_fn=lambda b=block: (contextlib.nullcontext(), _keep_bn_statistics(b)))
                else:
                    x = block(x)
        # heads take float32 features under bf16 autocast (float64 stays
        # float64, for the float64 parity tests)
        x = x.mean(dim=(2, 3))
        return x.to(torch.promote_types(x.dtype, torch.float32))


def ResNet18(remat: bool = False) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, remat=remat)


def ResNet50(remat: bool = False) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, remat=remat)


def make_backbone(name: str, remat: bool = False) -> ResNet:
    if name == "resnet18":
        return ResNet18(remat)
    if name == "resnet50":
        return ResNet50(remat)
    raise NotImplementedError(f"not supported model type: {name}")

