"""torchvision-shaped ResNet-18/50 trunks (final fc stripped), NCHW: the
ResNet family of backbones.  What this docstring says of BatchNorm, its
global statistics and its recomputation holds for this family alone;
UNI2-h's ViT (``models/vit.py``) has no BatchNorm.

Counterpart of ``ssl_cr_histo_tpu/models/resnet.py:50-171``; written out
here because the GPU machine has no torchvision.  Module names follow
torchvision's, so state_dicts use the reference's keys
(``conv1``, ``layer1.0.conv1``, ``layer2.0.downsample.0``, ...).

BatchNorm2d(momentum=0.1, eps=1e-5) is flax's BatchNorm(momentum=0.9,
epsilon=1e-5) (``resnet.py:24-31``): torch weights the new batch statistic
by ``momentum``, flax weights the old running value by it.  Convs pad
symmetrically by (k-1)//2, as torch and the JAX package's explicit padding
both do.

Weights start as the JAX package's do (``lecun_normal_``): it sets no
initialiser, so every flax Conv and Dense kernel is ``lecun_normal`` and
every bias 0; BatchNorm starts at scale 1, bias 0 in both.

BatchNorm takes its training statistics over the global batch: under an
initialised world of more than one process (``parallel.distributed``),
``GlobalBatchNorm2d`` combines every process's per-channel statistics and
sums its backward's two reductions across them, as the JAX step normalises
over the whole array it shards under pjit (PARITY.md C23).  At world 1 it is
``nn.BatchNorm2d``.

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
import math

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=False)


class _GlobalBatchNormFn(torch.autograd.Function):
    """Train-mode batch normalisation over the global batch of every
    process: forward returns (normalised, affine) x and the global batch's
    mean, biased variance and count; backward sums its two per-channel
    reductions over the processes.  Math in float32 (float64 for a float64
    input), output in the input's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        world, rank = dist.get_world_size(), dist.get_rank()
        xa = x.to(torch.promote_types(x.dtype, torch.float32))
        c = x.shape[1]
        # each process's (count, mean, biased variance) in its row of a
        # zero-filled (world, 2C + 1) table; one all-reduce gathers the table
        # and every process combines it in rank order (Chan et al.'s
        # pairwise update): the same statistics bit for bit everywhere, and
        # no E[x^2] - mean^2 cancellation
        var_r, mean_r = torch.var_mean(xa, dim=(0, 2, 3), correction=0)
        table = xa.new_zeros((world, 2 * c + 1))
        table[rank, 0] = x.numel() // c
        table[rank, 1:c + 1] = mean_r
        table[rank, c + 1:] = var_r
        dist.all_reduce(table)
        n_r, means, vars_ = table[:, :1], table[:, 1:c + 1], table[:, c + 1:]
        n = n_r.sum()
        mean = (n_r * means).sum(0) / n
        var = (n_r * (vars_ + (means - mean) ** 2)).sum(0) / n
        invstd = torch.rsqrt(var + eps)
        view = (1, c, 1, 1)
        xhat = (xa - mean.view(view)) * invstd.view(view)
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.count = n
        ctx.mark_non_differentiable(mean, var, n)
        y = xhat * weight.to(xa.dtype).view(view) + bias.to(xa.dtype).view(view)
        return y.to(x.dtype), mean, var, n

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dn):
        xhat, weight, invstd = ctx.saved_tensors
        da = dy.to(xhat.dtype)
        c = xhat.shape[1]
        view = (1, c, 1, 1)
        local = torch.stack([da.sum((0, 2, 3)), (da * xhat).sum((0, 2, 3))])
        # the affine parameters' gradients stay this process's sums: the
        # step's gradient average takes them over the processes
        d_bias, d_weight = local[0].to(weight.dtype), local[1].to(weight.dtype)
        total = local.clone()
        dist.all_reduce(total)
        n = ctx.count
        dx = (weight.to(da.dtype) * invstd).view(view) * (
            da - (total[0] / n).view(view) - xhat * (total[1] / n).view(view))
        return dx.to(dy.dtype), d_weight, d_bias, None


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode statistics span every process's
    rows of the global batch.  In eval mode, and at world 1 or with no world
    initialised, it is ``F.batch_norm`` exactly.  Otherwise the forward
    combines the processes' per-channel statistics with one all-reduce and
    the backward sums its two gradient reductions with another; the running
    statistics follow ``nn.BatchNorm2d`` over the global count (the variance
    unbiased by n / (n - 1) of the global n).  Not ``nn.SyncBatchNorm``,
    which takes CUDA tensors only."""

    def forward(self, x):
        if not (self.training and dist.is_initialized() and dist.get_world_size() > 1):
            return super().forward(x)
        with torch.autocast(x.device.type, enabled=False):
            y, mean, var, n = _GlobalBatchNormFn.apply(x, self.weight, self.bias, self.eps)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
                self.running_var.mul_(1 - m).add_((var * n / (n - 1)).to(self.running_var.dtype), alpha=m)
        return y


def _bn(c: int) -> nn.BatchNorm2d:
    return GlobalBatchNorm2d(c, eps=1e-5, momentum=0.1)


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


# The standard deviation of a unit normal truncated to [-2, 2]
# (``jax.nn.initializers.variance_scaling``'s correction)
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(module: nn.Module) -> nn.Module:
    """Every Conv2d and Linear of ``module`` initialised as flax initialises
    the JAX package's Conv and Dense by default: the weight from a normal
    truncated at two standard deviations with variance 1 / fan_in
    (``jax.nn.initializers.lecun_normal``; fan_in = in channels x kernel
    area), the bias 0.  Draws from torch's global generator."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = 1.0 / math.sqrt(m.weight[0].numel()) / _TRUNCATED_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2.0 * std, b=2.0 * std)
            if m.bias is not None:
                m.bias.zero_()
    return module


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
        lecun_normal_(self)

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
    """The ResNet ``name``; ``models.nets.make_backbone`` picks the family."""
    if name == "resnet18":
        return ResNet18(remat)
    if name == "resnet50":
        return ResNet50(remat)
    raise NotImplementedError(f"not supported model type: {name}")

