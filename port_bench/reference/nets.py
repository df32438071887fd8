"""The plain reference's network: a backbone family's features with the
RSP pair head, the 6-way classifier and the fine-tune head, from a
configuration file's numbers.

The pair head maps each pair of view embeddings (concatenated) through
Linear-ReLU-Linear, and the triplet feature is the three pairs' outputs
(12, 23, 13) side by side; a single image's feature is its embedding
paired with itself, three times.

Parameters live in one flat dict under the names the port's state_dicts
use, prefixed ``net.`` (the TripletNet), ``clf.`` (the RSP classifier) and
``head.`` (the fine-tune head), so the same tensors load into both sides.

``quant`` (``fp8_train``), when given, rounds both operands and the
result of every matrix product (convolutions, linears, attention's), and
every norm's and residual sum's result: the control's lower precision for
every tensor the program keeps in bfloat16.

A configuration names its backbone family (``"family"``), the module
``port_bench.reference.<family>``, which gives:

- ``backbone_spec(cfg)``: ``[(name, shape, kind, ...)]`` of the backbone's
  tensors, named ``net.model.<the port's state_dict name>``, in
  ``port_bench.weights``'s kinds: ``conv``, ``linear``, ``bias``, ``bn_*``,
  and ``normal`` and ``fill``, whose std or value is the entry's fourth
  item;
- ``embed_dim(cfg)``: the width of its features;
- ``backbone(cfg, p, x, train, q)``: (N, 3, H, W) images -> (N, embed_dim)
  features in float32 (float64 stays float64), BatchNorm, where it has
  any, on batch statistics when ``train``; ``q`` applied to both operands
  and the result of every matrix product, and to every norm's and residual
  sum's result;
- ``backbone_macs(cfg, size)``: (multiply-adds of one image's forward at
  ``size``^2, those of its first layer on the image, whose input gradient
  no step computes), counting every matrix product: convolutions and
  linears, and for an attention family QK^T and PV.

Counts of a family's own kernels for a roofline go in its module too, so
that a metric's reader added later imports them from there.
"""

from __future__ import annotations

import importlib
import math

import torch
import torch.nn.functional as F


def family(cfg: dict):
    """The backbone family module the configuration names."""
    name = cfg.get("family")
    if not isinstance(name, str) or not name.isidentifier():
        raise ValueError(f"configuration {cfg.get('name')!r} (port_bench/configs/{cfg.get('name')}.json) names "
                         f"no backbone family: give it \"family\", a module of port_bench/reference/")
    return importlib.import_module(f"port_bench.reference.{name}")


def feature_dim(cfg: dict) -> int:
    return 3 * cfg["pair_fc"][2]


def param_spec(cfg: dict, rsp_classes: int = 0, head_classes: int = 0) -> list:
    """[(name, shape, kind, ...)] of every tensor: the family's backbone,
    then the heads' 'linear' weights (lecun normal) and 'bias' (0)."""
    fam = family(cfg)
    spec = list(fam.backbone_spec(cfg))

    def linear(name, dout, din):
        spec.append((f"{name}.weight", (dout, din), "linear"))
        spec.append((f"{name}.bias", (dout,), "bias"))

    d_in, d_hidden, d_out = cfg["pair_fc"]
    if d_in != 2 * fam.embed_dim(cfg):
        raise ValueError(f"pair_fc {cfg['pair_fc']}: its input is a pair of {fam.embed_dim(cfg)}-wide embeddings")
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
        self.cfg, self.p, self.family = cfg, p, family(cfg)
        self.q = quant or (lambda t: t)

    def linear(self, name, x):
        return self.q(F.linear(self.q(x), self.q(self.p[f"{name}.weight"]), self.p[f"{name}.bias"]))

    def backbone(self, x, train: bool = True):
        return self.family.backbone(self.cfg, self.p, x, train, self.q)

    def pair(self, a, b):
        return self.linear("net.fc.2", F.relu(self.linear("net.fc.0", torch.cat([a, b], -1))))

    def triplet_features(self, views, train: bool = True):
        """(B, 3, C, H, W) views -> (B, 3 * d_out); one backbone pass over
        the B*3 views, so a BatchNorm pools the three views."""
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
