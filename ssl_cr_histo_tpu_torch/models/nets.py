"""The triplet (RSP) network and its pretraining classifier head.

Counterpart of ``ssl_cr_histo_tpu/models/nets.py:27-124``, with the
reference's module names so that state_dicts carry its keys: the backbone
under ``model.*``, the pairwise MLP under ``fc.0`` / ``fc.2``, the classifier
under ``classifier.0`` / ``classifier.2``, the fine-tune head under
``classifier.0``.  Every head Linear starts as flax's Dense does
(``resnet.lecun_normal_``).

The backbone is picked by name, once, when the modules are built
(``make_backbone``): a ResNet (``models/resnet.py``: BatchNorm, whose batch
statistics a joint pass pools over every view in it) or UNI2-h's ViT
(``models/vit.py``: no BatchNorm, so each view's features depend on that
view alone, in train mode as in eval mode).  The pair head's widths are
the reference's for resnet18 (2D -> D -> D/2 of a D-wide embedding);
resnet50's and uni2h's are 2D -> D/2 -> D/4.

A family whose modules count something in Python keeps its counter and
one reading of it (``read_counters``: ``{label: collections.Counter}``);
``read_counters`` here sums every family's over the models it is given,
and ``counters_since`` is their part of the stage CLIs' epoch line.
"""

from __future__ import annotations

import collections

import torch
from torch import nn

from ssl_cr_histo_tpu_torch.models import resnet, vit
from ssl_cr_histo_tpu_torch.models.resnet import lecun_normal_

_FC_DIMS = {"resnet18": (1024, 512, 256), "resnet50": (4096, 1024, 512), "uni2h": (3072, 768, 384)}
MODEL_NAMES = tuple(_FC_DIMS)


def make_backbone(name: str, remat: bool = False) -> nn.Module:
    """The backbone ``name`` (``remat``: each block recomputed in the
    backward pass): a ViT of ``vit.CONFIGS`` or a ResNet."""
    if name in vit.CONFIGS:
        return vit.ViT(**vit.CONFIGS[name], remat=remat)
    return resnet.make_backbone(name, remat)


# the families that keep counters, in the epoch line's order
_COUNTED = (vit, resnet)


def read_counters(models) -> dict:
    """Each family's counters (``read_counters`` of its module) over
    ``models`` (a student and its teacher: summed), by label; a family
    that none of them holds has no entry."""
    out = {}
    for family in _COUNTED:
        for model in models:
            for label, counts in family.read_counters(model).items():
                out.setdefault(label, collections.Counter()).update(counts)
    return out


def counters_since(models, before: dict) -> str:
    """The epoch line's ``; <label> <name> <n>, ...`` for each counter of
    ``models`` less ``before`` (a ``read_counters`` reading), its names in
    order; ``none`` for a counter that has counted nothing; empty for
    models that keep no counter."""
    parts = []
    for label, calls in read_counters(models).items():
        calls.subtract(before.get(label, {}))
        parts.append(f"; {label} " + (", ".join(f"{k} {v}" for k, v in sorted(calls.items())) or "none"))
    return "".join(parts)


def feature_dim(model_name: str) -> int:
    """Final triplet feature dimension (3 * fc_out): 768 for resnet18, 1152
    for uni2h."""
    return 3 * _FC_DIMS[model_name][2]


def _pair_fc(model_name: str) -> nn.Sequential:
    """Shared MLP applied to pairwise-concatenated embeddings."""
    d_in, d_hidden, d_out = _FC_DIMS[model_name]
    return lecun_normal_(nn.Sequential(nn.Linear(d_in, d_hidden), nn.ReLU(inplace=True), nn.Linear(d_hidden, d_out)))


class TripletNet(nn.Module):
    """Backbone + pairwise-concat head.

    ``forward(i1, i2, i3)``   -> (B, 3*fc_out), one backbone pass per view
    ``encode_single(i)``       -> the same layout from one image
    ``forward_joint(tiles)``   -> the same, one backbone pass over B*3 views

    ``remat``: the backbone recomputes each block (residual or
    transformer) in the backward pass (``--remat``); the state_dict is the
    same.
    """

    def __init__(self, model_name: str = "resnet18", remat: bool = False):
        super().__init__()
        self.model_name = model_name
        self.model = make_backbone(model_name, remat)
        self.fc = _pair_fc(model_name)

    def pair_features(self, e1, e2, e3):
        """Pairwise head over three (B, D) view embeddings -> (B, 3*fc_out)."""
        f12 = self.fc(torch.cat([e1, e2], -1))
        f23 = self.fc(torch.cat([e2, e3], -1))
        f13 = self.fc(torch.cat([e1, e3], -1))
        return torch.cat([f12, f23, f13], -1)

    def forward(self, i1, i2, i3):
        return self.pair_features(self.model(i1), self.model(i2), self.model(i3))

    def encode_single(self, i):
        e = self.model(i)
        f = self.fc(torch.cat([e, e], -1))
        return torch.cat([f, f, f], -1)

    def forward_joint(self, tiles):
        """tiles: (B, 3, C, H, W).  One batched backbone pass over the three
        views, so a ResNet's BatchNorm pools its batch statistics across
        them (the reference takes them per view; eval mode is identical)
        (``nets.py:80-95``); a backbone without BatchNorm gives what three
        passes give."""
        b = tiles.shape[0]
        e = self.model(tiles.reshape(b * 3, *tiles.shape[2:])).reshape(b, 3, -1)
        return self.pair_features(e[:, 0], e[:, 1], e[:, 2])


class Classifier(nn.Module):
    """Pretraining classifier head: in -> 128 -> num_classes."""

    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.classifier = lecun_normal_(nn.Sequential(
            nn.Linear(in_features, 128), nn.ReLU(inplace=True), nn.Linear(128, num_classes)))

    def forward(self, x):
        return self.classifier(x)


class FinetuneHead(nn.Module):
    """Fine-tune head: one Linear in -> num_classes (``nets.py:116-124``),
    under ``classifier.0`` as in the reference's FinetuneResNet."""

    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.classifier = lecun_normal_(nn.Sequential(nn.Linear(in_features, num_classes)))

    def forward(self, x):
        return self.classifier(x)
