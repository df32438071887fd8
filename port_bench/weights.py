"""Seeded weights, made on the device in a few large calls.

flax's initialisation, as the port's ``train/init.py`` gives it: every
convolution and linear weight from a normal truncated at two standard
deviations with variance 1 / fan_in (``reference.nets.lecun_std``), every
bias 0, BatchNorm scale 1 and shift 0, running mean 0 and variance 1.  A
family's own tensors take the kinds ``normal`` (the entry's fourth item
times a unit normal truncated to [-2, 2]) and ``fill`` (the entry's fourth
item everywhere).  Every drawn weight comes, in the spec's order, from one
draw of a ``torch.Generator`` on the card, cut into leaves, so a seed gives
the same weights whatever reads them.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference.nets import lecun_std

_FILL = {"bias": 0.0, "bn_w": 1.0, "bn_b": 0.0, "bn_mean": 0.0, "bn_var": 1.0}


def truncated_normal(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """n draws of a unit normal truncated to [-2, 2], by the inverse CDF."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    return (math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)).clamp_(-2.0, 2.0)


def make_weights(spec: list, seed: int, device) -> dict:
    """{name: tensor} for ``reference.nets.param_spec``'s entries, float32
    (the BatchNorm counts int64), on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    drawn = [(e[0], e[1], e[3] if e[2] == "normal" else lecun_std(e[1])) for e in spec
             if e[2] in ("conv", "linear", "normal")]
    flat = truncated_normal(gen, sum(math.prod(s) for _, s, _ in drawn), device)
    out, at = {}, 0
    for name, shape, std in drawn:
        n = math.prod(shape)
        out[name] = (flat[at:at + n] * std).view(shape)
        at += n
    for name, shape, kind, *value in spec:
        if kind == "bn_count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
        elif kind in _FILL or kind == "fill":
            out[name] = torch.full(shape, value[0] if kind == "fill" else _FILL[kind], dtype=torch.float32,
                                   device=device)
    return {e[0]: out[e[0]] for e in spec}


def prefixed(weights: dict, prefix: str) -> dict:
    """The entries under ``prefix`` (with its dot), the prefix taken off: a
    state_dict for one of the program's modules."""
    return {k[len(prefix) + 1:]: v for k, v in weights.items() if k.startswith(prefix + ".")}
