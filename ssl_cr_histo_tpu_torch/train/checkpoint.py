"""Checkpoints in the reference's torch format, and weights carried over
from the JAX package.

The port's checkpoint is a ``torch.save`` dict whose ``'model'`` entry is the
TripletNet state_dict (``model.*`` backbone, ``fc.0|2.*`` pairwise head) and
whose ``'classifier'`` entry is the head's: the pretraining Classifier's
(``classifier.0|2.*``) or the fine-tune head's (``classifier.0.*``).  That is
the reference's layout, which the JAX package reads with
``train.checkpoint.load_torch_triplet_checkpoint`` and
``load_torch_linear_head``.  The optimizer, the Lookahead state or the LR
schedule, the step and a ``meta`` dict ride along under their own keys, for
a resume that is not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from ssl_cr_histo_tpu_torch.train.state import FinetuneState, TrainState


def save_checkpoint(path: str, state: "TrainState | FinetuneState", meta: dict) -> None:
    """Write ``path`` (a ``.pth`` file) atomically: the state's
    ``payload()`` and ``meta``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save({**state.payload(), "meta": meta}, tmp)
    os.replace(tmp, path)


def _leaves(tree: dict, path: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _torch_name(path: tuple) -> str:
    """flax backbone path -> torchvision name under ``model.``
    (``layer1_0/downsample_conv/kernel`` -> ``layer1.0.downsample.0.weight``)."""
    parts = list(path)
    if parts[0].startswith("layer") and "_" in parts[0]:
        parts = parts[0].split("_") + parts[1:]
    mods = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}[parts[-1]]
    return "model." + ".".join(mods.get(p, p) for p in parts[:-1]) + "." + leaf


def from_jax_params(model_params: dict, batch_stats: dict,
                    head_params: "dict | None" = None) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """JAX TripletNet params / batch_stats (and head params: a Classifier's
    ``fc1``/``fc2`` or a FinetuneHead's ``fc``) as numpy trees ->
    (TripletNet state_dict, head state_dict) of the port.

    Mirrors ``ssl_cr_histo_tpu/train/checkpoint.py:213-273``: conv kernels
    HWIO -> OIHW, Dense kernels transposed, BN scale/bias/mean/var ->
    weight/bias/running_mean/running_var, ``num_batches_tracked`` = 0.
    """
    t = lambda a: torch.from_numpy(np.array(a))  # a writable copy
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _leaves(model_params.get("backbone", {})):
        if path[-1] == "kernel":
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        sd[_torch_name(path)] = t(v)
    for path, v in _leaves(batch_stats.get("backbone", {})):
        sd[_torch_name(path)] = t(v)
        if path[-1] == "mean":
            prefix = _torch_name(path)[: -len(".running_mean")]
            sd[prefix + ".num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    fc = model_params.get("fc", {})
    for name, idx in (("fc1", 0), ("fc2", 2)):
        if name in fc:
            sd[f"fc.{idx}.weight"] = t(np.asarray(fc[name]["kernel"]).T)
            sd[f"fc.{idx}.bias"] = t(np.asarray(fc[name]["bias"]))
    head_sd: Dict[str, torch.Tensor] = {}
    for name, idx in (("fc", 0), ("fc1", 0), ("fc2", 2)):
        if head_params and name in head_params:
            head_sd[f"classifier.{idx}.weight"] = t(np.asarray(head_params[name]["kernel"]).T)
            head_sd[f"classifier.{idx}.bias"] = t(np.asarray(head_params[name]["bias"]))
    return sd, head_sd
