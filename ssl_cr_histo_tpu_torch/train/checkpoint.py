"""Checkpoints in the reference's torch format, and weights carried over
from the JAX package.

The port's checkpoint is a ``torch.save`` dict whose ``'model'`` entry is the
TripletNet state_dict (``model.*`` backbone, ``fc.0|2.*`` pairwise head) and
whose ``'classifier'`` entry is the head's: the pretraining Classifier's
(``classifier.0|2.*``) or the fine-tune head's (``classifier.0.*``).  That is
the reference's layout, which the JAX package reads with
``train.checkpoint.load_torch_triplet_checkpoint`` and
``load_torch_linear_head``.  The optimizer, the Lookahead state or the LR
schedule, the step, the run's random generators and a ``meta`` dict ride
along under their own keys, so that ``restore_checkpoint`` resumes a run
where it stopped (``ssl_cr_histo_tpu/train/checkpoint.py:58-118``).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ssl_cr_histo_tpu_torch.parallel.distributed import barrier, is_primary
from ssl_cr_histo_tpu_torch.train.state import FinetuneState, Teacher, TrainState

Generators = Dict[str, torch.Generator]


def save_checkpoint(path: str, state: "TrainState | FinetuneState | Teacher", meta: dict,
                    generators: Optional[Generators] = None) -> None:
    """Write ``path`` (a ``.pth`` file) atomically: the state's
    ``payload()``, ``meta``, and under ``'generators'`` the state of each
    named generator of the run (its augmentation and ordering draws), which
    ``restore_checkpoint`` puts back.  Under data parallelism only the
    primary process writes (``checkpoint.py:38``; the state and the
    generators are equal on every process), and every process then waits
    for the others, so that none reads a half-written file."""
    if is_primary():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        payload = {**state.payload(), "meta": meta}
        if generators:
            payload["generators"] = {name: g.get_state() for name, g in generators.items()}
        torch.save(payload, tmp)
        os.replace(tmp, path)
    barrier()


def latest_checkpoint(base_dir: str) -> Optional[str]:
    """The ``ckpt_<N>.pth`` under ``base_dir`` with the highest epoch N,
    compared as numbers (``ckpt_10`` after ``ckpt_9``), or None
    (``checkpoint.py:107-118``)."""
    if not os.path.isdir(base_dir):
        return None
    epochs = [int(m.group(1)) for m in map(re.compile(r"ckpt_(\d+)\.pth").fullmatch, os.listdir(base_dir)) if m]
    return os.path.join(base_dir, f"ckpt_{max(epochs)}.pth") if epochs else None


def restore_checkpoint(path: str, state: "TrainState | FinetuneState | Teacher", restore_opt: bool = True,
                       generators: Optional[Generators] = None) -> Tuple["TrainState | FinetuneState | Teacher", dict]:
    """Load a checkpoint of ``save_checkpoint`` into ``state`` in place and
    return (state, meta) (``checkpoint.py:58-104``).

    The TripletNet (``'model'``) and the head (``'classifier'``) always
    load, and the step where the state has one.  With ``restore_opt`` the
    optimizer, the LR schedule and Lookahead's slow weights and epoch count
    load too (a teacher, which has none, takes ``restore_opt=False``).  The
    state of each generator in ``generators`` is set from the checkpoint's
    entry of the same name, so the draws go on where the saved run stopped.
    Every process of a data-parallel run restores the same file.
    """
    raw = torch.load(path, map_location="cpu", weights_only=False)
    state.model.load_state_dict(raw["model"])
    (state.classifier if isinstance(state, TrainState) else state.head).load_state_dict(raw["classifier"])
    if hasattr(state, "step"):
        state.step = int(raw.get("step", 0))
    if restore_opt:
        state.optimizer.load_state_dict(raw["optimizer"])
        if getattr(state, "scheduler", None) is not None:
            state.scheduler.load_state_dict(raw["scheduler"])
        if getattr(state, "slow", None) is not None and raw.get("slow") is not None:
            with torch.no_grad():
                for s, v in zip(state.slow, raw["slow"], strict=True):
                    s.copy_(v)
            state.la_count = int(raw.get("la_count", 0))
    saved = raw.get("generators", {})
    for name, gen in (generators or {}).items():
        if name in saved:
            gen.set_state(saved[name])
        else:
            print(f"WARNING: {path} holds no state of the generator {name!r}; its draws restart from the seed")
    return state, raw.get("meta", {})


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
