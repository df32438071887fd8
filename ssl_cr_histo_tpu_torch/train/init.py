"""State initialization and the stage handoff (counterpart of
``ssl_cr_histo_tpu/train/init.py``)."""

from __future__ import annotations

from typing import Callable, Iterable, List

import torch

from ssl_cr_histo_tpu_torch.models import Classifier, FinetuneHead, TripletNet, feature_dim
from ssl_cr_histo_tpu_torch.train import optim
from ssl_cr_histo_tpu_torch.train.freeze import freeze
from ssl_cr_histo_tpu_torch.train.state import FinetuneState, TrainState


def init_triplet_state(model_name: str, device: torch.device, lr: float = 0.01,
                       weight_decay: float = 1e-4) -> TrainState:
    """TripletNet + 6-way Classifier on ``device`` with SGD-Nesterov,
    initialised from the global torch generator (seed it first), and the
    Lookahead slow weights."""
    model = TripletNet(model_name).to(device)
    clf = Classifier(feature_dim(model_name), 6).to(device)
    params = list(model.parameters()) + list(clf.parameters())
    opt = optim.sgd_nesterov(params, lr, momentum=0.9, weight_decay=weight_decay)
    return TrainState(model, clf, opt, slow=[p.detach().clone() for p in params])


def init_finetune_state(
    model_name: str,
    num_classes: int,
    device: torch.device,
    make_optimizer: Callable[[List[torch.nn.Parameter]], torch.optim.Optimizer],
    modules: int = 0,
    milestones_steps: Iterable[int] = (),
    gamma: float = 0.1,
) -> FinetuneState:
    """TripletNet + FinetuneHead on ``device``, initialised from the global
    torch generator (seed it first).  The first ``modules`` tensors of the
    TripletNet are frozen (``train.freeze``); ``make_optimizer`` gets the
    trainable ones, backbone then head, and the MultiStep schedule wraps
    the optimizer it returns."""
    model = TripletNet(model_name).to(device)
    head = FinetuneHead(feature_dim(model_name), num_classes).to(device)
    freeze(model, modules)
    params = [p for p in model.parameters() if p.requires_grad] + list(head.parameters())
    opt = make_optimizer(params)
    return FinetuneState(model, head, opt, optim.multistep_schedule(opt, milestones_steps, gamma))


def load_backbone(state: FinetuneState, path: str) -> FinetuneState:
    """Stage handoff: load the backbone, the pairwise fc and the BN
    statistics from a pretraining checkpoint's ``'model'`` state_dict (the
    port's ``.pth``, or the reference's, whose keys may carry DataParallel's
    ``module.`` prefix), in place, keeping the fresh head
    (``init.py:49-59``; reference eval_BreastPathQ_SSL.py:342-353)."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = raw["model"] if isinstance(raw, dict) and "model" in raw else raw
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    state.model.load_state_dict(sd)
    return state
