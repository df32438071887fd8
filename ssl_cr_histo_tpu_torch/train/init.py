"""State initialization and the stage handoff (counterpart of
``ssl_cr_histo_tpu/train/init.py``).  Under data parallelism every process
seeds alike, and the initial parameters and buffers are broadcast from the
primary besides, so that all processes start from one state whatever their
devices' initialisers do; the modules are not wrapped (no ``module.`` keys,
and no ``DistributedDataParallel``: see ``parallel.distributed``).

A run from no checkpoint starts from each backbone's own initialisation,
made when the modules are built: a ResNet's flax one (``models/resnet.py``,
as the JAX package's), the ViT's timm one (``models/vit.py``); the heads
start as flax's Dense (``resnet.lecun_normal_``).

A ResNet trunk put on a CUDA device takes the channels-last layout
(``resnet.apply_device_layout``) before its optimizer, Lookahead's slow
weights or a teacher copy it, so those take that layout too."""

from __future__ import annotations

import copy
from typing import Callable, Iterable, List

import torch

from ssl_cr_histo_tpu_torch.models import Classifier, FinetuneHead, TripletNet, feature_dim
from ssl_cr_histo_tpu_torch.models.resnet import apply_device_layout
from ssl_cr_histo_tpu_torch.parallel.distributed import broadcast_
from ssl_cr_histo_tpu_torch.train import optim
from ssl_cr_histo_tpu_torch.train.checkpoint import load_checkpoint
from ssl_cr_histo_tpu_torch.train.freeze import freeze
from ssl_cr_histo_tpu_torch.train.state import FinetuneState, Teacher, TrainState


def _broadcast_modules(*modules: torch.nn.Module) -> None:
    """Every floating parameter and buffer of ``modules`` set to the
    primary's, in place (a no-op in one process)."""
    broadcast_(t.data for m in modules for t in m.state_dict(keep_vars=True).values() if t.is_floating_point())


def init_triplet_state(model_name: str, device: torch.device, lr: float = 0.01,
                       weight_decay: float = 1e-4, remat: bool = False) -> TrainState:
    """TripletNet (``remat``: blocks recomputed in the backward pass) + 6-way
    Classifier on ``device`` with SGD-Nesterov, initialised from the global
    torch generator (seed it first), and the Lookahead slow weights."""
    model = TripletNet(model_name, remat=remat).to(device)
    clf = Classifier(feature_dim(model_name), 6).to(device)
    _broadcast_modules(model, clf)
    apply_device_layout(model)
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
    remat: bool = False,
) -> FinetuneState:
    """TripletNet (``remat``: blocks recomputed in the backward pass) +
    FinetuneHead on ``device``, initialised from the global torch generator
    (seed it first).  The first ``modules`` tensors of the TripletNet are
    frozen (``train.freeze``); ``make_optimizer`` gets the trainable ones,
    backbone then head, and the MultiStep schedule wraps the optimizer it
    returns."""
    model = TripletNet(model_name, remat=remat).to(device)
    head = FinetuneHead(feature_dim(model_name), num_classes).to(device)
    _broadcast_modules(model, head)
    apply_device_layout(model)
    freeze(model, modules)
    params = [p for p in model.parameters() if p.requires_grad] + list(head.parameters())
    opt = make_optimizer(params)
    return FinetuneState(model, head, opt, optim.multistep_schedule(opt, milestones_steps, gamma))


def _state_dict(raw: dict, key: str) -> dict:
    """``raw[key]`` (or ``raw`` itself when it has no such entry) without
    DataParallel's ``module.`` key prefix."""
    sd = raw[key] if isinstance(raw, dict) and key in raw else raw
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def load_backbone(state: FinetuneState, path: str) -> FinetuneState:
    """Stage handoff: load the backbone, the pairwise fc and the BN
    statistics from a pretraining checkpoint's ``'model'`` state_dict (the
    port's ``.pth``, the reference's, whose keys may carry DataParallel's
    ``module.`` prefix, or a checkpoint directory of the JAX package), in
    place, keeping the fresh head (``init.py:49-59``, ``cli/finetune.py:
    213-226``; reference eval_BreastPathQ_SSL.py:342-353)."""
    state.model.load_state_dict(_state_dict(load_checkpoint(path), "model"))
    return state


def load_finetuned(state: FinetuneState, path: str) -> FinetuneState:
    """Stage 2 -> 3 handoff: load the TripletNet (``'model'``, BN statistics
    included) and the head (``'classifier'``) of a fine-tune checkpoint (the
    port's ``.pth``, the reference's, with or without ``module.``, or a
    checkpoint directory of the JAX package) into the student, in place;
    its optimizer and schedule stay fresh (``cli/consistency.py:188-194``;
    reference eval_BreastPathQ_SSL_CR.py:391-402)."""
    raw = load_checkpoint(path)
    if not isinstance(raw, dict) or "model" not in raw or "classifier" not in raw:
        raise ValueError(f"{path}: not a fine-tune checkpoint (needs 'model' and 'classifier')")
    state.model.load_state_dict(_state_dict(raw, "model"))
    state.head.load_state_dict(_state_dict(raw, "classifier"))
    return state


def init_serving_state(model_name: str, num_classes: int, device: torch.device, path: str) -> FinetuneState:
    """The serving model: a TripletNet and FinetuneHead loaded from a
    fine-tune or consistency checkpoint (``load_finetuned``), on ``device``
    in eval mode, without optimizer or schedule (the JAX heatmap CLI's
    restored state, ``cli/heatmap.py:57-66``)."""
    state = FinetuneState(TripletNet(model_name), FinetuneHead(feature_dim(model_name), num_classes), None, None)
    load_finetuned(state, path)
    apply_device_layout(state.model.to(device)).eval()
    state.head.to(device).eval()
    return state


def init_teacher(state: FinetuneState) -> Teacher:
    """A teacher equal to the student: copies of its TripletNet and head,
    parameters and BN buffers alike, in eval mode with ``requires_grad``
    off (the reference's deepcopy, eval_Kather_SSL_CR.py:582-583)."""
    teacher = Teacher(copy.deepcopy(state.model), copy.deepcopy(state.head))
    for m in (teacher.model, teacher.head):
        m.eval().requires_grad_(False)
    return teacher
