"""State initialization (counterpart of ``ssl_cr_histo_tpu/train/init.py``)."""

from __future__ import annotations

import torch

from ssl_cr_histo_tpu_torch.models import Classifier, TripletNet, feature_dim
from ssl_cr_histo_tpu_torch.train import optim
from ssl_cr_histo_tpu_torch.train.state import TrainState


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
