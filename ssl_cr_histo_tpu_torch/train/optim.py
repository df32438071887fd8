"""Optimizers, the fine-tune LR schedule and the reference's per-epoch
Lookahead.

Counterpart of ``ssl_cr_histo_tpu/train/optim.py``.  Pretraining config of
record: SGD(lr=0.01, momentum=0.9, nesterov, wd=1e-4), with Lookahead
(la_steps=5, la_alpha=0.5) stepped once per EPOCH, as the reference does
(pretrain_BreastPathQ.py:245-247, :293; the reference's extra optimizer step
inside that call is a defect not replicated).  Fine-tune: Adam 1e-4 (BPQ) /
1e-5 (Kather) or SGD-Nesterov 5e-4 (Camelyon16), wd 1e-4 added to the
gradient, MultiStepLR at epochs [30, 60] with gamma 0.1.
"""

from __future__ import annotations

from typing import Iterable, List

import torch


def sgd_nesterov(params: Iterable[torch.nn.Parameter], lr: float, momentum: float = 0.9,
                 weight_decay: float = 1e-4) -> torch.optim.SGD:
    """SGD with L2 added to the gradient, then Nesterov momentum
    (``optim.py:37-44`` is the optax equivalent)."""
    return torch.optim.SGD(params, lr=lr, momentum=momentum, nesterov=True,
                           weight_decay=weight_decay)


def adam(params: Iterable[torch.nn.Parameter], lr: float, weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam with L2 added to the gradient before the moments, torch's
    ``weight_decay`` (not AdamW's decoupled decay): the optax chain
    ``add_decayed_weights`` then ``adam`` (``optim.py:58-63``).  On CUDA
    parameters in its capturable form (``make_capturable``)."""
    return make_capturable(torch.optim.Adam(params, lr=lr, weight_decay=weight_decay))


def make_capturable(optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """Put the param groups of CUDA parameters of an optimizer that has a
    capturable form (Adam, RAdam) in that form, in place, with the step
    counts it holds on the device: its bias corrections are then computed
    on the device, which a step captured as a CUDA graph
    (``parallel.steps.StepGraph``) needs.  Eager steps take the same form,
    so that eager and captured steps give the same numbers."""
    for group in optimizer.param_groups:
        if "capturable" not in group or not group["params"] or not group["params"][0].is_cuda:
            continue
        group["capturable"] = True
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(device=p.device, dtype=torch.float32)
    return optimizer


def radam(params: Iterable[torch.nn.Parameter], lr: float, weight_decay: float = 0.0) -> torch.optim.RAdam:
    """RAdam (rectified Adam) with L2 added to the gradient first: the
    optax chain ``add_decayed_weights`` then ``radam``
    (``optim.py:47-55``).  The reference vendors RAdam but never
    instantiates it; no stage CLI uses it."""
    return torch.optim.RAdam(params, lr=lr, weight_decay=weight_decay)


def multistep_schedule(optimizer: torch.optim.Optimizer, milestones_steps,
                       gamma: float = 0.1) -> torch.optim.lr_scheduler.MultiStepLR:
    """torch MultiStepLR with milestones in optimizer steps, stepped once
    after each ``optimizer.step()`` (``optim.py:30-34``).  The k-th update
    (1-based) runs at rate ``lr * gamma ** #{m : k - 1 >= m}``, which is
    optax's ``piecewise_constant_schedule`` read at its update count k - 1."""
    return torch.optim.lr_scheduler.MultiStepLR(optimizer, [int(m) for m in milestones_steps], gamma)


@torch.no_grad()
def lookahead_epoch_sync(params: List[torch.Tensor], slow: List[torch.Tensor], epoch_count: int,
                         la_steps: int = 5, la_alpha: float = 0.5) -> int:
    """Called once per epoch: every ``la_steps`` epochs pull the params toward
    the slow weights, p <- a*p + (1-a)*s, and recache s <- p, in place
    (``optim.py:122-146``).  Returns the updated epoch count."""
    epoch_count += 1
    if epoch_count < la_steps:
        return epoch_count
    for p, s in zip(params, slow):
        p.mul_(la_alpha).add_(s, alpha=1.0 - la_alpha)
        s.copy_(p)
    return 0
