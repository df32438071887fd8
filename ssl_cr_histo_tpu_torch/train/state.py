"""Training states of the pretraining, fine-tuning and consistency stages.
Each knows the dict its checkpoint holds
(``train.checkpoint.save_checkpoint``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from ssl_cr_histo_tpu_torch.models import Classifier, FinetuneHead, TripletNet


@dataclass
class TrainState:
    """The modules, their optimizer, and the reference's epoch-level
    Lookahead state (counterpart of ``ssl_cr_histo_tpu/train/state.py``).

    slow:      Lookahead slow weights, one tensor per trainable parameter
               (model then classifier); None when Lookahead is unused
    la_count:  epochs since the last Lookahead sync
    step:      optimizer steps taken
    """

    model: TripletNet
    classifier: Classifier
    optimizer: torch.optim.Optimizer
    slow: Optional[List[torch.Tensor]] = None
    la_count: int = 0
    step: int = 0

    def parameters(self) -> List[torch.nn.Parameter]:
        return list(self.model.parameters()) + list(self.classifier.parameters())

    def payload(self) -> dict:
        return {
            "model": self.model.state_dict(),
            "classifier": self.classifier.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "slow": self.slow,
            "la_count": self.la_count,
            "step": self.step,
        }


@dataclass
class FinetuneState:
    """Fine-tune state: the TripletNet (frozen tensors have
    ``requires_grad`` off, see ``train.freeze``), the head, the optimizer
    over the trainable tensors, the per-step LR schedule, and the optimizer
    steps taken.  A serving state (``train.init.init_serving_state``) has
    neither optimizer nor schedule."""

    model: TripletNet
    head: FinetuneHead
    optimizer: Optional[torch.optim.Optimizer]
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler]
    step: int = 0

    def payload(self) -> dict:
        return {
            "model": self.model.state_dict(),
            "classifier": self.head.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "step": self.step,
        }


@dataclass
class Teacher:
    """The consistency stage's teacher: a TripletNet and FinetuneHead pair
    in eval mode with ``requires_grad`` off, outside the optimizer, refreshed
    from the student (``parallel.steps.refresh_teacher`` / ``ema_update``).
    Its checkpoint has the student's layout without optimizer state."""

    model: TripletNet
    head: FinetuneHead

    def payload(self) -> dict:
        return {"model": self.model.state_dict(), "classifier": self.head.state_dict()}
