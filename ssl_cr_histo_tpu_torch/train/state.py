"""Training state of the pretraining stage."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from ssl_cr_histo_tpu_torch.models import Classifier, TripletNet


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
