"""Epoch helpers: CSV log, best-validation retention, Lookahead per epoch.

Counterpart of ``ssl_cr_histo_tpu/train/loop.py:20-92`` (whose module
imports jax through ``train.optim``).  Under data parallelism only the
primary process writes (``loop.py:23-33``).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

from ssl_cr_histo_tpu_torch.parallel.distributed import is_primary
from ssl_cr_histo_tpu_torch.train import optim
from ssl_cr_histo_tpu_torch.train.checkpoint import Generators, save_checkpoint
from ssl_cr_histo_tpu_torch.train.state import FinetuneState, TrainState


class CsvLogger:
    """Append-only CSV with a fixed header (reference
    pretrain_BreastPathQ.py:272-273, 289-290), written by the primary
    process only."""

    def __init__(self, path: str, header: str):
        self.path = path
        self.primary = is_primary()
        if not self.primary:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write(header.rstrip("\n") + "\n")

    def append(self, *values):
        if not self.primary:
            return
        with open(self.path, "a") as f:
            f.write(",".join(f"{v:.6f}" if isinstance(v, float) else str(v) for v in values) + "\n")


def lookahead_epoch(state: TrainState, la_steps: int = 5, la_alpha: float = 0.5) -> TrainState:
    """The reference's per-epoch Lookahead 'scheduler' step
    (pretrain_BreastPathQ.py:247, 293), in place."""
    if state.slow is not None:
        state.la_count = optim.lookahead_epoch_sync(
            [p.data for p in state.parameters()], state.slow, state.la_count, la_steps, la_alpha)
    return state


@dataclass
class BestTracker:
    """Best-validation checkpoint (``best.pth``) of either stage, optionally
    gated to epochs after ``gate_epoch`` (80 for Camelyon16,
    pretrain_Camelyon16.py:307), with the run's ``generators`` in it.
    Every process tracks the same global metric, so all take the same
    decision; ``save_checkpoint`` writes on the primary only."""

    save_dir: str
    mode: str = "min"
    gate_epoch: int = 0
    best: float = field(default=math.inf)
    generators: Generators = field(default_factory=dict)

    @property
    def best_value(self) -> "float | None":
        if not math.isfinite(self.best):
            return None
        return self.best if self.mode == "min" else -self.best

    def restore(self, value: float) -> None:
        """Re-arm from a saved best value on resume (``loop.py:73-75``)."""
        self.best = value if self.mode == "min" else -value

    def update(self, value: float, epoch: int, state: "TrainState | FinetuneState", meta: dict) -> bool:
        if not math.isfinite(value):
            # a diverged metric must never become the best
            return False
        v = value if self.mode == "min" else -value
        if epoch <= self.gate_epoch or v >= self.best:
            return False
        self.best = v
        save_checkpoint(os.path.join(self.save_dir, "best.pth"), state,
                        dict(meta, best=value, best_val=value), self.generators)
        return True
