"""The numbers that decide ``correct`` for a training cell.

Set-up drives the program's training step from the seed through its first
steps, through the window's own ``run`` and feed; the reference follows the
first three from the same inputs.  Three numbers compare them:

- ``loss_gap``: the largest relative gap of a step's loss, over the three
  steps;
- ``grad_gap``: the first gradient as the optimizer gets it (weight decay
  included), worked out from the optimizer's state after one step; for each
  leaf the gap between the program's norm and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
  the worst leaf;
- ``update_gap``: the same of each leaf's change over the three steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (they move by round-off alone).

Where the feed is the program's (the pretraining cells' sampler), a fourth
number, ``feed_mismatch``, counts the triplets of those steps that differ
from the reference's own reading of the slides; its limit is 0.
"""

from __future__ import annotations

import math
import statistics

ROUND_OFF_SHARE = 1e-3


def leaf_gap(prog: dict, ref: dict, leaves) -> tuple:
    """(worst relative gap of norms, its leaf) over ``leaves``; NaN where a
    norm is missing or not finite."""
    floor = statistics.median(ref[k] for k in ref)
    worst = (0.0, "")
    for k in leaves:
        gap = abs(prog.get(k, math.nan) - ref[k]) / max(ref[k], floor)
        if not gap <= worst[0]:
            worst = (gap, k)
            if math.isnan(gap):
                break
    return worst


def median_gap(prog: dict, ref: dict, leaves) -> float:
    """The median leaf's relative gap of norms; NaN where a norm is
    missing or not finite."""
    gaps = [abs(prog.get(k, math.nan) - ref[k]) / ref[k] for k in leaves if ref[k] > 0]
    return math.nan if any(math.isnan(g) for g in gaps) else statistics.median(gaps)


def training_gaps(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {'loss': [3 floats], 'grad': {leaf: norm},
    'update': {leaf: norm}}.  Returns {name: (value, detail)}: the three
    numbers above, and beside them the first step's loss gap and the
    median leaf's gaps."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    floor = statistics.median(ref["grad"].values())
    moving = [k for k, g in ref["grad"].items() if g >= ROUND_OFF_SHARE * floor]
    grad = leaf_gap(prog["grad"], ref["grad"], ref["grad"])
    update = leaf_gap(prog["update"], ref["update"], moving)
    return {
        "loss_gap": (max(losses), f"steps {', '.join(f'{v:.3e}' for v in losses)}"),
        "grad_gap": grad,
        "update_gap": (update[0], f"{update[1]}; {len(ref['grad']) - len(moving)} leaves left out"),
        "loss1_gap": (losses[0], "step 1"),
        "grad_median_gap": (median_gap(prog["grad"], ref["grad"], ref["grad"]), "median leaf"),
        "update_median_gap": (median_gap(prog["update"], ref["update"], moving), "median leaf"),
    }


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit, detail)]): correct when every number
    is within its limit (an unread number fails)."""
    rows, ok = [], True
    for name, limit in limits.items():
        value, detail = readings.get(name, (float("nan"), "not read"))
        ok = ok and value <= limit
        rows.append((name, value, limit, detail))
    return ok, rows
