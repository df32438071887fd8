"""The pretraining feed's first batches, worked out again from the slide
files.

RSP's v1 triplet geometry (reference ``dataset.py:322-384``): level l of a
slide is level l - 1 halved by 2x2 area averaging (rounded to nearest);
triplet positions lie on a grid of ``stride`` at level 2 (LR2), from
``stride`` to the level's size less the tile; a position is tissue where at
least 95% of its LR2 tile is tissue, which for the benchmark's slides
(``port_bench.slides``) is the share of the tile inside the tissue block;
the LR1 and HR tiles start at the level-0 projection of the LR2 tile's
centre, read at levels 1 and 0; out-of-slide pixels are white.  An epoch
is every position of every slide (files in name order, rows then columns)
in the order of ``numpy.random.default_rng(seed).permutation``, cut into
batches.
"""

from __future__ import annotations

import glob
import os

import numpy as np

LEVELS = 4
FOREGROUND_SHARE = 0.95


def pyramid(level0: np.ndarray) -> list:
    out = [level0]
    for _ in range(LEVELS - 1):
        a = out[-1].astype(np.int32)
        h, w = a.shape[0] // 2 * 2, a.shape[1] // 2 * 2
        a = a[:h, :w]
        out.append(((a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2] + a[1::2, 1::2] + 2) >> 2).astype(np.uint8))
    return out


def crop(level: np.ndarray, x: int, y: int, t: int) -> np.ndarray:
    out = np.full((t, t, 3), 255, np.uint8)
    y0, y1 = max(y, 0), min(y + t, level.shape[0])
    x0, x1 = max(x, 0), min(x + t, level.shape[1])
    if y1 > y0 and x1 > x0:
        out[y0 - y:y1 - y, x0 - x:x1 - x] = level[y0:y1, x0:x1]
    return out


def positions(slide_px: int, tissue: tuple, tile: int, stride: int) -> list:
    """(x, y) LR2 grid positions of one slide whose tile is tissue."""
    size = slide_px // 4
    lo, hi = tissue[0] // 4, tissue[1] // 4
    inside = lambda p: max(0, min(p + tile, hi) - max(p, lo))
    out = []
    for y in range(stride, size - 1 - tile, stride):
        for x in range(stride, size - 1 - tile, stride):
            if inside(x) * inside(y) / float(tile * tile) >= FOREGROUND_SHARE:
                out.append((x, y))
    return out


def first_batches(slide_dir: str, traffic: dict, seed: int, n_batches: int) -> np.ndarray:
    """(n_batches, B, 3, t, t, 3) uint8 [HR, LR1, LR2] triplets: the
    epoch's first batches for ``seed``."""
    t, stride, b = traffic["tile"], traffic["stride"], traffic["batch"]
    paths = sorted(glob.glob(os.path.join(slide_dir, "*.npy")))
    grid = positions(traffic["slide_px"], traffic["tissue"], t, stride)
    work = [(i, x, y) for i in range(len(paths)) for x, y in grid]
    order = np.random.default_rng(seed).permutation(len(work))[:n_batches * b]
    levels = {}
    out = np.empty((n_batches * b, 3, t, t, 3), np.uint8)
    for j, w in enumerate(order):
        i, x, y = work[w]
        if i not in levels:
            levels[i] = pyramid(np.load(paths[i]))
        lv = levels[i]
        cx, cy = 4 * x + 2 * t, 4 * y + 2 * t  # level-0 centre of the LR2 tile
        out[j] = np.stack([crop(lv[0], cx, cy, t), crop(lv[1], cx // 2, cy // 2, t), crop(lv[2], x, y, t)])
    return out.reshape(n_batches, b, 3, t, t, 3)
