"""The pretraining cells' whole-slide images: seeded ``.npy`` slides written
once into a fixed directory inside the checkout.

Each slide is white (245) with a square block of tissue: a pink H&E-like
colour with uniform noise, so that the v1 foreground test (the LAB
a-channel above 1.15 times the slide's mean) passes on every tissue pixel
and fails on every white one.  The block's edges lie on multiples of 8
pixels, so no pixel of the pyramid's levels 1-3 mixes tissue and
background.  The slides are the same for every seed: a seed changes the
order in which their triplets are read, not the work.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

BACKGROUND = 245


def slide_params(traffic: dict) -> dict:
    keys = ("slides", "slide_px", "tissue", "tissue_rgb", "noise")
    return {k: traffic[k] for k in keys}


def slide_dir(root: str, traffic: dict) -> str:
    """The directory of this slide set under ``root``: named by a digest of
    its parameters, so another set never reads these files."""
    digest = hashlib.sha1(json.dumps(slide_params(traffic), sort_keys=True).encode()).hexdigest()[:12]
    return os.path.join(root, f"slides-{digest}")


def make_slide(traffic: dict, index: int) -> np.ndarray:
    px = traffic["slide_px"]
    lo, hi = traffic["tissue"]
    rng = np.random.default_rng(index)
    level0 = np.full((px, px, 3), BACKGROUND, np.uint8)
    noise = traffic["noise"]
    tissue = np.asarray(traffic["tissue_rgb"], np.int16) + rng.integers(-noise, noise, (hi - lo, hi - lo, 3),
                                                                       dtype=np.int16)
    level0[lo:hi, lo:hi] = np.clip(tissue, 0, 255)
    return level0


def ensure_slides(root: str, traffic: dict) -> str:
    """Write the slide set unless it is there; return its directory."""
    d = slide_dir(root, traffic)
    done = os.path.join(d, "complete")
    if os.path.exists(done):
        return d
    os.makedirs(d, exist_ok=True)
    for i in range(traffic["slides"]):
        path = os.path.join(d, f"slide{i:03d}.npy")
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            np.save(f, make_slide(traffic, i))
        os.replace(tmp, path)
    with open(done, "w") as f:
        json.dump(slide_params(traffic), f)
    return d
