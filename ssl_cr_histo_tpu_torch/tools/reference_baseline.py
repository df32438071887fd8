"""Measure a faithful CPU re-implementation of the reference's v1
pretraining augmentation pipeline, to ground ``tools.bench``'s
``vs_baseline``.

The port's own copy of ``tools/measure_reference_baseline.py``: the same
ops and the same draws.  The reference (srinidhiPY/SSL_CR_Histo) runs its
augmentation stack inside torch DataLoader worker processes on the CPU (8
workers, reference pretrain_BreastPathQ.py:212-216); the GPUs only see
tensors already augmented.  Its cost a sample is the 8-op albumentations
pool applied to each of the 3 tiles of a triplet, including the O(pixels)
pure-Python HED loop (reference dataset.py:93-96).  The pipeline is bound
by its augmentation, so its end-to-end rate is about the worker count
times one worker's rate.

This module re-implements that pipeline in numpy and cv2 (the per-pixel
HED loop included), measures one process's patches/s over 8 triplets
after one warm-up, scales it by the reference's 8 workers, and writes
``reports/baseline_local.json`` (``--out``) with the host's CPU model and
core count beside the rate: the number is this host's, measured where the
card's program runs.

    python3 -m ssl_cr_histo_tpu_torch.tools.reference_baseline [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import random
import time

import numpy as np

S = 256  # reference tile size (256x256, BASELINE.md)
TRIPLETS = 8  # timed triplets
WORKERS = 8  # reference num_workers (pretrain_BreastPathQ.py:212-216)
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "reports", "baseline_local.json")

RGB_FROM_HED = np.array(
    [[0.65, 0.70, 0.29], [0.07, 0.99, 0.11], [0.27, 0.57, 0.78]], np.float32
)
HED_FROM_RGB = np.linalg.inv(RGB_FROM_HED).astype(np.float32)


def rgb2hed(img_u8):
    rgb = img_u8.astype(np.float32) / 255.0 + 2.0
    return np.dot(-np.log(rgb), HED_FROM_RGB)


def hed2rgb(hed):
    rgb2 = np.exp(-np.dot(hed, RGB_FROM_HED))
    return np.clip((rgb2 - 1.0) / 2.0, 0.0, 1.0)


def colour_augmentation(image):
    """Transcription of reference dataset.py:75-107, including the
    O(pixels) pure-Python loop (the reference's dominant CPU cost)."""
    ihc_hed = rgb2hed(image)
    im_size = image.shape[1]
    h = ihc_hed[:, :, 0]
    d = ihc_hed[:, :, 1]
    e = ihc_hed[:, :, 2]
    hflat = np.ravel(h, order="A")
    dflat = np.ravel(d, order="A")
    eflat = np.ravel(e, order="A")
    hmod = random.normalvariate(0, random.uniform(-0.035, 0.035))
    dmod = random.normalvariate(0, random.uniform(-0.035, 0.035))
    emod = random.normalvariate(0, random.uniform(-0.035, 0.035))
    for x in range(len(h.ravel())):  # the reference's per-pixel Python loop
        hflat[x] = hflat[x] + hmod
        dflat[x] = dflat[x] + dmod
        eflat[x] = eflat[x] + emod
    h = hflat.reshape(im_size, im_size)
    d = dflat.reshape(im_size, im_size)
    e = eflat.reshape(im_size, im_size)
    zdh = np.stack((h, d, e), 2)
    return (hed2rgb(zdh) * 255).astype(np.uint8)


def hsv_op(img):
    import cv2

    if random.random() < 0.5:
        return img
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] + int(random.uniform(-0.1, 0.1))) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] + int(random.uniform(-1, 1)), 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] + int(random.uniform(-20, 20)), 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


def noise_op(img):
    if random.random() < 0.5:
        return img
    sigma = random.uniform(0, 0.1 * 255)
    out = img.astype(np.float32) + np.random.normal(0, max(sigma, 1e-6), img.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def _rotate(img, limit):
    import cv2

    angle = random.uniform(-limit, limit)
    m = cv2.getRotationMatrix2D((S / 2, S / 2), angle, 1.0)
    return cv2.warpAffine(
        img, m, (S, S), flags=cv2.INTER_CUBIC, borderMode=cv2.BORDER_REFLECT_101
    )


def scale_resize_crop(img):
    import cv2

    if random.random() < 0.5:
        img = _rotate(img, 90)
    big = cv2.resize(img, (S + 20, S + 20), interpolation=cv2.INTER_CUBIC)
    ox, oy = random.randint(0, 20), random.randint(0, 20)
    return big[oy : oy + S, ox : ox + S]


def shift_scale_rotate(img):
    import cv2

    if random.random() < 0.5:
        img = img[:, ::-1]
    if random.random() < 0.5:
        return np.ascontiguousarray(img)
    angle = random.uniform(-45, 45)
    scale = random.uniform(0.5, 1.5)
    dx = random.uniform(-0.0625, 0.0625) * S
    dy = random.uniform(-0.0625, 0.0625) * S
    m = cv2.getRotationMatrix2D((S / 2, S / 2), angle, scale)
    m[:, 2] += (dx, dy)
    return cv2.warpAffine(
        np.ascontiguousarray(img), m, (S, S), flags=cv2.INTER_CUBIC,
        borderMode=cv2.BORDER_REFLECT_101,
    )


def blur_op(img):
    import cv2

    if random.random() < 0.5:
        return img
    k = random.choice([3, 5, 7])
    return cv2.blur(img, (k, k))


def brightness_contrast(img):
    if random.random() < 0.5:
        return img
    alpha = 1.0 + random.uniform(-0.2, 0.2)
    beta = random.uniform(-0.2, 0.2) * 255
    return np.clip(img.astype(np.float32) * alpha + beta, 0, 255).astype(np.uint8)


def rotate_crop(img):
    if random.random() < 0.5:
        return img
    return _rotate(img, 90)


POOL = [
    hsv_op,
    noise_op,
    scale_resize_crop,
    shift_scale_rotate,
    colour_augmentation,
    blur_op,
    brightness_contrast,
    rotate_crop,
]


def augment_triplet(tiles):
    """All 8 pool ops in a random order, the same order for the 3 tiles
    (reference dataset.py:166-213)."""
    ops = list(POOL)
    random.shuffle(ops)
    out = []
    for tile in tiles:
        t = tile
        for op in ops:
            t = op(t)
        out.append(t)
    return out


def cpu_model() -> str:
    """The host's CPU as /proc/cpuinfo describes its first processor: its
    model name or, where that is missing or 'unknown' (a virtual machine
    may hide it), its vendor, family, model and clock; 'unknown' without
    /proc/cpuinfo."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        return "unknown"
    name = info.get("model name", "unknown")
    if name != "unknown":
        return name
    return (f"{info.get('vendor_id', '?')} family {info.get('cpu family', '?')} model {info.get('model', '?')}, "
            f"{info.get('cpu MHz', '?')} MHz (no model name given)")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("the reference's CPU augmentation rate on this host")
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)

    rng = np.random.default_rng(0)
    tiles = [(rng.random((S, S, 3)) * 255).astype(np.uint8) for _ in range(3)]
    augment_triplet(tiles)  # warm-up
    t0 = time.time()
    for _ in range(TRIPLETS):
        augment_triplet(tiles)
    per_triplet = (time.time() - t0) / TRIPLETS
    result = {
        "reference_aug_patches_per_sec": 3.0 / per_triplet * WORKERS,
        "per_triplet_seconds_single_worker": per_triplet,
        "assumed_workers": WORKERS,
        "tile_size": S,
        "host_cpu": cpu_model(),
        "host_arch": platform.machine(),
        "host_cpu_count": os.cpu_count(),
        "methodology": (
            "Faithful numpy/cv2 transcription of the reference v1 pretraining augmentation pool incl. the "
            "O(pixels) Python HED loop (dataset.py:75-152), measured single-process on this host and scaled by "
            "the reference's 8 DataLoader workers. The reference pipeline is augmentation-bound, so this "
            "approximates its end-to-end patches/sec."
        ),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2), flush=True)
    return result


if __name__ == "__main__":
    main()
