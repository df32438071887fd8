"""Camelyon16 lesion-level FROC evaluation: the port's own copy of
``ssl_cr_histo_tpu/eval/froc.py`` (numpy and scipy.ndimage on the host, on
the port's own annotations).

The reference stops at probability maps: ``test_Camelyon16.py:168-189``
saves ``.npy`` maps "for the FROC evaluation", which it delegates to the
official CAMELYON16 challenge tooling (outside the repo).  This module
implements that protocol in-framework, self-contained on numpy +
scipy.ndimage (host-side; FROC is O(detections), not a device workload):

* **candidate detections** — connected components of ``probs_map >=
  threshold``, each reported at its maximum-probability pixel (the standard
  candidate generator over heatmap outputs);
* **ground-truth lesions** — connected components of the tumor mask, with
  Isolated-Tumor-Cell exclusion: lesions whose major axis is shorter than
  the ITC cutoff (official rule: 200 um ITC definition + 75 um margin =
  275 um) are neither counted as lesions nor penalized when detected;
* **scoring** — a detection inside lesion L is a hit for L (best
  probability wins); inside an ITC lesion, ignored; anywhere else — or
  anywhere on a normal slide — a false positive.  The FROC curve is
  lesion sensitivity vs average false positives per slide over descending
  probability thresholds; the FROC score is the mean sensitivity at
  0.25 / 0.5 / 1 / 2 / 4 / 8 average FPs per slide.

The major-axis length uses the second-central-moment definition
(4 * sqrt(largest eigenvalue of the pixel-coordinate covariance)), matching
skimage ``regionprops.major_axis_length`` without the skimage dependency.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

from ssl_cr_histo_tpu_torch.data.annotations import Annotation

FP_RATES = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0)

# 8-connectivity: the official challenge tooling labels lesions and
# candidates with skimage measure.label's 2D default (8-connected);
# scipy's default structure is the 4-connected cross.
_EIGHT = np.ones((3, 3), dtype=bool)


def detect_candidates(
    probs_map: np.ndarray, threshold: float = 0.5
) -> Tuple[np.ndarray, np.ndarray]:
    """Candidate detections from a probability map: one per connected
    component of ``probs_map >= threshold``, located at the component's
    max-probability pixel.  Returns (probs (N,), coords (N, 2) int)."""
    labeled, n = ndimage.label(probs_map >= threshold, structure=_EIGHT)
    if n == 0:
        return np.zeros(0, np.float32), np.zeros((0, 2), np.int64)
    pos = ndimage.maximum_position(probs_map, labeled, np.arange(1, n + 1))
    coords = np.asarray(pos, np.int64).reshape(n, 2)
    probs = probs_map[coords[:, 0], coords[:, 1]].astype(np.float32)
    return probs, coords


def _major_axis_px(ys: np.ndarray, xs: np.ndarray) -> float:
    if len(ys) < 2:
        return 0.0
    pts = np.stack([ys, xs], axis=1).astype(np.float64)
    # population (1/N) covariance: skimage's major_axis_length derives from
    # normalized second central moments, not the N-1 sample estimator
    cov = np.cov(pts.T, bias=True)
    eig = np.linalg.eigvalsh(np.atleast_2d(cov))
    return float(4.0 * np.sqrt(max(float(eig[-1]), 0.0)))


def lesion_labels(
    gt_mask: np.ndarray, itc_diameter_px: float = 0.0
) -> Tuple[np.ndarray, int, set]:
    """Label GT lesions and flag ITCs.  Returns (labeled map, n_labels,
    itc label set); ``itc_diameter_px`` <= 0 disables ITC exclusion."""
    labeled, n = ndimage.label(gt_mask > 0, structure=_EIGHT)
    itc = set()
    if itc_diameter_px > 0 and n:
        for lbl, sl in enumerate(ndimage.find_objects(labeled), start=1):
            if sl is None:
                continue
            ys, xs = np.nonzero(labeled[sl] == lbl)
            if _major_axis_px(ys, xs) < itc_diameter_px:
                itc.add(lbl)
    return labeled, n, itc


@dataclass
class SlideDetections:
    """Detections for one slide.  ``gt_mask`` None (or empty) marks a
    normal slide: every detection on it is a false positive."""

    probs: np.ndarray
    coords: np.ndarray  # (N, 2) ints in the mask grid
    gt_mask: Optional[np.ndarray] = None


def evaluate_froc(
    slides: Sequence[SlideDetections], itc_diameter_px: float = 0.0
) -> Dict:
    """Score a slide set.  Returns the FROC score, the per-FP-rate
    sensitivities, and the full (avg_fps, sensitivity, thresholds) curve."""
    fp_probs: list = []
    lesion_best: list = []  # best hit probability per detected lesion
    total_lesions = 0
    n_slides = len(slides)
    for s in slides:
        if s.gt_mask is None or not np.any(s.gt_mask):
            fp_probs.extend(np.asarray(s.probs, np.float64).tolist())
            continue
        labeled, n, itc = lesion_labels(s.gt_mask, itc_diameter_px)
        total_lesions += n - len(itc)
        best: Dict[int, float] = {}
        for p, (y, x) in zip(np.asarray(s.probs, np.float64), np.asarray(s.coords)):
            lbl = int(labeled[int(y), int(x)])
            if lbl == 0:
                fp_probs.append(float(p))
            elif lbl in itc:
                continue  # ITC: neither hit nor penalty (official rule)
            else:
                best[lbl] = max(best.get(lbl, 0.0), float(p))
        lesion_best.extend(best.values())

    fp = np.sort(np.asarray(fp_probs, np.float64))
    tp = np.sort(np.asarray(lesion_best, np.float64))
    thresholds = np.unique(np.concatenate([fp, tp]))[::-1]
    if len(thresholds) == 0:
        thresholds = np.array([1.0])
    # counts of probs >= t via searchsorted on the ascending sorted arrays
    sens = (len(tp) - np.searchsorted(tp, thresholds, side="left")) / max(
        total_lesions, 1
    )
    avg_fps = (len(fp) - np.searchsorted(fp, thresholds, side="left")) / max(
        n_slides, 1
    )
    sens_at = np.interp(FP_RATES, avg_fps, sens)  # avg_fps ascends with index
    return {
        "froc": float(np.mean(sens_at)),
        "sens_at_fp": {r: float(v) for r, v in zip(FP_RATES, sens_at)},
        "avg_fps": avg_fps,
        "sensitivity": sens,
        "thresholds": thresholds,
        "total_lesions": int(total_lesions),
        "n_slides": int(n_slides),
        "n_false_positives": int(len(fp)),
    }


def evaluate_probs_maps(
    pairs: Sequence[Tuple[np.ndarray, Optional[np.ndarray]]],
    threshold: float = 0.5,
    itc_diameter_px: float = 0.0,
) -> Dict:
    """Convenience: (probs_map, gt_mask-or-None) pairs -> FROC result."""
    slides = []
    for probs_map, gt in pairs:
        probs, coords = detect_candidates(probs_map, threshold)
        slides.append(SlideDetections(probs, coords, gt))
    return evaluate_froc(slides, itc_diameter_px)


def rasterize_annotation(
    json_path: str, shape: Tuple[int, int], resolution: int
) -> np.ndarray:
    """Rasterize a Camelyon16 annotation JSON (level-0 vertex coordinates)
    onto the heatmap mask grid: grid cell (x, y) samples level-0 point
    (x * resolution, y * resolution), the patch-center convention of the
    sliding window (reference dataset.py:983-996)."""
    ann = Annotation().from_json(json_path)
    xs, ys = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]), indexing="ij")
    coords = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float64) * resolution
    inside = ann.inside_polygons_many(coords, is_positive=True)
    # exclusion holes: ASAP group '_2' maps to the JSON 'negative' set
    # (annotations.py camelyon16xml2json) — those regions are NOT tumor
    if ann.polygons_negative:
        inside &= ~ann.inside_polygons_many(coords, is_positive=False)
    return inside.reshape(shape).astype(np.uint8)
