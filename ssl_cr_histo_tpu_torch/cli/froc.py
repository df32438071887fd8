"""Camelyon16 FROC evaluation over heatmap outputs: the port's copy of
``ssl_cr_histo_tpu/cli/froc.py`` (host-side numpy and scipy; no device).

Closes the reference's external-tooling gap: ``test_Camelyon16.py`` writes
probability maps "for the FROC evaluation" and stops; this CLI scores them
with the official challenge protocol (``eval/froc.py``).

Usage:
    python -m ssl_cr_histo_tpu_torch.cli.froc \
        --probs_map_path <dir of {wsi_id}.npy from cli.heatmap> \
        --gt_path <dir of {wsi_id}.npy masks and/or {wsi_id}.json annotations> \
        [--threshold 0.5] [--itc_um 275 --mask_mpp 7.78] [--out froc.json]

A slide with no ground-truth file under --gt_path is treated as a normal
slide (every detection on it is a false positive).  ``.json`` ground truth
(internal annotation format, see cli.convert_annotations) is rasterized
onto the heatmap grid with --resolution (the slide/mask downsample used by
cli.heatmap).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from ssl_cr_histo_tpu_torch.eval.froc import (
    FP_RATES,
    detect_candidates,
    evaluate_froc,
    rasterize_annotation,
    SlideDetections,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser("Camelyon16 FROC evaluation")
    p.add_argument("--probs_map_path", required=True, help="dir of {wsi_id}.npy probability maps")
    p.add_argument("--gt_path", required=True,
                   help="dir of {wsi_id}.npy tumor masks / {wsi_id}.json annotations; "
                        "missing file = normal slide")
    p.add_argument("--threshold", type=float, default=0.5,
                   help="candidate-detection probability threshold")
    p.add_argument("--itc_um", type=float, default=0.0,
                   help="ITC exclusion cutoff in um (official: 275); 0 disables")
    p.add_argument("--mask_mpp", type=float, default=0.0,
                   help="um per heatmap-grid pixel (slide mpp x resolution); "
                        "required with --itc_um")
    p.add_argument("--resolution", type=int, default=256,
                   help="slide/mask downsample, for rasterizing .json ground truth")
    p.add_argument("--out", default="", help="optional JSON report path")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.itc_um > 0 and args.mask_mpp <= 0:
        raise SystemExit("--itc_um needs --mask_mpp to convert um to grid pixels")
    if args.itc_um <= 0:
        print(
            "WARNING: ITC exclusion is OFF (--itc_um 0).  The official "
            "CAMELYON16 FROC protocol excludes isolated tumor cells "
            "(< 275 um); scores without it are NOT comparable to published "
            "numbers.  Pass --itc_um 275 --mask_mpp <um/grid-px> for the "
            "official protocol."
        )
    itc_px = args.itc_um / args.mask_mpp if args.itc_um > 0 else 0.0

    map_paths = sorted(glob.glob(os.path.join(args.probs_map_path, "*.npy")))
    if not map_paths:
        raise SystemExit(f"no .npy probability maps under {args.probs_map_path}")

    slides, names, n_tumor = [], [], 0
    for mp in map_paths:
        wsi_id = os.path.splitext(os.path.basename(mp))[0]
        probs_map = np.load(mp)
        probs, coords = detect_candidates(probs_map, args.threshold)
        gt = None
        npy_gt = os.path.join(args.gt_path, f"{wsi_id}.npy")
        json_gt = os.path.join(args.gt_path, f"{wsi_id}.json")
        if os.path.exists(npy_gt):
            gt = np.load(npy_gt)
            if gt.shape != probs_map.shape:
                raise SystemExit(
                    f"{wsi_id}: GT mask shape {gt.shape} != probs map {probs_map.shape}"
                )
        elif os.path.exists(json_gt):
            gt = rasterize_annotation(json_gt, probs_map.shape, args.resolution)
        n_tumor += int(gt is not None and np.any(gt))
        slides.append(SlideDetections(probs, coords, gt))
        names.append(wsi_id)
        print(f"==> {wsi_id}: {len(probs)} candidates, "
              f"{'tumor' if gt is not None and np.any(gt) else 'normal'} slide")

    result = evaluate_froc(slides, itc_diameter_px=itc_px)
    print(f"\nslides: {result['n_slides']} ({n_tumor} tumor) | "
          f"lesions: {result['total_lesions']} | FPs: {result['n_false_positives']}")
    for r in FP_RATES:
        print(f"sensitivity @ {r:>5} avg FPs/slide: {result['sens_at_fp'][r]:.4f}")
    print(f"FROC score: {result['froc']:.4f}")

    if args.out:
        report = {
            "froc": result["froc"],
            "sens_at_fp": {str(k): v for k, v in result["sens_at_fp"].items()},
            "total_lesions": result["total_lesions"],
            "n_false_positives": result["n_false_positives"],
            "n_slides": result["n_slides"],
            "threshold": args.threshold,
            "itc_um": args.itc_um,
            "slides": names,
            "curve": {
                "avg_fps": result["avg_fps"].tolist(),
                "sensitivity": result["sensitivity"].tolist(),
                "thresholds": result["thresholds"].tolist(),
            },
        }
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"==> wrote {args.out}")


if __name__ == "__main__":
    main()
