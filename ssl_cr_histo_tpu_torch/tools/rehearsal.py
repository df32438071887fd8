"""Production-shape rehearsal: the whole product at the reference configs of
record, through the port's CLIs, in one command.

The port's counterpart of ``tools/rehearsal.py``.  Three recipes, one per
task of record (--recipe):

  camelyon16 (default) -- pretrain -> fine-tune (16/class) -> consistency
      (8/class + mu=7) -> evaluation -> heatmap -> FROC, the complete recipe
      of reference README.md:57-62 plus test_Camelyon16.py.
  breastpathq -- pretrain -> regression fine-tune (batch 4, Adam 1e-4, MSE)
      -> MSE-consistency CR (batch 4 + mu=7) -> two-rater ICC/tau evaluation
      (eval_BreastPathQ_SSL{,_CR}.py).  ``--bpq_data arrays`` hands the
      CLIs' ``run`` functions the datasets the .h5 files would give, for a
      machine without h5py.
  kather -- 9-class fine-tune (batch 64, Adam 1e-5) -> hard-pseudo-label CR
      (batch 8 + mu=7) -> confusion/F1/OVR-AUC evaluation
      (eval_Kather_SSL{,_CR}.py).  Per reference semantics the backbone
      transfers from a Camelyon16 pretraining (eval_Kather_SSL.py:242-243):
      pass --stage1_ckpt from a camelyon16 rehearsal, else one is trained.

    python3 -m ssl_cr_histo_tpu_torch.tools.rehearsal --workdir RUN/ [--recipe kather] \\
        [--stage1_ckpt RUN/stage1/ckpt_25.pth] [--bpq_data arrays] [--device cuda]

Each recipe writes its report (stage seconds, loss and validation curves,
the evaluation metrics, the expected bands and any violation) to --out,
by default the original's file name under --workdir.  At --image_size 256
(the config of record) a metric outside its band (``BANDS``) fails the run;
smaller sizes (``--device cpu --image_size 32 ...``) rehearse the wiring,
and their metrics are noise.

Scaled-down knobs (--pretrain_epochs etc.) bound wall time; shapes and batch
semantics are never scaled down.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import tempfile
import time

import numpy as np

# --------------------------------------------------------------------------
# Synthetic data at reference shapes (``tools/rehearsal.py:42-340``, file
# for file the same bytes from the same arguments)
# --------------------------------------------------------------------------


def _tissue_texture(rng, h, w, base, nucleus_density=0.0006):
    """H&E-ish texture: base stain color + noise + dark nuclei dots."""
    img = np.clip(
        np.asarray(base, np.int16)[None, None, :]
        + rng.integers(-18, 18, (h, w, 3), dtype=np.int16),
        0, 255,
    ).astype(np.uint8)
    n_nuclei = int(h * w * nucleus_density)
    ys = rng.integers(2, h - 3, n_nuclei)
    xs = rng.integers(2, w - 3, n_nuclei)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            if dy * dy + dx * dx <= 4:
                img[ys + dy, xs + dx] = (
                    img[ys + dy, xs + dx].astype(np.int16) - 70
                ).clip(40, 255).astype(np.uint8)
    return img


TUMOR_BASE = (150, 70, 170)  # dense violet
NORMAL_BASE = (225, 160, 200)  # light pink


def make_pretrain_wsis(out_dir, n_slides=2, size=6400, seed=0):
    """v1-compatible WSIs: white background + strongly pink tissue block
    (the v1 LAB foreground test is relative to the slide-mean a-channel).

    The tissue carries multi-scale structure -- stroma ellipses plus nuclei
    discs with a fixed pixel footprint (radius 4-16 px at level 0, so 1-4 px
    at level 2) -- because the RSP pretext task is resolution-sequence
    prediction: the absolute feature scale is the learnable cue
    (reference dataset.py:27-70).  A flat noise texture has no scale cue
    that survives the v1 noise/blur augmentations."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    for i in range(n_slides):
        rng = np.random.default_rng(seed + i)
        level0 = np.full((size, size, 3), 245, np.uint8)
        m = size // 8
        ts = size - 2 * m
        tissue = _tissue_texture(rng, ts, ts, (190, 80, 160), nucleus_density=0.0)
        for _ in range(max(ts * ts // 60000, 8)):  # stroma blobs (lighter pink)
            color = np.clip(np.array((215, 130, 185)) + rng.normal(0, 10, 3), 0, 255)
            cv2.ellipse(
                tissue,
                (int(rng.integers(0, ts)), int(rng.integers(0, ts))),
                (int(rng.integers(ts // 60, ts // 15)), int(rng.integers(ts // 60, ts // 15))),
                float(rng.uniform(0, 180)), 0, 360,
                tuple(int(c) for c in color), -1,
            )
        for _ in range(max(ts * ts // 3000, 64)):  # nuclei discs (dark purple)
            color = np.clip(np.array((105, 55, 145)) + rng.normal(0, 12, 3), 0, 255)
            cv2.circle(
                tissue,
                (int(rng.integers(0, ts)), int(rng.integers(0, ts))),
                int(rng.integers(4, 17)),
                tuple(int(c) for c in color), -1,
            )
        level0[m:-m, m:-m] = tissue
        np.save(os.path.join(out_dir, f"slide{i}.npy"), level0)


# Per-patch "tumor intensity" t in [0, 1] controls both the stain color
# (lerp NORMAL_BASE -> TUMOR_BASE) and the nucleus density.  The two classes
# draw t from overlapping Beta distributions, plus a label-noise fraction
# drawn from the other class's distribution, so the synthetic task has an
# irreducible error and the headline metrics sit in a sensitive band
# (~0.85-0.96) instead of saturating at 1.0.
TUMOR_T = (5.0, 2.0)    # Beta(5,2): mean 0.71
NORMAL_T = (2.0, 5.0)   # Beta(2,5): mean 0.29 (pairwise AUC vs tumor ~0.94)
LABEL_NOISE = 0.05      # caps AUC/accuracy at ~1 - p even for a Bayes model


def _intensity_patch(rng, t, size):
    # The stain-color cue is compressed (lerp restricted to t in [0.3, 0.7])
    # and jittered per patch (~slide-to-slide stain variation), so color
    # alone cannot separate the classes; the reliable signal is nucleus
    # density, which a fresh head has to learn over several epochs.
    t_color = 0.3 + 0.4 * t
    base = tuple(
        int(round(np.clip(n + (u - n) * t_color + rng.normal(0, 15), 0, 255)))
        for n, u in zip(NORMAL_BASE, TUMOR_BASE)
    )
    return _tissue_texture(
        rng, size, size, base, nucleus_density=0.0005 + 0.0015 * t
    )


def _draw_t(rng, cls):
    a, b = TUMOR_T if cls == "tumor" else NORMAL_T
    if rng.random() < LABEL_NOISE:  # mislabeled: other class's appearance
        b, a = a, b
    return float(rng.beta(a, b))


def _camelyon_class_dir(out_dir, pid, coord, cls, n, size, rng):
    """One single-class patch dir: its own list.txt + line-indexed {i}.png
    (the reference ships each class as a separate directory,
    eval_Camelyon_SSL.py:226-233)."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "list.txt"), "w") as f:
        for i in range(n):
            f.write(f"{pid},{coord},{coord}\n")
            img = _intensity_patch(rng, _draw_t(rng, cls), size)
            cv2.imwrite(os.path.join(out_dir, f"{i}.png"), img[:, :, ::-1])
    return out_dir


def make_camelyon_patches(out_root, json_dir, n_per_class=300,
                          n_valid_per_class=None, size=256, seed=1):
    """Camelyon16 patch sets in the reference's directory layout: one TUMOR
    dir + one NORMAL dir per split, each with its own list.txt + line-indexed
    {i}.png, plus dedicated VALID dirs (eval_Camelyon_SSL.py:226-233
    --train_tumor_image_pth/--train_normal_image_pth + *_VALID) and polygon
    JSONs.  Class appearance overlaps and labels carry noise (see
    TUMOR_T/NORMAL_T/LABEL_NOISE).

    Returns (train_path, val_path): comma-joined dir pairs for the CLIs."""
    if n_valid_per_class is None:
        n_valid_per_class = max(n_per_class // 5, 4)
    rng = np.random.default_rng(seed)
    dirs = {}
    for split, n in (("patches", n_per_class), ("valid", n_valid_per_class)):
        for cls, pid, coord in (
            ("tumor", "Tumor_026", 50),
            ("normal", "Normal_040", 500),
        ):
            dirs[f"{split}_{cls}"] = _camelyon_class_dir(
                os.path.join(out_root, f"{split}_{cls}"),
                pid, coord, cls, n, size, rng,
            )
    os.makedirs(json_dir, exist_ok=True)
    tumor_doc = {
        "positive": [{"name": "t", "vertices": [[0, 0], [100, 0], [100, 100], [0, 100]]}],
        "negative": [],
    }
    with open(os.path.join(json_dir, "Tumor_026.json"), "w") as f:
        json.dump(tumor_doc, f)
    with open(os.path.join(json_dir, "Normal_040.json"), "w") as f:
        json.dump({"positive": [], "negative": []}, f)
    return (
        f"{dirs['patches_tumor']},{dirs['patches_normal']}",
        f"{dirs['valid_tumor']},{dirs['valid_normal']}",
    )


def _lesion_boxes(g):
    """Grid-cell boxes (y0, y1, x0, x1, t) of the two embedded lesions, a
    pure function of the grid size so reporting can recompute them on
    --skip_data reruns: a strong macro lesion at the slide center (t=0.85)
    and a subtle one near the tissue edge (t=0.55 -- inside the
    class-overlap region, so part of its patches legitimately score low and
    FROC sensitivity stays off the 1.0 ceiling)."""
    mb = g // 8 + 1
    c = g // 2
    s = max(g // 4, 2)
    k = max(g // 6, 1)
    strong = (c, c + s, c, c + s, 0.85)
    subtle = (mb + 1, mb + 1 + k, mb + 1, mb + 1 + k, 0.55)
    return strong, subtle


def make_heatmap_slide(wsi_dir, mask_dir, gt_dir, size=8192, resolution=256, seed=7):
    """Two inference WSIs -- one with two embedded lesions (strong + subtle,
    ``_lesion_boxes``) and one all-normal -- plus tissue masks and
    grid-level ground truth.  Tissue appearance varies per grid cell with
    the same normal-intensity distribution as the training patches
    (NORMAL_T), so borderline cells exist on both slides: the normal slide
    feeds the FROC false-positive branch, and the subtle lesion keeps
    sensitivity in a band that can regress visibly."""
    os.makedirs(wsi_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    g = size // resolution
    mb = g // 8 + 1
    lesions = _lesion_boxes(g)

    def cell_slide(rng, with_lesions):
        level0 = np.full((size, size, 3), 245, np.uint8)
        for cy in range(mb, g - mb):
            for cx in range(mb, g - mb):
                t = float(rng.beta(*NORMAL_T))
                if with_lesions:
                    for y0, y1, x0, x1, tl in lesions:
                        if y0 <= cy < y1 and x0 <= cx < x1:
                            t = tl
                level0[
                    cy * resolution : (cy + 1) * resolution,
                    cx * resolution : (cx + 1) * resolution,
                ] = _intensity_patch(rng, t, resolution)
        return level0

    mask = np.zeros((g, g), bool)
    mask[mb : g - mb, mb : g - mb] = True

    level0 = cell_slide(np.random.default_rng(seed), with_lesions=True)
    np.save(os.path.join(wsi_dir, "t1.npy"), level0)
    np.save(os.path.join(mask_dir, "t1_mask.npy"), mask)
    gt = np.zeros((g, g), np.uint8)
    for y0, y1, x0, x1, _ in lesions:
        gt[y0:y1, x0:x1] = 1
    np.save(os.path.join(gt_dir, "t1.npy"), gt)

    np.save(os.path.join(wsi_dir, "n1.npy"),
            cell_slide(np.random.default_rng(seed + 1), with_lesions=False))
    np.save(os.path.join(mask_dir, "n1_mask.npy"), mask)
    return g


def _cellularity_patch(rng, score, size):
    """BreastPathQ-like patch whose learnable signal is the label: nucleus
    density scales with the cellularity score in [0, 1] (the task the
    reference regresses, eval_BreastPathQ_SSL.py).  The density carries
    sampling noise worth ~0.1 score units, so even a Bayes regressor has
    irreducible MSE and the ICC/tau metrics sit below the 1.0 ceiling."""
    density = max(0.004 * float(score) + float(rng.normal(0.0, 0.0004)), 0.0)
    return _tissue_texture(rng, size, size, NORMAL_BASE, nucleus_density=density)


def breastpathq_arrays(n_train=240, n_eval=64, size=256, seed=3):
    """The BreastPathQ data as the reference's .h5 contract holds it
    (dataset.py:453-536): {'train', 'eval_a', 'eval_b'} -> (x float32 CHW in
    [0, 1], y float32 cellularity scores).  The two eval sets hold the same
    patches scored by two raters (TestSetSherine/TestSetSharon layout,
    dataset.py:539-599): rater B = rater A + observer noise."""
    rng = np.random.default_rng(seed)

    def pack(imgs, ys):
        x = np.stack(imgs).astype(np.float32).transpose(0, 3, 1, 2) / 255.0
        return x, np.asarray(ys, np.float32)

    y_train = rng.uniform(0.0, 1.0, n_train)
    train = pack([_cellularity_patch(rng, y, size) for y in y_train], y_train)
    y_a = rng.uniform(0.0, 1.0, n_eval)
    eval_imgs = [_cellularity_patch(rng, y, size) for y in y_a]
    # observer noise sigma=0.1 puts the rater-rater ICC ceiling at
    # var(U(0,1)) / (var + 0.01) ~ 0.89 -- a sensitive, non-saturated band
    y_b = np.clip(y_a + rng.normal(0.0, 0.10, n_eval), 0.0, 1.0)
    return {"train": train, "eval_a": pack(eval_imgs, y_a), "eval_b": pack(eval_imgs, y_b)}


def require_h5py():
    """SystemExit naming ``--bpq_data arrays`` where h5py is missing."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        raise SystemExit("--bpq_data h5 writes and reads .h5 files, and h5py is not installed; "
                         "pass --bpq_data arrays to hand the stage CLIs the same datasets in memory")


def make_breastpathq_h5(train_dir, eval_a_dir, eval_b_dir,
                        n_train=240, n_eval=64, size=256, seed=3):
    """``breastpathq_arrays`` written as the reference's .h5 files:
    ``train.h5`` under ``train_dir`` and ``eval.h5`` under each rater's
    dir, each with data['x'] and data['y']."""
    import h5py

    data = breastpathq_arrays(n_train, n_eval, size, seed)
    for d, name, key in ((train_dir, "train.h5", "train"), (eval_a_dir, "eval.h5", "eval_a"),
                         (eval_b_dir, "eval.h5", "eval_b")):
        os.makedirs(d, exist_ok=True)
        x, y = data[key]
        with h5py.File(os.path.join(d, name), "w") as f:
            f.create_dataset("x", data=x)
            f.create_dataset("y", data=y)


# 9 separable stain/tissue palettes, one per Kather class (ADI..TUM order)
KATHER_BASES = (
    (235, 220, 190), (248, 248, 248), (180, 140, 200), (120, 90, 180),
    (200, 200, 240), (220, 120, 140), (230, 170, 190), (190, 160, 220),
    (150, 70, 170),
)


KATHER_JITTER = 22.0  # per-patch palette jitter sigma: the nearest class
# centers are ~50 RGB-norm apart, so patches genuinely overlap at the
# boundaries and the 9-way metrics sit below their ceilings


def make_kather_folder(out_dir, n_per_class=40, size=224, seed=5):
    """Reference folder-per-class layout (dataset.py:1002-1071): 9 class
    dirs ADI..TUM of .tif patches, each class with a distinct palette, with
    per-patch palette jitter (KATHER_JITTER) plus LABEL_NOISE drawn from a
    random other class's palette, so accuracy/F1/OVR-AUC cannot saturate at
    1.0."""
    import cv2

    from ssl_cr_histo_tpu_torch.data.datasets import KATHER_CLASSES

    rng = np.random.default_rng(seed)
    for c, (cls, base) in enumerate(zip(KATHER_CLASSES, KATHER_BASES)):
        d = os.path.join(out_dir, cls)
        os.makedirs(d, exist_ok=True)
        for i in range(n_per_class):
            b = base
            if rng.random() < LABEL_NOISE:  # mislabeled patch
                b = KATHER_BASES[(c + int(rng.integers(1, 9))) % 9]
            b = tuple(np.clip(np.asarray(b) + rng.normal(0, KATHER_JITTER, 3),
                              0, 255).astype(int))
            img = _tissue_texture(rng, size, size, b, nucleus_density=0.0008)
            cv2.imwrite(os.path.join(d, f"{cls}-{i:04d}.tif"), img[:, :, ::-1])


# --------------------------------------------------------------------------
# Stage drivers
# --------------------------------------------------------------------------


def _size_argv(args):
    """--image_size passthrough for the stage CLIs when rehearsing the
    recipe below the 256^2 config of record.  The sentinel 256 passes
    nothing, so every task keeps its own default (incl. Kather's 224)."""
    return ["--image_size", str(args.image_size)] if args.image_size != 256 else []


def _csv_rows(path):
    with open(path) as f:
        lines = f.read().strip().splitlines()[1:]
    return [[float(v) for v in ln.split(",") if v.strip() != ""] for ln in lines]


def _fresh_dir(path):
    """Stage save_dirs must start empty: CsvLogger appends, so rerunning a
    recipe into the same workdir would report doubled metric rows."""
    import shutil

    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)
    return path


def _platform(device: str) -> str:
    """The card's ``nvidia-smi`` name and power limit under a CUDA device,
    else ``cpu``."""
    if not device.startswith("cuda"):
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"{device} (nvidia-smi failed: {exc})"
    lines = out.stdout.strip().splitlines()
    index = int(device.split(":")[1]) if ":" in device else 0
    return lines[min(index, len(lines) - 1)] if lines else device


def _finalize_report(args, report):
    """Fill the run-level fields and write the report JSON (also called on
    a mid-recipe failure, so partial stage data always lands on disk)."""
    report["total_seconds"] = round(
        sum(s.get("seconds", 0) for s in report["stages"].values()), 1
    )
    report["platform"] = _platform(args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)


def _cli_argv(args):
    """Flags every stage CLI takes from the rehearsal."""
    return ["--device", args.device, *_size_argv(args)]


@contextlib.contextmanager
def _plots_where_drawable():
    """The evaluation's plots (``eval.reporting``) need matplotlib.  Where
    it is missing, the plot writers are swapped for recorders for the
    block, which yields the list of the file names not drawn; the metrics
    and the JSON are unaffected."""
    not_drawn = []
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        pass
    else:
        yield not_drawn
        return
    from ssl_cr_histo_tpu_torch.eval import reporting as RP

    names = ("save_confusion_matrix_plot", "save_scatter_plot", "save_bland_altman_plot")
    real = {name: getattr(RP, name) for name in names}
    for name in names:
        setattr(RP, name, lambda *a, **kw: not_drawn.append(os.path.basename(str(a[-1]))))
    try:
        yield not_drawn
    finally:
        for name, fn in real.items():
            setattr(RP, name, fn)


def _stage_args(cli, stage, argv):
    """A stage CLI's parsed ``argv`` and task config, as its ``main``
    resolves them."""
    from ssl_cr_histo_tpu_torch.cli.common import TASKS, apply_reference_exact, apply_task_overrides

    args = apply_reference_exact(cli.parse_args(argv), stage)
    return args, apply_task_overrides(args, TASKS[args.task])


def _run_stage_cli(cli, stage, argv, data=None):
    """``cli.main(argv)``; with ``data`` (a loaded dataset in place of
    --train_path's) what ``main`` does after loading it: the seeded
    validation split, the labeled subsample and ``cli.run``."""
    if data is None:
        return cli.main(argv)
    from ssl_cr_histo_tpu_torch.cli.finetune import subsample_labeled
    from ssl_cr_histo_tpu_torch.data.datasets import train_val_split

    args, cfg = _stage_args(cli, stage, argv)
    train, val = train_val_split(data, args.validation_split, seed=args.seed)
    labeled = subsample_labeled(train, args, cfg)
    if stage == "finetune":
        return cli.run(args, cfg, labeled, val)
    return cli.run(args, cfg, labeled, train, val)


def stage_pretrain(args, W, report):
    """Stage 1: RSP pretraining at the config of record (BASELINE.md: 256^2
    tiles, batch 64, v1 pool, SGD-Nesterov+Lookahead).  Returns the
    checkpoint path; honors --stage1_ckpt (reuse a previous rehearsal's
    stage 1 -- the reference itself transfers one pretraining across tasks,
    eval_Kather_SSL.py:242-243)."""
    import torch

    from ssl_cr_histo_tpu_torch.cli import pretrain

    if args.stage1_ckpt:
        report["stages"]["pretrain"] = {"reused": args.stage1_ckpt}
        print(f"== pretrain reused: {args.stage1_ckpt}")
        return args.stage1_ckpt

    tile = args.image_size
    if not args.skip_data:
        # 25 tiles across, as in the 6400/256 config of record
        make_pretrain_wsis(os.path.join(W, "wsis"), size=25 * tile)
    s1 = _fresh_dir(os.path.join(W, "stage1"))
    t0 = time.time()
    pretrain.main([
        "--train_image_pth", os.path.join(W, "wsis"),
        "--variant", "v1",
        "--tile_h", str(tile), "--tile_w", str(tile),
        # stride tile/4 so 2 slides yield ~1600 train positions (a stride of
        # tile/2 leaves ~40: one batch-64 step an epoch)
        "--tile_stride", str(tile // 4),
        "--cache_tiles",
        "--batch_size", "64",
        "--num_epoch", str(args.pretrain_epochs),
        "--steps_per_epoch", str(args.pretrain_steps_per_epoch),
        "--validation_size", "64",
        "--save_freq", str(args.pretrain_epochs),
        "--save_dir", s1,
        "--device", args.device,
    ])
    dt = time.time() - t0
    rows = _csv_rows(os.path.join(s1, "train_results.csv"))
    ckpt = os.path.join(s1, f"ckpt_{args.pretrain_epochs}.pth")
    # the optimizer steps taken, from the checkpoint: --steps_per_epoch caps
    # an epoch, and the slides may hold fewer full batches (the original
    # reports epochs x the cap)
    n_steps = int(torch.load(ckpt, map_location="cpu", weights_only=False)["step"])
    val_accs = [r[4] for r in rows]
    report["stages"]["pretrain"] = {
        "seconds": round(dt, 1),
        "epochs": args.pretrain_epochs,
        "steps": n_steps,
        "steps_per_epoch_cap": args.pretrain_steps_per_epoch,
        "batch": 64, "tile": tile,
        "train_loss": [r[1] for r in rows],
        "val_loss": [r[3] for r in rows],
        "val_acc": val_accs,
        "val_acc_best": max(val_accs),
        "aug_patches_per_sec_incl_io": round(n_steps * 64 * 3 / dt, 1),
        "checkpoint": ckpt,
    }
    gc.collect()
    # The pretext task must learn at the config of record: the reference's
    # stage-1 deliverable is this accuracy curve
    # (pretrain_BreastPathQ.py:95-148); 6-way chance is 0.167.  Off below
    # 256^2: a CPU-sized rehearsal's budget is too small to clear the gate.
    min_acc = args.pretrain_min_acc if args.image_size == 256 else 0.0
    if max(val_accs) < min_acc:
        raise SystemExit(
            f"pretrain FAILED to learn the RSP pretext task: best val_acc "
            f"{max(val_accs):.3f} < required {min_acc} (chance 0.167). "
            f"val_acc curve: {val_accs}"
        )
    print(f"== pretrain done ({dt:.0f}s): val_acc {val_accs}")
    return ckpt


def stage_finetune(args, report, task, data_argv, stage1_ckpt, save_dir,
                   labeled_batch_per_step, data=None):
    """Stage 2: supervised fine-tune at the task's config of record
    (TaskConfig: BPQ batch 4 Adam 1e-4 MSE / Camelyon 16-per-class SGD 5e-4
    / Kather batch 64 Adam 1e-5); ``data`` stands in for ``data_argv``'s
    --train_path (``_run_stage_cli``)."""
    from ssl_cr_histo_tpu_torch.cli import finetune

    _fresh_dir(save_dir)
    t0 = time.time()
    _run_stage_cli(finetune, "finetune", [
        "--task", task,
        *data_argv,
        *_cli_argv(args),
        "--model_path", stage1_ckpt,
        "--num_epoch", str(args.finetune_epochs),
        "--labeled_train", "1.0",
        "--validation_split", "0.1",
        "--save_dir", save_dir,
    ], data)
    dt = time.time() - t0
    rows = _csv_rows(os.path.join(save_dir, "fine_tuned_results.csv"))
    val_curve = [r[2] for r in rows]
    ckpt = os.path.join(save_dir, "final.pth")
    report["stages"]["finetune"] = {
        "seconds": round(dt, 1),
        "epochs": args.finetune_epochs,
        "labeled_batch_per_step": labeled_batch_per_step,
        "train_loss": [r[1] for r in rows],
        ("val_mse" if task == "breastpathq" else "val_err"): val_curve,
        # curve-shape diagnostics: a flat validation curve makes best-val
        # checkpoint selection unfalsifiable; val_range is banded at the
        # config of record
        "val_best": min(val_curve),
        "val_range": round(max(val_curve) - min(val_curve), 6),
        "checkpoint": ckpt,
    }
    gc.collect()
    key = "val_mse" if task == "breastpathq" else "val_err"
    print(f"== finetune done ({dt:.0f}s): {key} {report['stages']['finetune'][key]}")
    return ckpt


def stage_consistency(args, report, task, data_argv, ft_ckpt, save_dir,
                      labeled_batch_per_step, unlabeled_batch_per_step, data=None):
    """Stage 3: SSL_CR consistency at the task's CR config of record
    (cr_batch: BPQ 4 / Camelyon 8-per-class / Kather 8; mu=7, NAug=7,
    lambda_u=1); ``data`` as in ``stage_finetune``."""
    from ssl_cr_histo_tpu_torch.cli import consistency

    _fresh_dir(save_dir)
    t0 = time.time()
    _run_stage_cli(consistency, "consistency", [
        "--task", task,
        *data_argv,
        *_cli_argv(args),
        "--finetune_ckpt", ft_ckpt,
        "--num_epoch", str(args.cr_epochs),
        "--labeled_train", "0.5",
        "--validation_split", "0.1",
        "--save_dir", save_dir,
    ], data)
    dt = time.time() - t0
    rows = _csv_rows(os.path.join(save_dir, "consistency_results.csv"))
    val_curve = [r[4] for r in rows]
    report["stages"]["consistency"] = {
        "seconds": round(dt, 1),
        "epochs": args.cr_epochs,
        "labeled_batch_per_step": labeled_batch_per_step,
        "unlabeled_batch_per_step": unlabeled_batch_per_step,
        "train_loss": [r[1] for r in rows],
        "sup_loss": [r[2] for r in rows],
        "cons_loss": [r[3] for r in rows],
        ("val_mse" if task == "breastpathq" else "val_err"): val_curve,
        # see stage_finetune: non-flat curves make best-val selection real
        "val_best": min(val_curve),
        "val_range": round(max(val_curve) - min(val_curve), 6),
    }
    # Downstream evaluation uses the best-val CR checkpoint -- the model the
    # reference's best-val checkpointing selects (eval_*_SSL_CR.py save the
    # best validation model for exactly this).
    ckpt = os.path.join(save_dir, "best.pth")
    if not os.path.isfile(ckpt):
        ckpt = os.path.join(save_dir, "final.pth")
    report["stages"]["consistency"]["checkpoint"] = ckpt
    gc.collect()
    print(f"== consistency done ({dt:.0f}s): loss {report['stages']['consistency']['train_loss']}")
    return ckpt


def stage_evaluation(args, report, task, test_argv, ckpt, keys, test=None):
    """``--mode evaluation`` of the fine-tune CLI on ``ckpt`` (the best CR
    checkpoint), its report written beside it; records ``keys`` of the
    task's ``<task>_eval.json``.  ``test`` (a loaded (dataset, second
    rater's labels) pair) stands in for ``test_argv``'s --test_path.
    Returns the eval JSON."""
    from ssl_cr_histo_tpu_torch.cli import finetune

    save_dir = os.path.dirname(ckpt)
    argv = ["--task", task, "--mode", "evaluation", *test_argv, *_cli_argv(args),
            "--finetune_ckpt", ckpt, "--save_dir", save_dir]
    t0 = time.time()
    with _plots_where_drawable() as not_drawn:
        if test is None:
            finetune.main(argv)
        else:
            finetune.evaluate(*_stage_args(finetune, "finetune", argv), ckpt, test)
    with open(os.path.join(save_dir, f"{task}_eval.json")) as f:
        ev = json.load(f)
    stage = report["stages"]["evaluation"] = {"seconds": round(time.time() - t0, 1),
                                              **{k: ev.get(k) for k in keys}}
    if not_drawn:
        stage["plots_not_drawn"] = not_drawn
    gc.collect()
    return ev


def stage_heatmap(args, W, report, ckpt):
    """WSI heatmap inference at 256^2 (test_Camelyon16.py) over both
    slides from ``ckpt``; records each region's mean probability.  Returns
    the maps' dir."""
    from ssl_cr_histo_tpu_torch.cli import heatmap

    hm_out = os.path.join(W, "probs")
    t0 = time.time()
    heatmap.main([
        "--test_image_pth", os.path.join(W, "hm_wsi"),
        "--test_mask_pth", os.path.join(W, "hm_mask"),
        "--probs_map_path", hm_out,
        *_cli_argv(args),
        "--finetune_ckpt", ckpt,
    ])
    dt = time.time() - t0
    pm = np.load(os.path.join(hm_out, "t1.npy"))
    pm_n = np.load(os.path.join(hm_out, "n1.npy"))
    gt = np.load(os.path.join(W, "hm_gt", "t1.npy"))
    tissue = np.load(os.path.join(W, "hm_mask", "t1_mask.npy"))
    tumor_mean = float(pm[gt > 0].mean())
    normal_mean = float(pm[(gt == 0) & tissue].mean())
    strong, subtle = _lesion_boxes(pm.shape[0])
    n_patches = 2 * int(tissue.sum())
    report["stages"]["heatmap"] = {
        "seconds": round(dt, 1),
        "grid": list(pm.shape),
        "slides": 2,
        "patches": n_patches,
        "patches_per_sec_incl_io": round(n_patches / dt, 1),
        "tumor_region_mean_prob": round(tumor_mean, 4),
        "strong_lesion_mean_prob": round(
            float(pm[strong[0]:strong[1], strong[2]:strong[3]].mean()), 4),
        "subtle_lesion_mean_prob": round(
            float(pm[subtle[0]:subtle[1], subtle[2]:subtle[3]].mean()), 4),
        "normal_region_mean_prob": round(normal_mean, 4),
        "normal_slide_mean_prob": round(float(pm_n[tissue].mean()), 4),
        "artifacts": sorted(os.listdir(hm_out)),
    }
    gc.collect()
    print(f"== heatmap done ({dt:.0f}s): tumor {tumor_mean:.3f} vs normal {normal_mean:.3f}")
    return hm_out


def stage_froc(args, W, report, hm_out):
    """The official-protocol FROC over the maps."""
    from ssl_cr_histo_tpu_torch.cli import froc

    froc_out = os.path.join(W, "froc.json")
    t0 = time.time()
    froc.main([
        "--probs_map_path", hm_out,
        "--gt_path", os.path.join(W, "hm_gt"),
        "--threshold", str(args.froc_threshold),
        # 0.25 um/px * the mask's downsample (= patch resolution).  The ITC
        # bound is the protocol's 275 um at the 256^2 config of record and
        # scales with a smaller rehearsal's geometry, so the synthetic lesion
        # keeps the same cell footprint relative to the bound
        "--itc_um", str(275 * args.image_size / 256),
        "--mask_mpp", str(0.25 * args.image_size),
        "--resolution", str(args.image_size),
        "--out", froc_out,
    ])
    with open(froc_out) as f:
        fr = json.load(f)
    report["stages"]["froc"] = {
        "seconds": round(time.time() - t0, 1),
        "froc": fr["froc"],
        "sens_at_fp": fr["sens_at_fp"],
        "total_lesions": fr["total_lesions"],
    }


# --------------------------------------------------------------------------
# Recipes
# --------------------------------------------------------------------------


def run_camelyon16(args, W, report):
    t0 = time.time()
    # the two-dir reference layout (tumor/normal + dedicated VALID dirs) is
    # deterministic given the args, so recompute the paths even on
    # --skip_data reruns
    train_path = f"{os.path.join(W, 'patches_tumor')},{os.path.join(W, 'patches_normal')}"
    val_path = f"{os.path.join(W, 'valid_tumor')},{os.path.join(W, 'valid_normal')}"
    if not args.skip_data:
        train_path, val_path = make_camelyon_patches(
            W, os.path.join(W, "jsons"),
            n_per_class=args.n_patches_per_class,
            size=args.image_size,
        )
        make_heatmap_slide(
            os.path.join(W, "hm_wsi"), os.path.join(W, "hm_mask"),
            os.path.join(W, "hm_gt"),
            size=32 * args.image_size,       # 32x32 patch grid as at 8192/256
            resolution=args.image_size,
        )
    report["stages"]["data"] = {"seconds": round(time.time() - t0, 1)}
    print(f"== data ready ({report['stages']['data']['seconds']}s)")

    s1_ckpt = stage_pretrain(args, W, report)
    data_argv = ["--train_path", train_path,
                 "--json_path", os.path.join(W, "jsons"),
                 "--val_path", val_path]
    s2 = stage_finetune(args, report, "camelyon16", data_argv, s1_ckpt,
                        os.path.join(W, "stage2"),
                        labeled_batch_per_step=32)  # 16 per dir pool
    s3 = stage_consistency(args, report, "camelyon16", data_argv, s2,
                           os.path.join(W, "stage3"),
                           labeled_batch_per_step=16,      # 8 per pool
                           unlabeled_batch_per_step=112)   # 8*mu7 per pool

    # evaluation mode (reference eval blocks: confusion/sens/spec/F1 +
    # binary AUC) on the held-out VALID dirs
    ev = stage_evaluation(args, report, "camelyon16",
                          ["--test_path", val_path, "--json_path", os.path.join(W, "jsons")], s3,
                          ("auc", "accuracy", "weighted_f1"))
    print(f"== evaluation done: auc {ev.get('auc')}")
    stage_froc(args, W, report, stage_heatmap(args, W, report, s3))


def run_breastpathq(args, W, report):
    t0 = time.time()
    train_dir = os.path.join(W, "bpq_train")
    eval_a, eval_b = os.path.join(W, "bpq_eval_a"), os.path.join(W, "bpq_eval_b")
    data = test = None
    if args.bpq_data == "arrays":
        # the datasets the .h5 files would give (data.datasets reads them
        # the same way), without writing or reading a file
        from ssl_cr_histo_tpu_torch.data.datasets import breastpathq_from_arrays

        size = args.image_size
        arrays = breastpathq_arrays(size=size)
        data = breastpathq_from_arrays(*arrays["train"], size)
        test = (breastpathq_from_arrays(*arrays["eval_a"], size),
                breastpathq_from_arrays(*arrays["eval_b"], size).labels)
    else:
        require_h5py()
        if not args.skip_data:
            make_breastpathq_h5(train_dir, eval_a, eval_b, size=args.image_size)
    report["stages"]["data"] = {"seconds": round(time.time() - t0, 1)}
    print(f"== data ready ({report['stages']['data']['seconds']}s)")

    s1_ckpt = stage_pretrain(args, W, report)
    data_argv = [] if data is not None else ["--train_path", train_dir]
    s2 = stage_finetune(args, report, "breastpathq", data_argv, s1_ckpt,
                        os.path.join(W, "bpq_stage2"),
                        labeled_batch_per_step=4, data=data)
    s3 = stage_consistency(args, report, "breastpathq", data_argv, s2,
                           os.path.join(W, "bpq_stage3"),
                           labeled_batch_per_step=4,
                           unlabeled_batch_per_step=28,  # 4 * mu7
                           data=data)

    # evaluation: two-rater ICC / Kendall tau / MSE + scatter and
    # Bland-Altman artifacts (eval_BreastPathQ_SSL.py:471-544)
    test_argv = [] if test is not None else ["--test_path", eval_a, "--test_path_b", eval_b]
    ev = stage_evaluation(args, report, "breastpathq", test_argv, s3,
                          ("icc_MA", "icc_MB", "icc_AB", "tau_MA", "mse_MA"), test)
    s3_dir = os.path.dirname(s3)
    report["stages"]["evaluation"]["artifacts"] = sorted(p for p in os.listdir(s3_dir) if p.endswith(".png"))
    print(f"== evaluation done: ICC(M,A) {ev.get('icc_MA')}, tau {ev.get('tau_MA')}")


def run_kather(args, W, report):
    t0 = time.time()
    data_dir = os.path.join(W, "kather")
    if not args.skip_data:
        make_kather_folder(
            data_dir, n_per_class=args.n_patches_per_class // 5,
            size=(args.image_size if args.image_size != 256 else 224),
        )
    report["stages"]["data"] = {"seconds": round(time.time() - t0, 1)}
    print(f"== data ready ({report['stages']['data']['seconds']}s)")

    s1_ckpt = stage_pretrain(args, W, report)
    data_argv = ["--train_path", data_dir]
    s2 = stage_finetune(args, report, "kather", data_argv, s1_ckpt,
                        os.path.join(W, "kather_stage2"),
                        labeled_batch_per_step=64)
    s3 = stage_consistency(args, report, "kather", data_argv, s2,
                           os.path.join(W, "kather_stage3"),
                           labeled_batch_per_step=8,
                           unlabeled_batch_per_step=56)  # 8 * mu7

    # evaluation: confusion / per-class sens-spec / weighted F1 /
    # multiclass OVR AUC (eval_Kather_SSL_CR.py:643-666)
    ev = stage_evaluation(args, report, "kather", ["--test_path", data_dir], s3,
                          ("accuracy", "weighted_f1", "ovr_auc"))
    print(f"== evaluation done: acc {ev.get('accuracy')}, ovr_auc {ev.get('ovr_auc')}")


RECIPES = {
    # recipe: (runner, report file name, fine-tune epochs, CR epochs)
    "camelyon16": (run_camelyon16, "REHEARSAL.json", 5, 3),
    "breastpathq": (run_breastpathq, "REHEARSAL_BREASTPATHQ.json", 5, 3),
    "kather": (run_kather, "REHEARSAL_KATHER.json", 60, 10),
}

# Expected metric bands at the 256^2 config of record
# (``tools/rehearsal.py:778-810``, value for value).  The synthetic tasks
# are hardened (class-appearance overlap + label noise, subtle lesion,
# observer/signal noise) so the headline metrics sit below their ceilings;
# a recipe regression moves them out of band and fails the rehearsal.
# Lower bounds = quality floor; upper bounds = saturation guard (hitting the
# ceiling means the task degenerated back to triviality).
BANDS = {
    "camelyon16": {
        ("pretrain", "val_acc_best"): (0.30, 1.0),
        # stage-2/3 validation curves must move (flat curves make best-val
        # checkpoint selection unfalsifiable); the 1.0 ceiling only
        # excludes divergence
        ("finetune", "val_range"): (0.03, 1.0),
        ("consistency", "val_range"): (0.01, 1.0),
        ("evaluation", "auc"): (0.80, 0.99),
        ("evaluation", "accuracy"): (0.72, 0.97),
        ("evaluation", "weighted_f1"): (0.72, 0.97),
        ("froc", "froc"): (0.25, 0.99),
        # the floor 0.55 keeps the lesion/normal separation requirement
        # (> the 0.45 normal cap)
        ("heatmap", "strong_lesion_mean_prob"): (0.55, 1.0),
        ("heatmap", "normal_slide_mean_prob"): (0.0, 0.45),
    },
    "breastpathq": {
        ("pretrain", "val_acc_best"): (0.30, 1.0),
        # icc_* report the Shrout-Fleiss variant table; ICC2 (two-way random,
        # absolute agreement) is the reference's metric of record
        ("evaluation", "icc_MA.ICC2"): (0.55, 0.97),
        ("evaluation", "icc_AB.ICC2"): (0.70, 0.98),
        ("evaluation", "tau_MA"): (0.40, 0.97),
    },
    "kather": {
        ("evaluation", "accuracy"): (0.60, 0.99),
        ("evaluation", "weighted_f1"): (0.60, 0.99),
        ("evaluation", "ovr_auc"): (0.80, 0.999),
    },
}


def band_value(report, stage, key):
    """The metric a band reads: ``key``, a dotted path into the stage's
    nested metric dicts; None where it is missing."""
    v = report["stages"].get(stage, {})
    for part in key.split("."):
        v = v.get(part) if isinstance(v, dict) else None
    return v


def check_bands(recipe, report, enforce):
    """Record the recipe's expected metric bands in the report and (at the
    config of record) return the out-of-band violations."""
    bands = BANDS[recipe]
    report["expected_bands"] = {
        f"{stage}.{key}": [lo, hi] for (stage, key), (lo, hi) in bands.items()
    }
    if not enforce:
        return []
    violations = []
    for (stage, key), (lo, hi) in bands.items():
        if stage == "pretrain" and "reused" in report["stages"].get(stage, {}):
            continue  # --stage1_ckpt reuse: the source rehearsal gated it
        v = band_value(report, stage, key)
        if not isinstance(v, (int, float)) or not (lo <= v <= hi):
            violations.append(f"{stage}.{key}={v} not in [{lo}, {hi}]")
    return violations


def main(argv=None):
    p = argparse.ArgumentParser("full-recipe rehearsal at reference shapes (PyTorch / CUDA)")
    p.add_argument("--recipe", default="camelyon16", choices=list(RECIPES))
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "ssl_cr_rehearsal"))
    p.add_argument("--out", default="",
                   help="report path (default: the recipe's REHEARSAL*.json under --workdir)")
    p.add_argument("--stage1_ckpt", default="",
                   help="reuse an existing stage-1 pretraining checkpoint (a ckpt_<N>.pth, or a "
                        "checkpoint directory of the JAX package) "
                        "instead of training one (the reference transfers "
                        "its Camelyon16 pretraining to Kather)")
    p.add_argument("--pretrain_epochs", type=int, default=25)
    p.add_argument("--pretrain_steps_per_epoch", type=int, default=24,
                   help="25x24 steps of batch 64 (the JAX package's calibration: the "
                        "pretext val_acc clears 0.40 by epoch 3 and peaks "
                        ">0.9 by epoch 16 on the multi-scale slides)")
    p.add_argument("--pretrain_min_acc", type=float, default=0.30,
                   help="minimum best val_acc the pretraining stage must "
                        "reach at 256^2 (6-way chance = 0.167; enforced "
                        "only at the config of record)")
    p.add_argument("--finetune_epochs", type=int, default=0,
                   help="0 = recipe default (camelyon16 5 / breastpathq 5 / "
                        "kather 60 -- Kather's Adam 1e-5 of record needs more "
                        "steps to move its fine-tune)")
    p.add_argument("--cr_epochs", type=int, default=0,
                   help="0 = recipe default (camelyon16 3 / breastpathq 3 / kather 10)")
    p.add_argument("--froc_threshold", type=float, default=0.3,
                   help="candidate threshold for the FROC stage (the few-epoch "
                        "rehearsal model is not saturated; real runs use 0.5)")
    p.add_argument("--n_patches_per_class", type=int, default=300)
    p.add_argument("--image_size", type=int, default=256,
                   help="tile/patch resolution; 256 = the config of record "
                        "(Kather keeps its 224 default).  Smaller values "
                        "(e.g. 32) rehearse the full wiring at CPU scale: the "
                        "synthetic data, pretrain tiles, heatmap grid, and "
                        "FROC mpp all scale with it")
    p.add_argument("--skip_data", action="store_true",
                   help="reuse --workdir's existing synthetic data")
    p.add_argument("--device", default="cuda",
                   help="the stage CLIs' --device; 'cpu' runs the recipe on the CPU")
    p.add_argument("--bpq_data", default="h5", choices=["h5", "arrays"],
                   help="BreastPathQ data: h5 = the reference's .h5 files (needs h5py); "
                        "arrays = the same datasets handed to the stage CLIs in memory")
    args = p.parse_args(argv)

    run, report_name, ft_default, cr_default = RECIPES[args.recipe]
    args.out = args.out or os.path.join(args.workdir, report_name)
    args.finetune_epochs = args.finetune_epochs or ft_default
    args.cr_epochs = args.cr_epochs or cr_default

    W = args.workdir
    os.makedirs(W, exist_ok=True)
    report = {"config": vars(args), "stages": {}}

    try:
        run(args, W, report)
    except BaseException as exc:
        # A mid-recipe abort (e.g. stage_pretrain's pretext-learning gate)
        # must not discard the stage data already collected: the curves and
        # per-stage timings are the diagnostic.  Write the partial report,
        # then re-raise.
        report["failed"] = f"{type(exc).__name__}: {exc}"
        _finalize_report(args, report)
        print(f"== rehearsal FAILED -- partial report written to {args.out}")
        raise
    violations = check_bands(args.recipe, report, enforce=args.image_size == 256)
    report["band_violations"] = violations
    _finalize_report(args, report)
    if violations:
        raise SystemExit(
            "rehearsal metrics OUT OF EXPECTED BANDS (recipe regression?): "
            + "; ".join(violations) + f" -- report written to {args.out}"
        )
    print(f"== rehearsal complete in {report['total_seconds']}s -> {args.out}")
    return report


if __name__ == "__main__":
    main()
