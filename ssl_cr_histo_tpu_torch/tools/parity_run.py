"""Real-data quality-parity run: one command between "data arrives" and
"parity table exists".

The port's counterpart of ``tools/parity_run.py``.  Given a real dataset and
a stage-1 pretraining checkpoint (the port's ``ckpt_<N>.pth``, the
reference's torch ``.pt``, or a checkpoint directory of the JAX package),
this executes the reference's label-efficiency
protocol at the 10/25/50/100% operating points (eval_BreastPathQ_SSL.py:264;
README.md:78,91) in strict parity mode (``--reference_exact``: per-view BN,
with-replacement subsampling, eager x6 orderings, op-by-op exact
augmentation, float32):

  for each labeled fraction f:
    1. SSL fine-tune   (cli.finetune  --reference_exact --labeled_train f)
       -> evaluation-mode metrics on the held-out test set
    2. SSL_CR student  (cli.consistency --reference_exact, teacher from 1)
       -> evaluation-mode metrics on the held-out test set

and emits PARITY_RUN.json plus a markdown table.  Pass --reference_json
(a {"<fraction>": {"ssl": {...}, "ssl_cr": {...}}} map of the reference's
own numbers -- from running the upstream repo or from the paper, MIA 2021
DOI 10.1016/j.media.2021.102256) to get side-by-side deltas; without it the
table carries the port's side only.

Headline metrics per task:
  breastpathq  ICC2(M,A) + Kendall tau + MSE   (eval_BreastPathQ_SSL.py:472-500)
  camelyon16   AUC / accuracy / weighted F1    (eval_Camelyon_SSL.py:137-148)
  kather       accuracy / weighted F1 / OVR AUC (eval_Kather_SSL_CR.py:646-666)

``--dryrun`` runs the whole protocol on the rehearsal's synthetic data
(``tools/rehearsal.py``) from a freshly trained micro stage-1 checkpoint: the
tool's self-test before real data lands.

    python3 -m ssl_cr_histo_tpu_torch.tools.parity_run --task breastpathq \\
        --pretrained PRETRAIN_RUN/ckpt_250.pth --train_path ... --test_path ... \\
        [--test_path_b ...] [--reference_json ref.json] [--device cuda]
    python3 -m ssl_cr_histo_tpu_torch.tools.parity_run --task kather --dryrun \\
        --pretrained dryrun --train_path x --test_path x --image_size 32 --device cpu

Every stage CLI runs on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import time

# Metrics lifted from each task's evaluation-mode JSON into the table.
# Dotted paths index nested dicts (ICC variant tables).
HEADLINE = {
    "breastpathq": ["icc_MA.ICC2", "icc_MB.ICC2", "tau_MA", "mse_MA"],
    "camelyon16": ["auc", "accuracy", "weighted_f1"],
    "kather": ["accuracy", "weighted_f1", "ovr_auc"],
}


def _dig(d, dotted):
    for part in dotted.split("."):
        d = d.get(part) if isinstance(d, dict) else None
    return d


def _fresh(path):
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)
    return path


def _best_or_final(save_dir):
    best = os.path.join(save_dir, "best.pth")
    return best if os.path.isfile(best) else os.path.join(save_dir, "final.pth")


def _eval_metrics(task, args, ckpt, save_dir, extra, test=None):
    """Evaluation mode of record on the held-out test set; returns the
    headline slice of the stage's <task>_eval.json.  ``test`` (a loaded
    (dataset, second rater's labels) pair) stands in for --test_path's."""
    from ssl_cr_histo_tpu_torch.cli import finetune
    from ssl_cr_histo_tpu_torch.tools import rehearsal as R

    # evaluation runs under the same strict preset as training: a bf16 eval
    # forward (~3 significant decimal digits) would bury the 4-decimal
    # parity deltas in eval-precision noise
    argv = ["--task", task, "--mode", "evaluation", "--reference_exact",
            *(["--test_path", args.test_path] if test is None else []),
            "--finetune_ckpt", ckpt, "--save_dir", save_dir,
            "--eval_batch_size", str(args.eval_batch_size), *extra]
    if args.test_path_b and test is None:
        argv += ["--test_path_b", args.test_path_b]
    if task == "camelyon16" and args.json_path:
        argv += ["--json_path", args.json_path]
    with R._plots_where_drawable() as not_drawn:
        if test is None:
            finetune.main(argv)
        else:
            finetune.evaluate(*R._stage_args(finetune, "finetune", argv), ckpt, test)
    if not_drawn:
        print(f"== plots not drawn (no matplotlib): {not_drawn}")
    with open(os.path.join(save_dir, f"{task}_eval.json")) as f:
        ev = json.load(f)
    out = {m: _dig(ev, m) for m in HEADLINE[task]}
    out = {k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in out.items()}
    return out


def run_fraction(args, frac, extra, data=None, test=None):
    """SSL fine-tune + SSL_CR at one labeled fraction, both evaluated.
    ``data`` (a loaded train set) stands in for --train_path's and ``test``
    for --test_path's (``--bpq_data arrays``)."""
    from ssl_cr_histo_tpu_torch.cli import consistency, finetune
    from ssl_cr_histo_tpu_torch.tools import rehearsal as R

    tag = f"frac_{frac:g}"
    W = os.path.join(args.workdir, tag)
    row = {"fraction": frac}
    train = ["--train_path", args.train_path] if data is None else []

    s2 = _fresh(os.path.join(W, "ssl"))
    t0 = time.time()
    R._run_stage_cli(finetune, "finetune", [
        "--task", args.task, "--reference_exact",
        *train,
        "--model_path", args.pretrained,
        "--labeled_train", str(frac),
        "--num_epoch", str(args.finetune_epochs),
        "--seed", str(args.seed),
        "--save_dir", s2, *extra,
        *(["--json_path", args.json_path] if args.json_path else []),
        *(["--val_path", args.val_path] if args.val_path else []),
    ], data)
    gc.collect()
    ssl_ckpt = _best_or_final(s2)
    row["ssl"] = _eval_metrics(args.task, args, ssl_ckpt,
                               os.path.join(W, "ssl_eval"), extra, test)
    row["ssl"]["seconds"] = round(time.time() - t0, 1)
    print(f"== {tag} SSL: {row['ssl']}")

    if args.cr_epochs > 0:
        s3 = _fresh(os.path.join(W, "cr"))
        t0 = time.time()
        R._run_stage_cli(consistency, "consistency", [
            "--task", args.task, "--reference_exact",
            *train,
            "--finetune_ckpt", ssl_ckpt,
            "--labeled_train", str(frac),
            "--num_epoch", str(args.cr_epochs),
            "--seed", str(args.seed),
            "--save_dir", s3, *extra,
            *(["--json_path", args.json_path] if args.json_path else []),
            *(["--val_path", args.val_path] if args.val_path else []),
        ], data)
        gc.collect()
        row["ssl_cr"] = _eval_metrics(args.task, args, _best_or_final(s3),
                                      os.path.join(W, "cr_eval"), extra, test)
        row["ssl_cr"]["seconds"] = round(time.time() - t0, 1)
        print(f"== {tag} SSL_CR: {row['ssl_cr']}")
    return row


def render_table(task, rows, reference):
    """Markdown: one line per (fraction, stage), reference columns + delta
    when --reference_json supplied."""
    metrics = HEADLINE[task]
    head = ["fraction", "stage"] + metrics
    if reference:
        # normalize keys numerically: the user's JSON naturally says "1.0"
        # while %g formatting of the fraction yields "1" -- a string lookup
        # would silently drop the reference columns for that row
        reference = {float(k): v for k, v in reference.items()}
        head += [f"ref_{m}" for m in metrics] + ["max_abs_delta"]
    lines = ["| " + " | ".join(head) + " |",
             "|" + "---|" * len(head)]
    for row in rows:
        for stage in ("ssl", "ssl_cr"):
            if stage not in row:
                continue
            cells = [f"{row['fraction']:g}", stage.upper()]
            cells += [str(row[stage].get(m, "—")) for m in metrics]
            if reference:
                ref = (reference.get(float(row["fraction"])) or {}).get(stage, {})
                deltas = []
                for m in metrics:
                    r = _dig(ref, m)
                    cells.append("—" if r is None else str(r))
                    v = row[stage].get(m)
                    if r is not None and isinstance(v, (int, float)):
                        deltas.append(abs(v - r))
                cells.append(f"{max(deltas):.4f}" if deltas else "—")
            lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(
        "label-efficiency parity run (strict --reference_exact protocol; PyTorch / CUDA)")
    p.add_argument("--task", required=True,
                   choices=["breastpathq", "camelyon16", "kather"])
    p.add_argument("--pretrained", required=True,
                   help="stage-1 RSP checkpoint: the port's ckpt_<N>.pth or the reference's torch .pt "
                        "(the same format), or a checkpoint directory of the JAX package (its "
                        "checkpoint.msgpack is read without JAX; cli.convert_checkpoint makes the .pth)")
    p.add_argument("--train_path", required=True)
    p.add_argument("--val_path", default="",
                   help="held-out validation dirs (camelyon16 VALID layout)")
    p.add_argument("--test_path", required=True)
    p.add_argument("--test_path_b", default="",
                   help="BreastPathQ second-rater h5")
    p.add_argument("--json_path", default="",
                   help="Camelyon16 annotation JSON dir")
    p.add_argument("--fractions", default="0.1,0.25,0.5,1.0",
                   help="labeled fractions of the reference protocol")
    p.add_argument("--finetune_epochs", type=int, default=90,
                   help="reference config of record (eval_*_SSL.py)")
    p.add_argument("--cr_epochs", type=int, default=90,
                   help="0 skips the SSL_CR stage")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--eval_batch_size", type=int, default=64)
    p.add_argument("--image_size", type=int, default=0,
                   help="override input resolution (dryrun shrinks it)")
    p.add_argument("--reference_json", default="",
                   help="reference-side numbers {fraction: {ssl: {...}, "
                        "ssl_cr: {...}}} for side-by-side deltas")
    p.add_argument("--workdir", default="/tmp/ssl_cr_parity")
    p.add_argument("--out", default="PARITY_RUN.json")
    p.add_argument("--dryrun", action="store_true",
                   help="ignore the data args; run the whole protocol on "
                        "tiny synthetic rehearsal data (tool self-test)")
    p.add_argument("--device", default="cuda",
                   help="every stage CLI's --device; 'cpu' runs the protocol on the CPU")
    p.add_argument("--bpq_data", default="h5", choices=["h5", "arrays"],
                   help="the BreastPathQ dryrun's data: h5 = the reference's .h5 files (needs h5py); "
                        "arrays = the same datasets handed to the stage CLIs in memory")
    args = p.parse_args(argv)
    if args.bpq_data == "arrays" and not (args.dryrun and args.task == "breastpathq"):
        p.error("--bpq_data arrays is the BreastPathQ dryrun's in-memory data; real data comes as .h5 files")
    from ssl_cr_histo_tpu_torch.train.checkpoint import JAX_CHECKPOINT

    if (not (args.dryrun and args.pretrained == "dryrun") and os.path.isdir(args.pretrained)
            and not os.path.isfile(os.path.join(args.pretrained, JAX_CHECKPOINT))):
        p.error(f"--pretrained {args.pretrained} is a directory without {JAX_CHECKPOINT}: give a .pth, or a "
                f"checkpoint directory of the JAX package (cli.convert_checkpoint carries one to a .pth)")

    data = test = None
    if args.dryrun:
        data, test = _setup_dryrun(args)

    extra = [*(["--image_size", str(args.image_size)] if args.image_size else []), "--device", args.device]
    reference = None
    if args.reference_json:
        with open(args.reference_json) as f:
            reference = json.load(f)

    os.makedirs(args.workdir, exist_ok=True)
    fractions = [float(x) for x in args.fractions.split(",") if x.strip()]
    report = {"task": args.task, "config": vars(args), "rows": []}
    t0 = time.time()
    try:
        for frac in fractions:
            report["rows"].append(run_fraction(args, frac, extra, data, test))
    finally:
        # partial results land on disk even on a mid-run abort
        report["seconds"] = round(time.time() - t0, 1)
        report["table"] = render_table(args.task, report["rows"], reference)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    print(f"\n{report['table']}\n-> {args.out} ({report['seconds']}s)")
    return report


def _dryrun_count(n, fraction, need, rows=lambda n: n):
    """The least count from ``n`` up whose floor-sized labeled fraction of
    ``rows(count)`` training rows (int(fraction * rows), as
    ``data.datasets.labeled_fraction`` draws it) fills one step of ``need``."""
    while int(fraction * rows(n)) < need:
        n += 1
    return n


def _setup_dryrun(args):
    """Swap the data args for tiny synthetic rehearsal data and a freshly
    trained micro stage-1 checkpoint, so the entire protocol (checkpoint
    load -> reference_exact fine-tune -> eval -> CR -> eval -> table) runs
    in minutes.  Returns the in-memory (train, test) pair of ``--bpq_data
    arrays``, else (None, None).

    The counts are the JAX tool's (240 BreastPathQ train images, 24 Kather
    images a class, 48 Camelyon16 patches a pool), raised where they would
    give a stage no step at the task's batch of record: the smallest
    fraction's labeled subsample fills one fine-tune batch (BreastPathQ 4,
    Kather 64, Camelyon16 16 a pool; the CLIs hold out 20% of BreastPathQ
    and Kather for validation), and a Camelyon16 pool fills one consistency
    step's 8 * mu 7 unlabeled patches."""
    from ssl_cr_histo_tpu_torch.cli import pretrain
    from ssl_cr_histo_tpu_torch.tools import rehearsal as R

    size = args.image_size or 32
    args.image_size = size
    W = args.workdir
    os.makedirs(W, exist_ok=True)
    f_min = min(float(x) for x in args.fractions.split(",") if x.strip())
    train_rows = lambda n: n - int(0.2 * n)  # after the CLIs' --validation_split 0.2
    data = test = None

    if args.task == "breastpathq":
        n_train = _dryrun_count(240, f_min, 4, train_rows)
        if args.bpq_data == "arrays":
            from ssl_cr_histo_tpu_torch.data.datasets import breastpathq_from_arrays

            arrays = R.breastpathq_arrays(n_train, size=size)
            data = breastpathq_from_arrays(*arrays["train"], size)
            test = (breastpathq_from_arrays(*arrays["eval_a"], size),
                    breastpathq_from_arrays(*arrays["eval_b"], size).labels)
            args.train_path = args.test_path = args.test_path_b = ""
        else:
            R.require_h5py()
            train, ea, eb = (os.path.join(W, d) for d in
                             ("bpq_train", "bpq_a", "bpq_b"))
            R.make_breastpathq_h5(train, ea, eb, n_train, size=size)
            args.train_path, args.test_path, args.test_path_b = train, ea, eb
    elif args.task == "kather":
        data_dir = os.path.join(W, "kather")
        R.make_kather_folder(data_dir, size=size,
                             n_per_class=_dryrun_count(24, f_min, 64, lambda n: train_rows(9 * n)))
        args.train_path = args.test_path = data_dir
    else:
        train, val = R.make_camelyon_patches(
            W, os.path.join(W, "jsons"), size=size,
            n_per_class=max(_dryrun_count(48, f_min, 16), 8 * 7))
        args.train_path, args.val_path = train, val
        args.test_path, args.json_path = val, os.path.join(W, "jsons")

    if not args.pretrained or args.pretrained == "dryrun":
        # the rehearsal smoke's geometry: 25-tiles-across slides, stride
        # tile/4 (tools/rehearsal.py stage_pretrain)
        R.make_pretrain_wsis(os.path.join(W, "wsis"), size=25 * size)
        s1 = _fresh(os.path.join(W, "stage1"))
        pretrain.main([
            "--train_image_pth", os.path.join(W, "wsis"),
            "--tile_h", str(size), "--tile_w", str(size),
            "--tile_stride", str(size // 4), "--batch_size", "16",
            "--num_epoch", "1", "--steps_per_epoch", "2",
            "--validation_size", "8", "--save_freq", "1",
            "--save_dir", s1, "--device", args.device,
        ])
        args.pretrained = os.path.join(s1, "ckpt_1.pth")
    return data, test


if __name__ == "__main__":
    main()
