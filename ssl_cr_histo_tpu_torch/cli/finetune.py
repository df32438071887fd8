"""Supervised fine-tuning (SSL stage 2) on a GPU.

Counterpart of ``ssl_cr_histo_tpu/cli/finetune.py:44-417``, ``--mode
fine-tuning`` and ``--mode evaluation`` for the Kather, BreastPathQ and
Camelyon16 tasks.  Config of
record per task (``cli.common.TASKS``); Kather's (reference
eval_Kather_SSL.py:231-238): 9 classes at 224^2, batch 64 images (192 views
a step after the 3-view stack), Adam 1e-5 with L2 1e-4 added to the
gradient, MultiStepLR at epochs [30, 60] with gamma 0.1 stepped per
optimizer step, bf16 autocast, the backbone loaded from a pretraining
checkpoint.  Camelyon16's (eval_Camelyon_SSL.py:205-211): 2 classes at
256^2, 16 images from each of the tumor and normal pools a step (96 views),
SGD-Nesterov 5e-4 with L2 1e-4, the milestones counted in the balanced
iterator's epochs.

    python -m ssl_cr_histo_tpu_torch.cli.finetune --task kather --train_path CLASS_DIRS/ \\
        --model_path PRETRAIN_RUN/best.pth --save_dir RUN/
    python -m ssl_cr_histo_tpu_torch.cli.finetune --task camelyon16 --train_path TUMOR_DIR,NORMAL_DIR \\
        --json_path JSONS/ --val_path TUMOR_VALID,NORMAL_VALID --model_path PRETRAIN_RUN/ckpt_1.pth \\
        --save_dir RUN/

    python -m ssl_cr_histo_tpu_torch.cli.finetune --task kather --mode evaluation --test_path TEST_DIRS/ \
        --finetune_ckpt RUN/best.pth --save_dir EVAL/

Writes ``fine_tuned_results.csv``, ``best.pth``, ``ckpt_<epoch>.pth`` and
``final.pth`` under ``--save_dir``: the TripletNet under ``'model'`` and the
head under ``'classifier'`` (``classifier.0.*``), the reference's layout.
``--model_path`` and ``--finetune_ckpt`` take a ``.pth`` of the port or
the reference, or a checkpoint directory of the JAX package (a TPU run's
``RUN/best``, read without JAX).  ``--resume ckpt_<N>.pth|auto`` continues
a run from its checkpoint.  ``--mode evaluation`` scores
``--finetune_ckpt`` on ``--test_path`` (and BreastPathQ's second rater
``--test_path_b``) and writes ``<task>_eval.json`` and the task's plots.  ``--remat`` recomputes the backbone's blocks in the
backward pass; ``--reference_exact`` applies the strict-parity preset
(float32, with-replacement subsampling); ``--aug_mode`` is accepted as the
JAX CLI accepts it, and the 3-view stack has no modes.  ``--multi_step K``
(default 8) trains K batches a chunk (``parallel.steps.
make_finetune_multi_step``): on the card one captured CUDA graph replayed a
step, the 3-view stack inside it; the LR schedule's milestones capture it
again.  Validation and evaluation stay eager.

On N cards: ``python3 -m torch.distributed.run --nproc_per_node N -m
ssl_cr_histo_tpu_torch.cli.finetune ...``; every process reads the same
batches and trains on its 1/N of each (``parallel.distributed``),
validation and evaluation forward each process's rows and gather the
outputs, and the primary writes.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ssl_cr_histo_tpu_torch.cli.common import (
    CHECKPOINT_HELP,
    TASKS,
    StretchCounters,
    add_common_args,
    add_multi_step_arg,
    apply_reference_exact,
    apply_task_overrides,
    balanced_epoch_len,
    chunked_feed,
    make_optimizer,
    resolve_device,
    resume_training,
    seed_everything,
)
from ssl_cr_histo_tpu_torch.data import datasets as D
from ssl_cr_histo_tpu_torch.data.pipeline import balanced_batch_iterator, pad_batches, prefetch_to_device
from ssl_cr_histo_tpu_torch.eval import metrics as M
from ssl_cr_histo_tpu_torch.eval import reporting as RP
from ssl_cr_histo_tpu_torch.parallel.distributed import fetch_global, is_primary, process_count
from ssl_cr_histo_tpu_torch.parallel import steps as S
from ssl_cr_histo_tpu_torch.parallel.mesh import rows_for_batch
from ssl_cr_histo_tpu_torch.train.checkpoint import save_checkpoint
from ssl_cr_histo_tpu_torch.train.init import init_finetune_state, init_serving_state, load_backbone
from ssl_cr_histo_tpu_torch.train.loop import BestTracker, CsvLogger
from ssl_cr_histo_tpu_torch.train.state import FinetuneState


def parse_args(argv=None):
    p = argparse.ArgumentParser("SSL supervised fine-tuning (PyTorch / CUDA)")
    p.add_argument("--task", required=True, choices=list(TASKS))
    p.add_argument("--mode", default="fine-tuning", choices=["fine-tuning", "evaluation"])
    p.add_argument("--train_path", default="",
                   help="train data dir (h5 dir / class folders / patch dirs); Camelyon16 takes two "
                        "comma-joined patch dirs, tumor and normal (or one dir with polygon labels)")
    p.add_argument("--json_path", default="", help="Camelyon16 annotation JSON dir")
    p.add_argument("--val_path", default="",
                   help="explicit validation data dir(s); when set the whole --train_path trains "
                        "and --validation_split is ignored")
    p.add_argument("--val_json_path", default="",
                   help="annotation JSON dir for --val_path (defaults to --json_path)")
    p.add_argument("--test_path", default="", help="eval data dir (mode=evaluation)")
    p.add_argument("--test_path_b", default="", help="BreastPathQ second-rater dir")
    p.add_argument("--model_path", default="",
                   help="stage-1 pretraining checkpoint: " + CHECKPOINT_HELP)
    p.add_argument("--finetune_ckpt", default="", help="checkpoint to evaluate (mode=evaluation): " + CHECKPOINT_HELP)
    p.add_argument("--modules", type=int, default=0,
                   help="freeze the first N torch-ordered tensors "
                        "(0 full FT / 15 from-layer2 / 30 / 45 / 60 head-only / 64)")
    p.add_argument("--labeled_train", type=float, default=1.0,
                   help="labeled fraction: 0.1 / 0.25 / 0.5 / 1.0")
    p.add_argument("--validation_split", type=float, default=0.2)
    p.add_argument("--with_replacement", action="store_true",
                   help="reproduce the reference's sampling-with-replacement defect")
    p.add_argument("--num_epoch", type=int, default=90)
    p.add_argument("--batch_size", type=int, default=0, help="0 = task default")
    p.add_argument("--lr", type=float, default=0.0, help="0 = task default")
    p.add_argument("--weight_decay", type=float, default=1e-4,
                   help="L2 added to grads before the update (torch semantics)")
    add_multi_step_arg(p)
    p.add_argument("--resume", default="",
                   help="a ckpt_<N>.pth to resume from, or 'auto' for the latest under --save_dir")
    p.add_argument("--save_freq", type=int, default=10,
                   help="epochs between periodic ckpt_N checkpoints (0 = off)")
    p.add_argument("--eval_batch_size", type=int, default=64,
                   help="batch of per-epoch validation and --mode evaluation")
    add_common_args(p)
    return p.parse_args(argv)


def load_task_dataset(cfg, path: str, json_path: str = ""):
    """One task-appropriate loader call (``cli/finetune.py:103-110``)."""
    if cfg.name == "breastpathq":
        return D.load_breastpathq_h5(path, cfg.image_size)
    if cfg.name == "camelyon16":
        return D.load_camelyon16_patches(path, json_path, cfg.image_size)
    return D.load_kather_folder(path, cfg.image_size)


def load_train_val(args, cfg):
    """Train/val pair: an explicit ``--val_path`` (the reference's
    Camelyon16 VALID dirs, with ``--val_json_path`` or ``--json_path``), or
    a seeded ``--validation_split`` holdout of the train set
    (eval_BreastPathQ_SSL.py:293-302)."""
    ds = load_task_dataset(cfg, args.train_path, args.json_path)
    if args.val_path:
        return ds, load_task_dataset(cfg, args.val_path, args.val_json_path or args.json_path)
    return D.train_val_split(ds, args.validation_split, seed=args.seed)


def subsample_labeled(train, args, cfg):
    """Labeled-fraction subsampling (``cli/finetune.py:124-144``):
    Camelyon16 draws each pool of ``datasets.grouping_key`` apart (the
    reference's per-directory loaders), the other tasks draw from all.  The
    reference applies np.random.choice even at labeled_train=1.0 (a
    with-replacement bootstrap that drops ~37% of samples), so
    ``--with_replacement`` subsamples unconditionally; without replacement,
    fraction 1.0 is the identity."""
    if args.labeled_train >= 1.0 and not args.with_replacement:
        return train
    return D.labeled_fraction(train, args.labeled_train, seed=args.seed, with_replacement=args.with_replacement,
                              per_class=cfg.balanced)


def steps_per_epoch(cfg, train, batch_size: int) -> int:
    """Train steps an epoch: a balanced task's iterator gives the smaller
    pool's batch count, the other tasks ``len // batch``
    (``cli/finetune.py:185-203``).  Zero raises SystemExit: an epoch
    without a step would still validate and checkpoint an untrained head."""
    if cfg.balanced:
        n = balanced_epoch_len(D.grouping_key(train), batch_size)
    else:
        n = len(train) // batch_size
    if n == 0:
        raise SystemExit(f"zero steps per epoch: {len(train)} train samples vs batch {batch_size}"
                         f"{'/class (smaller pool undersized)' if cfg.balanced else ''}"
                         f" -- reduce --batch_size or add data")
    return n


def train_batches(cfg, train, batch_size: int, seed: int):
    """One epoch's host batches: balanced tumor/normal batches of
    ``batch_size`` a pool for Camelyon16 (the reference's zipped loaders,
    eval_Camelyon_SSL.py:281-291), a seeded shuffle for the other tasks."""
    if cfg.balanced:
        return balanced_batch_iterator(train, batch_size, seed=seed)
    return train.batches(batch_size, seed=seed)


def build_state(args, cfg, device: torch.device, n_steps_per_epoch: int) -> FinetuneState:
    """TripletNet + FinetuneHead with the task's optimizer, ``--modules``
    frozen, and LR milestones in steps from the epoch length."""
    lr = args.lr or cfg.lr
    return init_finetune_state(
        args.model, cfg.num_classes, device,
        lambda params: make_optimizer(cfg.optimizer, params, lr, args.weight_decay),
        modules=args.modules,
        milestones_steps=[m * n_steps_per_epoch for m in cfg.milestones],
        gamma=cfg.gamma,
        remat=args.remat,
    )


def forward_all(state: FinetuneState, ds, batch_size: int, device: torch.device, bf16: bool = False):
    """Eval-mode outputs (N, num_classes) float32 of every sample of ``ds``
    in order, the last batch short, and the labels, as numpy
    (``cli/finetune.py:297-317``).  Under data parallelism each process
    forwards its rows of every batch (zero-padded to a multiple of the
    process count) and every process gets the whole outputs
    (``distributed.fetch_global``)."""
    outs, labels = [], []

    def images():
        for imgs, lab in ds.batches(batch_size, shuffle=False, drop_last=False):
            labels.append(np.asarray(lab))
            yield imgs

    for imgs, _ in prefetch_to_device(pad_batches(images(), multiple=process_count()), device):
        outs.append(fetch_global(S.forward(state, imgs, bf16=bf16)))
    # each batch's padding rows at its end
    return torch.cat([o[:len(lab)] for o, lab in zip(outs, labels, strict=True)]).cpu().numpy(), np.concatenate(labels)


def validate(cfg, state: FinetuneState, val, batch_size: int, device: torch.device,
             bf16: bool = False) -> float:
    """Validation error (1 - accuracy) or MSE over the whole set, in order,
    with the eval-mode forward (``cli/finetune.py:320-330``)."""
    out, lab = forward_all(state, val, batch_size, device, bf16)
    if cfg.task == "regression":
        return float(np.mean((out[:, 0] - lab) ** 2))
    return 1.0 - M.accuracy(lab, out.argmax(-1))


def predict_all(state: FinetuneState, ds, cfg, device: torch.device, raw: bool = False, batch_size: int = 64,
                bf16: bool = False) -> np.ndarray:
    """Every sample's output in order (``cli/finetune.py:411-417``): the
    (N, num_classes) logits, or a regression task's (N,) scores unless
    ``raw``."""
    out, _ = forward_all(state, ds, batch_size, device, bf16)
    return out[:, 0] if cfg.task == "regression" and not raw else out


def load_test_set(args, cfg):
    """The test set and, for BreastPathQ, the second rater's labels
    (``--test_path_b``, else ``--test_path`` again); None for the other
    tasks (``cli/finetune.py:341-378``)."""
    if cfg.name == "breastpathq":
        return D.load_breastpathq_eval_pair(args.test_path, args.test_path_b or args.test_path, cfg.image_size)
    if cfg.name == "camelyon16":
        return D.load_camelyon16_patches(args.test_path, args.json_path, cfg.image_size, split=None), None
    return D.load_kather_folder(args.test_path, cfg.image_size), None


def eval_report(cfg, labels: np.ndarray, out: np.ndarray, labels_b: "np.ndarray | None" = None) -> dict:
    """The task's test metrics from ``predict_all``'s output, key for key as
    the JAX CLI's (``cli/finetune.py:344-395``).  BreastPathQ: the ICC
    tables and Kendall's tau of the predictions (M) against rater A's
    ``labels`` and rater B's ``labels_b``, and A against B, and the MSE
    against A.  Kather and Camelyon16: the confusion matrix, per-class
    sensitivity / specificity / accuracy, weighted F1, accuracy, and the
    one-vs-rest (Kather) or binary (Camelyon16) AUC of the softmax, None
    where the test set lacks a class."""
    if cfg.task == "regression":
        return {
            "icc_MA": M.icc_two_raters(out, labels),
            "icc_MB": M.icc_two_raters(out, labels_b),
            "icc_AB": M.icc_two_raters(labels, labels_b),
            "tau_MA": M.kendall_tau(out, labels),
            "mse_MA": float(np.mean((out - labels) ** 2)),
        }
    preds = out.argmax(-1)
    cm = M.confusion_matrix(labels, preds, cfg.num_classes)
    probs = np.exp(out - out.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    report = {
        "confusion": cm.tolist(),
        "per_class": {k: v.tolist() for k, v in M.per_class_sens_spec_acc(cm).items()},
        "weighted_f1": M.weighted_f1(labels, preds),
        "accuracy": M.accuracy(labels, preds),
    }
    auc_key = "auc" if cfg.num_classes == 2 else "ovr_auc"
    try:
        report[auc_key] = M.binary_auc(labels, probs[:, 1]) if cfg.num_classes == 2 else M.multiclass_ovr_auc(
            labels, probs)
    except ValueError:
        report[auc_key] = None  # the test set lacks a class
    return report


def write_eval(save_dir: str, cfg, report: dict, labels: np.ndarray, out: np.ndarray,
               labels_b: "np.ndarray | None" = None) -> str:
    """``<task>_eval.json`` under ``save_dir`` first, then the task's plots
    (``eval.reporting``, which needs matplotlib): BreastPathQ's scatter and
    Bland-Altman plots for each pairing of predictions (M) and raters (A, B),
    the other tasks' confusion matrix.  Returns the JSON's path; only the
    primary process writes."""
    path = os.path.join(save_dir, f"{cfg.name}_eval.json")
    if not is_primary():
        return path
    os.makedirs(save_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=2, default=float)
    print(json.dumps(report, indent=2, default=float))
    print(f"==> wrote {path}")
    if cfg.task == "regression":
        # reference eval_BreastPathQ_SSL.py:504-544
        for tag, x, y in (("MA", labels, out), ("MB", labels_b, out), ("AB", labels, labels_b)):
            RP.save_scatter_plot(x, y, "Pathologist", "Automated Method",
                                 os.path.join(save_dir, f"BreastPathQ_Eval_2way_{tag}_plot.png"))
            RP.save_bland_altman_plot(x, y, os.path.join(save_dir, f"BDPlot_Eval_2way_{tag}_plot.png"))
    else:
        names = list(D.KATHER_CLASSES) if cfg.name == "kather" else ["normal", "tumor"]
        RP.save_confusion_matrix_plot(np.asarray(report["confusion"]), names,
                                      os.path.join(save_dir, f"{cfg.name}_confusion.png"))
    return path


def evaluate(args, cfg, ckpt: str, test: "tuple | None" = None) -> dict:
    """``--mode evaluation`` (``cli/finetune.py:333-408``): ``ckpt`` (a
    fine-tune or consistency checkpoint) loaded for serving on the run's
    device, the test set through ``predict_all`` at ``--eval_batch_size``,
    its report, and the artifacts under ``--save_dir``.  ``test``, a loaded
    (dataset, second rater's labels or None) pair, stands in for
    ``--test_path``'s.  Returns the report."""
    device = resolve_device(args)
    if test is None and not args.test_path:
        raise SystemExit("--test_path required for evaluation")
    state = init_serving_state(args.model, cfg.num_classes, device, ckpt)
    ds, labels_b = test if test is not None else load_test_set(args, cfg)
    out = predict_all(state, ds, cfg, device, batch_size=args.eval_batch_size, bf16=args.bf16)
    report = eval_report(cfg, ds.labels, out, labels_b)
    write_eval(args.save_dir, cfg, report, ds.labels, out, labels_b)
    return report


def run(args, cfg, train, val) -> FinetuneState:
    """The ``--mode fine-tuning`` loop on loaded datasets (``cli/finetune.py:
    161-294``): per epoch, the train steps over a seeded shuffle (balanced
    tumor/normal batches for Camelyon16) fed one batch ahead by a thread,
    validation, the CSV row, ``best.pth``, and every ``--save_freq`` epochs
    ``ckpt_<epoch>.pth``; ``final.pth`` at the end.  Every checkpoint holds
    the generator of the steps' draws; ``--resume`` restores it with the
    state and starts at the epoch after the checkpoint's."""
    device = resolve_device(args)
    gen = seed_everything(args.seed, device)
    batch_size = args.batch_size or cfg.batch_size
    rows = cfg.rows_per_step(batch_size)
    rows_for_batch(rows)  # an indivisible batch fails before the first step
    n_steps_per_epoch = steps_per_epoch(cfg, train, batch_size)
    if len(val) == 0:
        raise SystemExit("empty validation set -- raise --validation_split or pass --val_path")
    print(f"==> {len(train)} train / {len(val)} val samples; {n_steps_per_epoch} steps an epoch of "
          f"{cfg.rows_per_step(batch_size)} images")

    state = build_state(args, cfg, device, n_steps_per_epoch)
    if args.model_path:
        load_backbone(state, args.model_path)
        print(f"==> loaded pretrained backbone from {args.model_path}")

    os.makedirs(args.save_dir, exist_ok=True)
    log = CsvLogger(os.path.join(args.save_dir, "fine_tuned_results.csv"), "epoch, train_loss, val_metric")
    gens = {"gen": gen}
    best = BestTracker(args.save_dir, mode="min", generators=gens)
    start_epoch, _ = resume_training(args, state, best, gens)
    # captured after the restore: the graph reads the restored tensors
    step = S.make_finetune_multi_step(state, gen, args.multi_step, cfg.task, bf16=args.bf16, global_batch=rows)
    for epoch in range(start_epoch, args.num_epoch + 1):
        t0 = time.time()
        # the sum stays on the device; reading it synchronises
        loss_sum = torch.zeros((), device=device)
        seen = bi = 0
        batches = train_batches(cfg, train, batch_size, args.seed + epoch)
        feed = chunked_feed(device, args.multi_step, batches)
        stretch = StretchCounters(feed, step, state.model)
        for chunk, n_valid in feed:
            ms = step.run(chunk, n_valid)
            for i in range(n_valid):
                loss_sum += ms["loss"][i] * rows
                seen += rows
                bi += 1
                if bi % args.print_freq == 0:
                    print(f"Train: [{epoch}][{bi}] loss {float(ms['loss'][i]):.4f} ({float(loss_sum) / seen:.4f})")
        train_loss = float(loss_sum) / max(seen, 1)
        counters = stretch.line()

        val_metric = validate(cfg, state, val, args.eval_batch_size, device, bf16=args.bf16)
        log.append(epoch, train_loss, val_metric)
        print(f"epoch {epoch}: train_loss {train_loss:.4f} val "
              f"{'mse' if cfg.task == 'regression' else 'err'} {val_metric:.4f} ({time.time() - t0:.1f}s); {counters}")
        meta = {"epoch": epoch, "args": vars(args), "val_metric": val_metric}
        if best.update(val_metric, epoch, state, meta):
            print(f"==> new best {val_metric:.4f}")
        if args.save_freq and epoch % args.save_freq == 0:
            meta["best_val"] = best.best_value
            save_checkpoint(os.path.join(args.save_dir, f"ckpt_{epoch}.pth"), state, meta, gens)
    save_checkpoint(os.path.join(args.save_dir, "final.pth"), state,
                    {"epoch": args.num_epoch, "best_val": best.best_value}, gens)
    return state


def main(argv=None):
    args = apply_reference_exact(parse_args(argv), "finetune")
    cfg = apply_task_overrides(args, TASKS[args.task])
    if args.mode == "evaluation":
        if not args.finetune_ckpt:
            raise SystemExit("--finetune_ckpt required for evaluation")
        return evaluate(args, cfg, args.finetune_ckpt)
    resolve_device(args)  # a missing GPU fails before the data loads
    train, val = load_train_val(args, cfg)
    return run(args, cfg, subsample_labeled(train, args, cfg), val)


if __name__ == "__main__":
    main()
