"""Teacher/student consistency training (SSL_CR stage 3) on a GPU.

Counterpart of ``ssl_cr_histo_tpu/cli/consistency.py:45-349``, ``--mode
fine-tuning`` and ``--mode evaluation`` for the Kather, BreastPathQ and
Camelyon16 tasks.  Kather's
CR config of record (reference eval_Kather_SSL_CR.py:267;
``cli.common.TASKS``): 9 classes at 224^2, 8 labeled images a step (24
views after the 3-view stack), mu 7 (56 unlabeled images a step, each with
a weak and a strong view), NAug 7 strong stages at magnitudes in [1, 10),
lambda_u 1, the tensors below ``--modules_student`` 60 frozen, Adam 1e-5
with L2 1e-4 added to the gradient, MultiStepLR at epochs [30, 60] (in
steps) with gamma 0.1, bf16 autocast, and the teacher refreshed from the
student at the end of each epoch.  Teacher and student start from a
fine-tune checkpoint (``--finetune_ckpt``: a ``.pth`` of the port or the
reference, or a checkpoint directory of the JAX package).  Camelyon16's
CR config (eval_Camelyon_SSL_CR.py:247): 8 labeled images from each of the
tumor and normal pools and 56 unlabeled from each (mu 7) a step at 256^2,
the four balanced iterators (tumor/normal x labeled/unlabeled) zipped,
SGD-Nesterov 5e-4.

    python -m ssl_cr_histo_tpu_torch.cli.consistency --task kather --train_path CLASS_DIRS/ \\
        --finetune_ckpt FT_RUN/best.pth --save_dir RUN/

Writes ``consistency_results.csv``, ``best.pth``, ``ckpt_<epoch>.pth`` and
``final.pth`` under ``--save_dir`` in the fine-tune layout (the student's
TripletNet under ``'model'``, its head under ``'classifier'``), and with
``--ema`` the teacher's own ``teacher_best.pth``, ``teacher_ckpt_<epoch>.pth``
and ``teacher_final.pth``.  ``--resume ckpt_<N>.pth|auto`` continues a run
from its checkpoint (under ``--ema`` the teacher from its ``teacher_``
file).  ``--mode evaluation`` scores ``--eval_ckpt`` (else
``--finetune_ckpt``) on ``--test_path`` as the fine-tune CLI does.
``--aug_mode`` picks the strong views' policy (``ops.batch.
transform_fix_batch``: fused, fast, masked or exact), ``--remat``
recomputes the student's blocks in the backward pass, ``--reference_exact``
applies the strict-parity preset (float32, exact views, with-replacement
subsampling).  ``--multi_step K`` (default 8) trains K batch pairs a chunk
(``parallel.steps.make_consistency_multi_step``): on the card each step's
weak and strong views are made eagerly (their ops are grouped on the host),
then one captured CUDA graph runs the rest of the step, under ``--ema`` the
teacher's update too; the per-epoch teacher refresh, validation and
evaluation stay eager.

On N cards: ``python3 -m torch.distributed.run --nproc_per_node N -m
ssl_cr_histo_tpu_torch.cli.consistency ...``; every process reads the same
labeled and unlabeled batches and trains on its 1/N of each
(``parallel.distributed``), and the primary writes.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ssl_cr_histo_tpu_torch.cli.common import (
    CHECKPOINT_HELP,
    TASKS,
    StretchCounters,
    add_common_args,
    add_multi_step_arg,
    apply_reference_exact,
    apply_task_overrides,
    chunked_feed,
    make_optimizer,
    resolve_device,
    resume_training,
    seed_everything,
)
from ssl_cr_histo_tpu_torch.cli.finetune import (
    evaluate,
    load_train_val,
    steps_per_epoch,
    subsample_labeled,
    train_batches,
    validate,
)
from ssl_cr_histo_tpu_torch.parallel import steps as S
from ssl_cr_histo_tpu_torch.parallel.mesh import rows_for_batch
from ssl_cr_histo_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from ssl_cr_histo_tpu_torch.train.init import init_finetune_state, init_teacher, load_finetuned
from ssl_cr_histo_tpu_torch.train.loop import BestTracker, CsvLogger
from ssl_cr_histo_tpu_torch.train.state import FinetuneState


def parse_args(argv=None):
    p = argparse.ArgumentParser("SSL_CR consistency training (PyTorch / CUDA)")
    p.add_argument("--task", required=True, choices=list(TASKS))
    p.add_argument("--mode", default="fine-tuning", choices=["fine-tuning", "evaluation"])
    p.add_argument("--train_path", default="",
                   help="train data dir: the labeled fraction supervises, the whole train split is "
                        "the unlabeled pool; Camelyon16 takes two comma-joined patch dirs, tumor and normal")
    p.add_argument("--json_path", default="", help="Camelyon16 annotation JSON dir")
    p.add_argument("--val_path", default="",
                   help="explicit validation data dir(s); when set the whole --train_path trains "
                        "and --validation_split is ignored")
    p.add_argument("--val_json_path", default="",
                   help="annotation JSON dir for --val_path (defaults to --json_path)")
    p.add_argument("--with_replacement", action="store_true",
                   help="reproduce the reference's labeled subsampling with replacement")
    p.add_argument("--test_path", default="", help="eval data dir (mode=evaluation)")
    p.add_argument("--test_path_b", default="", help="BreastPathQ second-rater dir")
    p.add_argument("--finetune_ckpt", default="",
                   help="stage-2 checkpoint initializing teacher and student: " + CHECKPOINT_HELP)
    p.add_argument("--eval_ckpt", default="",
                   help="trained consistency checkpoint to evaluate (mode=evaluation; default "
                        "--finetune_ckpt): " + CHECKPOINT_HELP)
    p.add_argument("--mu", type=int, default=7, help="unlabeled batch multiplier")
    p.add_argument("--NAug", type=int, default=7, help="strong-augmentation stages")
    p.add_argument("--lambda_u", type=float, default=1.0, help="weight of the consistency loss")
    p.add_argument("--modules_student", type=int, default=60,
                   help="freeze the first N torch-ordered tensors of the student")
    p.add_argument("--labeled_train", type=float, default=0.1)
    p.add_argument("--labeled_views", type=int, default=3, choices=[1, 3],
                   help="3 = the reference's 3-view labeled branch; 1 = raw labeled images")
    p.add_argument("--validation_split", type=float, default=0.2)
    p.add_argument("--num_epoch", type=int, default=90)
    p.add_argument("--batch_size", type=int, default=0, help="labeled images a step (0 = task CR default)")
    p.add_argument("--lr", type=float, default=0.0, help="0 = task default")
    p.add_argument("--weight_decay", type=float, default=1e-4,
                   help="L2 added to grads before the update (torch semantics)")
    add_multi_step_arg(p)
    p.add_argument("--resume", default="",
                   help="a ckpt_<N>.pth to resume from, or 'auto' for the latest under --save_dir")
    p.add_argument("--save_freq", type=int, default=10,
                   help="epochs between periodic ckpt_N checkpoints (0 = off)")
    p.add_argument("--ema", type=float, default=0.0,
                   help=">0: EMA teacher (weights and BN statistics) after every step instead of the "
                        "per-epoch refresh (not the reference's semantics)")
    p.add_argument("--eval_batch_size", type=int, default=64,
                   help="batch of per-epoch validation and --mode evaluation")
    add_common_args(p)
    return p.parse_args(argv)


def resume_teacher(args, teacher, state: FinetuneState, resume_path: str) -> None:
    """The teacher of a resumed run: with the per-epoch refresh it equals the
    student at an epoch's end; under ``--ema`` it is its own
    ``teacher_<name>`` beside the resumed checkpoint, or, when that file is
    missing, the student again, with a warning (``cli/consistency.py:
    221-246``)."""
    rdir, rbase = os.path.split(resume_path)
    teacher_path = os.path.join(rdir, f"teacher_{rbase}")
    if args.ema > 0 and os.path.isfile(teacher_path):
        restore_checkpoint(teacher_path, teacher, restore_opt=False)
        return
    if args.ema > 0:
        print(f"WARNING: --ema {args.ema} but no teacher checkpoint at {teacher_path}; resetting the EMA teacher "
              f"to the student (accumulated EMA state from the interrupted run is lost)")
    S.refresh_teacher(teacher, state)


def run(args, cfg, labeled, train, val) -> FinetuneState:
    """The ``--mode fine-tuning`` loop on loaded datasets
    (``cli/consistency.py:145-349``): per epoch, labeled batches of B (seed
    ``seed + epoch``) zipped with unlabeled batches of B * mu from the whole
    train split (seed ``1000 + seed + epoch``), each fed one batch ahead by a
    thread (for Camelyon16 both balanced, B and B * mu from each pool); a
    consistency step per pair; the teacher refreshed from the student at the
    end of the epoch (or EMA-updated after each step under ``--ema``);
    validation of the student, the CSV row, ``best.pth``, and every
    ``--save_freq`` epochs ``ckpt_<epoch>.pth``; ``final.pth`` at the end.
    Every checkpoint holds both generators; ``--resume`` restores them with
    the student and starts at the epoch after the checkpoint's, the teacher
    refreshed from the student, or under ``--ema`` loaded from its own
    ``teacher_<name>`` file (``cli/consistency.py:221-246``).  Returns the
    student."""
    device = resolve_device(args)
    gen = seed_everything(args.seed, device)
    # the augmentation tables' host generator (ops.batch.draw_transform_fix)
    host_gen = torch.Generator().manual_seed(args.seed + 1)
    batch_size = args.batch_size or cfg.cr_batch
    rows = cfg.rows_per_step(batch_size)
    # an indivisible batch fails before the first step
    rows_for_batch(rows)
    rows_for_batch(rows * args.mu)
    # labeled and unlabeled batch counts (for a balanced task, of the four
    # zipped loaders, ``cli/consistency.py:165-183``); zero raises SystemExit
    n_labeled = steps_per_epoch(cfg, labeled, batch_size)
    n_unlabeled = steps_per_epoch(cfg, train, batch_size * args.mu)
    if len(val) == 0:
        raise SystemExit("empty validation set -- raise --validation_split or pass --val_path")
    n_steps = min(n_labeled, n_unlabeled)
    print(f"==> {len(labeled)} labeled / {len(train)} unlabeled / {len(val)} val; {n_steps} steps an epoch")

    lr = args.lr or cfg.lr
    state = init_finetune_state(
        args.model, cfg.num_classes, device,
        lambda params: make_optimizer(cfg.optimizer, params, lr, args.weight_decay),
        modules=args.modules_student,
        milestones_steps=[m * n_steps for m in cfg.milestones],
        gamma=cfg.gamma,
        remat=args.remat,
    )
    load_finetuned(state, args.finetune_ckpt)
    print(f"==> teacher and student from {args.finetune_ckpt}")
    teacher = init_teacher(state)

    os.makedirs(args.save_dir, exist_ok=True)
    log = CsvLogger(os.path.join(args.save_dir, "consistency_results.csv"),
                    "epoch, train_loss, sup_loss, cons_loss, val_metric")
    gens = {"gen": gen, "host_gen": host_gen}
    best = BestTracker(args.save_dir, mode="min", generators=gens)
    save_teacher = lambda name, meta: save_checkpoint(os.path.join(args.save_dir, f"teacher_{name}"), teacher,
                                                      dict(meta, role="teacher"))
    start_epoch, resume_path = resume_training(args, state, best, gens)
    if resume_path:
        resume_teacher(args, teacher, state, resume_path)
    # captured after the restore: the graph reads the restored tensors
    step = S.make_consistency_multi_step(state, teacher, gen, args.multi_step, cfg.task, args.lambda_u, args.NAug,
                                         labeled_views=args.labeled_views, host_gen=host_gen,
                                         aug_mode=args.aug_mode, bf16=args.bf16, global_batch=rows, ema=args.ema)
    for epoch in range(start_epoch, args.num_epoch + 1):
        t0 = time.time()
        # the sums stay on the device; reading them synchronises
        sums = torch.zeros(3, device=device)
        seen = 0
        lab_it = train_batches(cfg, labeled, batch_size, args.seed + epoch)
        unlab_it = ((imgs,) for imgs, _ in train_batches(cfg, train, batch_size * args.mu,
                                                         1000 + args.seed + epoch))
        bi = 0
        feed = chunked_feed(device, args.multi_step, lab_it, unlab_it)
        stretch = StretchCounters(feed, step, state.model, teacher.model)
        for chunk, n_valid in feed:
            ms = step.run(chunk, n_valid)
            for i in range(n_valid):
                sums += torch.stack([ms["loss"][i], ms["sup"][i], ms["cons"][i]]) * rows
                seen += rows
                bi += 1
                if bi % args.print_freq == 0:
                    print(f"Train: [{epoch}][{bi}/{n_steps}] loss {float(ms['loss'][i]):.4f}")
        if args.ema == 0:
            S.refresh_teacher(teacher, state)
        train_loss, sup_loss, cons_loss = (sums / max(seen, 1)).tolist()
        counters = stretch.line()

        val_metric = validate(cfg, state, val, args.eval_batch_size, device, bf16=args.bf16)
        log.append(epoch, train_loss, sup_loss, cons_loss, val_metric)
        print(f"epoch {epoch}: loss {train_loss:.4f} (sup {sup_loss:.4f} cons {cons_loss:.4f}) val "
              f"{'mse' if cfg.task == 'regression' else 'err'} {val_metric:.4f} ({time.time() - t0:.1f}s); {counters}")
        meta = {"epoch": epoch, "args": vars(args), "val_metric": val_metric}
        if best.update(val_metric, epoch, state, meta):
            print(f"==> new best {val_metric:.4f}")
            if args.ema > 0:
                save_teacher("best.pth", {"epoch": epoch})
        if args.save_freq and epoch % args.save_freq == 0:
            meta["best_val"] = best.best_value
            save_checkpoint(os.path.join(args.save_dir, f"ckpt_{epoch}.pth"), state, meta, gens)
            if args.ema > 0:
                save_teacher(f"ckpt_{epoch}.pth", {"epoch": epoch})
    # with the per-epoch refresh the teacher equals the student here
    save_checkpoint(os.path.join(args.save_dir, "final.pth"), state,
                    {"epoch": args.num_epoch, "best_val": best.best_value,
                     "teacher": "ema (teacher_final.pth)" if args.ema > 0 else "equals the student"}, gens)
    if args.ema > 0:
        save_teacher("final.pth", {"epoch": args.num_epoch})
    return state


def main(argv=None):
    args = apply_reference_exact(parse_args(argv), "consistency")
    cfg = apply_task_overrides(args, TASKS[args.task])
    if args.mode == "evaluation":
        # the reference CR scripts' own --mode evaluation (eval_Kather_SSL_CR.py:643-666), through the
        # fine-tune CLI's evaluator (``cli/consistency.py:127-143``)
        ckpt = args.eval_ckpt or args.finetune_ckpt
        if not ckpt:
            raise SystemExit("--eval_ckpt required for evaluation")
        return evaluate(args, cfg, ckpt)
    if not args.train_path or not args.finetune_ckpt:
        raise SystemExit("--train_path and --finetune_ckpt required for fine-tuning")
    resolve_device(args)  # a missing GPU fails before the data loads
    train, val = load_train_val(args, cfg)
    return run(args, cfg, subsample_labeled(train, args, cfg), train, val)


if __name__ == "__main__":
    main()
