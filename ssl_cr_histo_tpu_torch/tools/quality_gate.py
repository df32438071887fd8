"""Label-efficiency quality gate: the paper's central claim end to end,
through the port's CLIs.

The port's counterpart of ``tests/test_quality_gate.py``, as a module that
a test and ``chip_smoke.py`` both call.  The reference's headline result
(README.md:57-62) is that RSP pretraining followed by fine-tuning with few
labels beats training from scratch with the same labels, and SSL_CR
consistency training keeps the gain.  On synthetic data:

  stage 1: RSP pretraining on synthetic WSIs (v2 sampler, raw tiles via
           --no_augment: at 32x32 the augmentation pools' rescale ops
           destroy the resolution cue this toy scale depends on; per-view
           BN, the regime the margins were calibrated in) must beat chance
           on the 6-way pretext task;
  stage 2: fine-tune at 25% labels (32 images) from the stage-1 checkpoint
           vs from scratch, identical budgets -- the pretrained arm must
           win by a clear margin on held-out data;
  stage 3: SSL_CR from the stage-2 checkpoint must keep the advantage
           over from-scratch (evaluated at the best-val CR checkpoint).

The downstream task is field-of-view scale discrimination (native 32x32
level-0 crops vs 128x128 crops downsampled 4x): the cue the RSP pretext task
trains.  The aug-on gate pretrains with the full v2 fused augmentation at
64x64 tiles and checks that the backbone still transfers.

Every argv and threshold is the JAX test's, with ``--device`` added and the
port's ``.pth`` checkpoint names.

    python3 -m ssl_cr_histo_tpu_torch.tools.quality_gate --workdir DIR [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np


class GateFailed(AssertionError):
    """A gate's threshold was not met; the message names the gate."""


def _check(cond: bool, gate: str, msg: str) -> None:
    if not cond:
        raise GateFailed(f"{gate}: {msg}")


def make_gate_data(root: str) -> str:
    """The JAX test's ``gate_data`` fixture (``tests/test_quality_gate.py:
    43-75``), file for file: three 1024^2 synthetic slides under
    ``wsis/``, and the scale task's class folders ``train_scale/`` (80
    images a class) and ``test_scale/`` (24) of 32^2 .tif crops."""
    import cv2

    from ssl_cr_histo_tpu_torch.data.wsi import synthetic_wsi

    wsi_dir = os.path.join(root, "wsis")
    os.makedirs(wsi_dir)
    for i in range(3):
        np.save(os.path.join(wsi_dir, f"s{i}.npy"), synthetic_wsi(1024, 1024, seed=i)._levels[0])

    rng = np.random.default_rng(99)

    def make_scale_folder(split_seed, n_per_class, out_dir):
        lvl0 = synthetic_wsi(1024, 1024, seed=split_seed)._levels[0]
        for cls, span in (("ADI", 32), ("TUM", 128)):
            d = os.path.join(out_dir, cls)
            os.makedirs(d)
            k = 0
            while k < n_per_class:
                yx = rng.integers(0, 1024 - span, 2)
                p = lvl0[yx[0]: yx[0] + span, yx[1]: yx[1] + span]
                if p.std() < 8:  # skip background-only crops
                    continue
                if span != 32:
                    p = cv2.resize(p, (32, 32), interpolation=cv2.INTER_AREA)
                cv2.imwrite(os.path.join(d, f"p{k}.tif"), p[:, :, ::-1])
                k += 1

    make_scale_folder(10, 80, os.path.join(root, "train_scale"))
    make_scale_folder(11, 24, os.path.join(root, "test_scale"))
    return root


def pretext_val_acc(save_dir: str) -> float:
    """The last epoch's validation accuracy of a pretraining run."""
    with open(os.path.join(save_dir, "train_results.csv")) as f:
        last = f.read().strip().splitlines()[-1]
    return float(last.split(",")[-1])


def _kather_eval(cli, argv: list, save_dir: str) -> float:
    """``cli.main(argv)`` in --mode evaluation; the accuracy of its
    ``kather_eval.json``.  Where matplotlib is missing the confusion plot
    is listed, not drawn."""
    from ssl_cr_histo_tpu_torch.tools import rehearsal as R

    with R._plots_where_drawable():
        cli.main(argv)
    with open(os.path.join(save_dir, "kather_eval.json")) as f:
        return json.load(f)["accuracy"]


def _eval_acc(out_dir: str, test_dir: str, device: str) -> float:
    from ssl_cr_histo_tpu_torch.cli import finetune

    return _kather_eval(finetune, [
        "--task", "kather", "--mode", "evaluation",
        "--test_path", test_dir, "--image_size", "32",
        "--finetune_ckpt", os.path.join(out_dir, "final.pth"),
        "--save_dir", out_dir, "--no-bf16", "--device", device,
    ], out_dir)


def finetune_25(root: str, tag: str, extra: list, device: str) -> tuple:
    """The 25%-label fine-tune of the scale task (run ``ft_<tag>``); returns
    its dir and held-out accuracy."""
    from ssl_cr_histo_tpu_torch.cli import finetune

    out = os.path.join(root, f"ft_{tag}")
    shutil.rmtree(out, ignore_errors=True)
    finetune.main([
        "--task", "kather", "--train_path", os.path.join(root, "train_scale"),
        "--image_size", "32", "--batch_size", "4",
        "--modules", "60", "--labeled_train", "0.25",
        "--lr", "3e-3", "--num_epoch", "30", "--seed", "42",
        "--validation_split", "0.2", "--save_dir", out, "--no-bf16",
    ] + extra + ["--device", device])
    return out, _eval_acc(out, os.path.join(root, "test_scale"), device)


def main_gate(root: str, device: str = "cuda") -> dict:
    """RSP pretraining, 25%-label fine-tunes from scratch and pretrained, CR
    from the pretrained one (``tests/test_quality_gate.py:90-162``), on
    ``make_gate_data(root)``'s files.  Returns the accuracies; raises
    GateFailed naming the first gate missed."""
    from ssl_cr_histo_tpu_torch.cli import consistency, pretrain

    train_dir, test_dir = os.path.join(root, "train_scale"), os.path.join(root, "test_scale")

    # stage 1: RSP pretraining learns the pretext task
    s1 = os.path.join(root, "stage1")
    pretrain.main([
        "--train_image_pth", os.path.join(root, "wsis"), "--variant", "v2",
        "--tile_h", "32", "--tile_w", "32", "--tile_stride", "32",
        "--batch_size", "8", "--num_epoch", "10", "--validation_size", "16",
        "--save_freq", "10", "--steps_per_epoch", "60", "--no_augment",
        "--no_joint_encode",
        "--save_dir", s1, "--no-bf16", "--device", device,
    ])
    val_acc = pretext_val_acc(s1)
    # 6-way chance = 0.167
    _check(val_acc > 0.30, "pretext", f"RSP pretext task not learned (val acc {val_acc})")

    # stage 2: 25%-label fine-tune, scratch vs pretrained
    _, acc_scratch = finetune_25(root, "scratch", [], device)
    ft_pre, acc_pre = finetune_25(root, "pre", ["--model_path", os.path.join(s1, "ckpt_10.pth")], device)
    print(f"25%-label test acc: scratch {acc_scratch:.3f} pretrained {acc_pre:.3f}")
    _check(acc_scratch > 0.5, "scratch", f"the scratch arm is not a sane learner: {acc_scratch}")
    _check(acc_pre >= 0.85, "pretrained", f"pretrained arm too weak: {acc_pre}")
    _check(acc_pre >= acc_scratch + 0.10, "label-efficiency",
           f"label-efficiency gap missing: scratch {acc_scratch} vs pretrained {acc_pre}")

    # stage 3: SSL_CR keeps the advantage
    cr = os.path.join(root, "cr")
    consistency.main([
        "--task", "kather", "--train_path", train_dir,
        "--finetune_ckpt", os.path.join(ft_pre, "final.pth"),
        "--image_size", "32", "--batch_size", "4",
        "--mu", "2", "--NAug", "2", "--labeled_train", "0.25",
        "--lr", "1e-3", "--num_epoch", "10", "--seed", "42",
        "--modules_student", "60",
        "--validation_split", "0.2", "--save_dir", cr, "--no-bf16", "--device", device,
    ])
    # evaluated by the CR CLI at the best-val checkpoint, the recipe of
    # record (the final epoch's student drifts under noisy toy-scale
    # pseudo-labels)
    acc_cr = _kather_eval(consistency, [
        "--task", "kather", "--mode", "evaluation",
        "--test_path", test_dir, "--image_size", "32",
        "--eval_ckpt", os.path.join(cr, "best.pth"),
        "--save_dir", cr, "--no-bf16", "--device", device,
    ], cr)
    print(f"CR test acc: {acc_cr:.3f}")
    _check(acc_cr >= acc_scratch + 0.10, "cr",
           f"CR lost the pretraining advantage: {acc_cr} vs scratch {acc_scratch}")
    return {"pretext_val_acc": val_acc, "scratch": acc_scratch, "pretrained": acc_pre, "cr": acc_cr}


def aug_pretrain_argv(root: str, save_dir: str, device: str) -> list:
    """The aug-on gate's pretraining: v2 with the fused augmentation at
    64^2 tiles, 8 epochs of at most 60 steps of 8 triplets."""
    return [
        "--train_image_pth", os.path.join(root, "wsis"), "--variant", "v2",
        "--tile_h", "64", "--tile_w", "64", "--tile_stride", "32",
        "--batch_size", "8", "--num_epoch", "8", "--validation_size", "16",
        "--save_freq", "8", "--steps_per_epoch", "60",
        "--aug_mode", "fused", "--NAug", "2", "--Magn", "3",
        "--save_dir", save_dir, "--no-bf16", "--device", device,
    ]


def aug_transfer(root: str, device: str) -> float:
    """The aug-on gate's second half: the 25%-label fine-tune from its
    pretraining's ``stage1_aug/ckpt_8.pth``; its held-out accuracy."""
    _, acc = finetune_25(root, "aug", ["--model_path", os.path.join(root, "stage1_aug", "ckpt_8.pth")], device)
    return acc


def aug_gate(root: str, device: str = "cuda") -> dict:
    """The aug-on gate (``tests/test_quality_gate.py:165-202``): RSP
    pretraining with the full v2 fused augmentation at 64^2 tiles must beat
    chance on the pretext task, and its backbone must still transfer to
    the 25%-label task.  Returns the accuracies; raises GateFailed naming
    the gate missed."""
    from ssl_cr_histo_tpu_torch.cli import pretrain

    s1 = os.path.join(root, "stage1_aug")
    pretrain.main(aug_pretrain_argv(root, s1, device))
    val_acc = pretext_val_acc(s1)
    _check(val_acc > 0.30, "aug-pretext", f"pretext not learned under augmentation ({val_acc})")

    acc = aug_transfer(root, device)
    print(f"aug-on gate: pretext val acc {val_acc:.3f}, 25%-label test acc {acc:.3f}")
    _check(acc >= 0.80, "aug-transfer", f"aug-pretrained transfer too weak: {acc}")
    return {"pretext_val_acc": val_acc, "transfer": acc}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("label-efficiency quality gate (PyTorch / CUDA)")
    p.add_argument("--workdir", required=True, help="an empty or missing directory for the data and runs")
    p.add_argument("--device", default="cuda", help="the stage CLIs' --device; 'cpu' runs the gates on the CPU")
    args = p.parse_args(argv)
    make_gate_data(args.workdir)
    try:
        results = {"main": main_gate(args.workdir, args.device), "aug": aug_gate(args.workdir, args.device)}
    except GateFailed as exc:
        raise SystemExit(f"quality gate FAILED: {exc}")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
