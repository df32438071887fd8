#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the port's CUDA
kernels, checks each against its plain PyTorch version, drives the
pretraining CLI for one short epoch at the config of record, the
fine-tuning and consistency CLIs from its checkpoint for Kather and then
Camelyon16, the heatmap CLI and the FROC from the Camelyon16 checkpoint,
the CLIs' resume, the pretrain flags and evaluation, every augmentation
mode, v2 pretraining, --reference_exact and --remat, the pretrain CLI and
step across processes (a world of one over NCCL, of two over gloo on the
one card), the three tasks' full recipes at the config of record held to
their quality bands, the label-efficiency protocol's dryrun, the step
profiler and the label-efficiency gate, carries checkpoints of the JAX
package's format to the port's CLIs, and times the steps, the serving
forward, evaluation and the kernels.

    python3 chip_smoke.py                    # from the root of a checkout, on a GPU machine
    python3 chip_smoke.py --profile DIR      # also write torch.profiler tables of the steps, phase 14's trace
    python3 chip_smoke.py --reports DIR      # keep phases 13-15's reports and logs

(Phase 12 starts this script again as its own worker processes, with
``--cli-worker`` or ``--gloo-worker`` as the first argument.)

Phases (any failure exits non-zero and prints no result line):
  1. the card (nvidia-smi name and power limit); no CUDA -> exit 1
  2. build the three kernels from csrc/ with nvcc, in parallel, and print each
     build's -Xptxas -v report (registers, shared memory, spills); a kernel
     that spills fails the run
  3. the photometric chain kernel vs its plain version, host-noise mode, at
     (192, 3, 256, 256) and at an odd shape (4, 3, 37, 37): max abs err
     <= 1e-4; Philox mode: deterministic, seed-sensitive, equal to the
     plain Philox chain (<= 1e-4), and N(0, sigma) noise by moments; both
     modes at shapes the cluster launch covers unevenly (50 x 64, 13 x 20,
     tiles smaller than the blur's halo, one 256^2 tile more than the card
     runs clusters at once); a 260-pixel row refused, naming the shape
  4. the fused augmentation kernel vs its plain version at the main path's
     (64, 3, 256, 256, 3) and at (2, 3, 37, 37, 3), params drawn, all gates
     on and all gates off, host noise and Philox, with and without a
     triplet ordering: finite, float32 out within 1e-4, bf16 out within one
     bf16 ulp of the plain float32 result (or 1e-4 where an ulp is
     smaller); the warp plan the kernel computes (``plan_out``) equal to
     ``warp_pass_coefficients`` on the card and on the CPU; then the strong
     views kernel (``phase_views_vs_plain``) against its plain version on
     the card at the CR cell's (112, 256, 256, 3), NAug 7: fused, fast and
     masked as drawn and fused with every gate on, weak and strong within
     1e-5, one launch a call; the wrapper, the whole call and the plain
     version timed in turns, and the kernel's byte bound
  5. main path: a small float32 step on the card must agree with the same
     step on the CPU (plain versions); then ``ssl_cr_histo_tpu_torch.cli.
     pretrain.main`` on two synthetic slides at resnet18 / batch 64 / 256^2 /
     bf16 / joint encode, one epoch at the default ``--multi_step 8`` (the
     first step eager, then a captured CUDA graph replayed a step), with
     every launch counter set to 0 just before and read just after: the
     fused kernel must launch once per train step, replays included, and
     the chain kernel never; the epoch line's trunk forwards all
     channels-last (the ResNet trunk's layout on the card); the epoch's
     wall time (the CLI's print;
     batches come through its prefetch threads) beside the stream time
     between the CUDA events around each step; the checkpoint's float32
     forward on the card must agree with the CPU's; then the same CLI run
     four times more at ``--multi_step 1``, warm, with the inline feed it
     had before the prefetch thread and with the prefetch thread (inline,
     prefetch, prefetch, inline), each run's epoch wall printed
  6. fine-tuning: the 3-view augmentation and a float32 fine-tune step on
     the card against the CPU; then ``ssl_cr_histo_tpu_torch.cli.finetune.
     main`` at Kather's config of record (9 classes, resnet18, batch 64 at
     224^2, bf16, Adam 1e-5) for one 4-step epoch on seeded PNG class
     folders, from phase 5's ``ckpt_1.pth``, with every launch counter set
     to 0 just before and read just after: neither kernel may launch (the
     3-view stack is PyTorch ops, as it is XLA ops in the JAX package); the
     CSV row and the best / final checkpoints; BreastPathQ's regression
     head through ``finetune.run`` on numpy data; the bf16 step and the
     3-view stack alone timed with CUDA events (``--profile``: the step's
     profile table too)
  7. consistency training: the weak/strong views (all nine strong ops, maps
     on both sides of +-45 degrees) and a float32 consistency step on the
     card against the CPU (the teacher must not move); then
     ``ssl_cr_histo_tpu_torch.cli.consistency.main`` at Kather's CR config
     of record (resnet18, 8 labeled + 56 unlabeled images at 224^2, NAug 7,
     bf16, Adam 1e-5) for one epoch on phase 6's PNG class folders from
     phase 6's ``best.pth``, with every launch counter set to 0 just before
     and read just after: the strong views kernel launches once a step
     (the steps the CLI's StepGraph takes) and neither pretraining kernel
     ever; the CSV row and the best / final checkpoints; BreastPathQ's
     regression variant through ``consistency.run`` on numpy data (batch
     4, mu 7, 256^2), counted the same way; the bf16 step
     and the views alone timed with CUDA events (``--profile``: the step's
     profile table too)
  8. timing with CUDA events, in turns (old, fused, fused, old): the bf16
     step with the fused kernel against the step with the unfused composition
     (plain warp + chain kernel + clip + normalize), the fused kernel
     against that composition alone, the plain versions; the fused kernel's
     time (torch.profiler) in both noise modes and by gate, beside its
     wrapper called back to back; the chain kernel in both noise modes, its
     launch plan, clusters at once and waves, and its time by gate
  9. Camelyon16, from phase 5's ``ckpt_1.pth`` to a scored heatmap: seeded
     tumor and normal patch dirs of 256^2 PNGs with list.txt and annotation
     JSONs, two 8192^2 slides (a tumor and a normal one) with tissue masks
     at resolution 64 (128 x 128 cells, half tissue: 8192 patches a slide,
     fewer than a real Camelyon16 slide has) and the tumor slide's
     ground-truth mask; ``cli.finetune`` with ``--task camelyon16`` (16
     images a pool, 96 views a step, 256^2, bf16, SGD-Nesterov) for one
     4-step epoch, ``cli.consistency`` with ``--task camelyon16`` (8
     labeled + 56 unlabeled images a pool) for one step from its
     ``best.pth``, ``cli.heatmap`` (batch 256, 256^2, bf16) over both slides
     from that ``best.pth``, each with every launch counter set to 0 just
     before and read just after (the strong views kernel once in the
     consistency step, no other launch); each map's
     shape, values in [0, 1], 0 exactly off the mask, the artifacts; one
     map card vs CPU in float32 on a 2048^2 crop (max abs diff <= 1e-4);
     ``cli.froc`` on the maps and its report; the fine-tune step, the
     consistency step and the serving forward at batch 256 timed with CUDA
     events, and each map's wall time as patches/s against the sum of its
     forwards (``--profile``: the map's device busy share and
     ``heatmap_profile.txt``)
 10. the stage CLIs' remaining modes, on phases 5-9's checkpoints and data:
     ``cli.pretrain`` for 2 epochs of 2 steps (batch 64, 256^2, bf16) against
     1 epoch and ``--resume auto`` for the second, with cuDNN's deterministic
     algorithms: ckpt_2.pth bit-equal (weights, optimizer, Lookahead,
     step, generator, best value); ``--expand_orderings --cache_tiles
     --tsne`` for 2 full epochs: the fused kernel launched once a step (6x
     a plain epoch's), each triplet position read once, the features'
     shapes; ``--mode evaluation`` of ``cli.finetune`` for Kather (phase
     6's best.pth, a seeded test folder of 576 images: the report's keys,
     float32 logits card vs CPU within 1e-4; predict_all's images/s warm
     over 7180 images, beside its feed alone and its forward alone),
     BreastPathQ through the report function on numpy data (two raters)
     and Camelyon16 (phase 9's best.pth on its VALID patches); ``cli.
     consistency --mode evaluation`` on phase 7's best.pth, and a run with
     ``--ema`` resumed for a second epoch, its teacher restored bit-equal to
     teacher_ckpt_1.pth.  No kernel may launch on an evaluation path; the
     strong views kernel launches once a consistency training step.
     Where matplotlib or scikit-learn is missing, the plots are recorded,
     not drawn, and the phase prints which it did not draw
 11. the augmentation modes and the last stage-CLI flags: each new op
     (the gather warp, rot90, the PIL ops, autocontrast, equalize, the HED
     and HSB augmenters) card vs CPU in float32 within 1e-4, equalize,
     autocontrast and PIL's gray level equal exactly; each new policy (v1
     pretraining op by op, v2 fused / masked / exact, the consistency views
     under fast / masked / exact) card vs CPU, within 1e-4 (a v2 policy at
     its 99.9th percentile); ``cli.pretrain`` with ``--variant v2`` (batch
     64, 256^2, bf16, 4 steps; neither kernel), ``--aug_mode fast`` (the
     fused kernel once a step) and ``--reference_exact`` (no kernel,
     float32, per-view BN, the x6 orderings), and ``cli.consistency`` at
     Kather's CR config under ``--aug_mode fast``, ``masked`` (the strong
     views kernel once a step) and ``exact`` (no kernel), each with every
     launch counter set to 0 just
     before and read just after; a ``--remat`` step held against the CPU's
     float64 step: the card's float64 step within 1e-5, the card's float32
     step at most 3 times as far from it as the CPU's float32 step (largest
     entry; float32 rounding in another reduction order, amplified by the
     step, reads up to 1.4e-4 against the CPU's float32 step), and the
     card's float32 step against the step without it; resnet50 at 64 triplets of 256^2, bf16,
     with and without ``--remat`` in turns: peak memory and step time; the
     v2 (fused, masked) and v1 exact pretrain steps and the Kather CR
     consistency step under each mode timed, with the views' share and the
     kernel launches a step (``--profile``: each mode's profile table)
 12. data parallelism (``parallel.distributed``): the pretrain CLI at the
     config of record (resnet18, 64 triplets of 256^2, bf16, the fused
     kernel) for one 11-step epoch (a chunk of 8 steps, the default
     ``--multi_step``, and one of 3), cuDNN deterministic, each run a fresh
     process started by this script, plain and then under ``python3 -m
     torch.distributed.run --standalone --nproc_per_node 1`` (NCCL, a world
     of one): the world-1 run's ``ckpt_1.pth`` bit-equal to the plain
     run's, each run's fused
     kernel launched once a step and the chain kernel never (counted in each
     process from 0), no ``torch.distributed`` collective issued in any
     run, the card's kernels (by name and count, from ``torch.profiler``)
     equal in both runs, and the card's time over the world-1 run at most
     1.15 times the plain run's; each run's step times (CUDA events around
     each step) printed, not bounded (at ``--multi_step 1`` they follow the
     host's speed); then two processes on the one card over gloo (NCCL refuses two
     ranks on one device), two pretrain steps at the main path's shapes on
     32 triplets each of a global batch of 64, against the same two steps
     in this process on the whole batch, the model in float32 and then in
     float64 (on the kernel's float32 views): each rank's fused-kernel
     outputs bit-equal to its rows of this process's, one fused launch a
     step on each rank; in float64 the losses within rtol 1e-5 and every
     parameter within 1e-5 of its tensor's largest entry; in float32 each
     run's losses within rtol 1e-4 of the float64 losses (their float32
     rounding reads up to 4.9e-5 at the second step, in a world of one or
     two and in either layout, so the two float32 runs are not held to
     each other), the
     parameters' distance from the float64 step (L2 over all of them) at
     most twice the one-process float32 step's, and each tensor's gap
     printed: float32 parts two reduction orders by more than 1e-5 of some
     tensors (a convolution's weight gradient sums millions of products whose
     BatchNorm factors cancel; a bias that starts at 0 is as large as its
     two updates).  The gloo steps' times are printed as correctness only (gloo
     stages through the host).  A run on several cards waits for a runner
     that has them
 13. the full-recipe rehearsal (``ssl_cr_histo_tpu_torch.tools.rehearsal``)
     at the config of record, bands enforced: the Camelyon16 recipe
     (pretrain 25 epochs of at most 24 steps of 64 triplets of 256^2: the
     two 6400^2 slides hold 415 positions, 351 after the 64 held out, so 5
     steps an epoch, 125 in all; fine-tune 5 epochs, consistency 3,
     evaluation, heatmap over two 8192^2 slides, FROC), then BreastPathQ
     (``--bpq_data arrays``; 5 + 3 epochs, two-rater evaluation) and Kather
     (224^2; 60 + 10 epochs, evaluation) from the Camelyon16 recipe's
     pretraining (``--stage1_ckpt``); every stage CLI's epoch line counting
     channels-last trunk forwards alone; every launch counter set to 0 before
     each stage and read after: the fused kernel once a pretrain step (as
     many steps as the checkpoint counts) and never in another stage, the
     chain kernel never; each stage's seconds, each banded metric beside
     its band, the pretraining's augmented patches/s and the heatmap's
     patches/s, incl. I/O.  A band violation or a launch count that is off
     fails the run
 14. the label-efficiency protocol (``ssl_cr_histo_tpu_torch.tools.
     parity_run --dryrun``) for the three tasks at the config of record's
     sizes (256^2, Kather 224^2; BreastPathQ ``--bpq_data arrays``), cut to
     fractions 0.1 and 1.0, 2 fine-tune and 1 CR epochs: each task's table
     printed, every headline metric present and finite; every launch
     counter set to 0 before the dryrun's stage 1 and each fraction and
     read after: the fused kernel once a stage-1 pretrain step and never
     in a ``--reference_exact`` stage, the chain kernel never; then
     ``tools.profile_step`` at the config of record (pretrain, resnet18, 64
     triplets of 256^2, bf16, fused, ``--multi_step 1``, 3 traced steps):
     ms/step, its top 10 device operations, and its trace file must hold
     the fused kernel 3 times
 15. the label-efficiency quality gate (``tools.quality_gate``), cuDNN and
     PyTorch deterministic: the main gate with every threshold of
     ``tests/test_quality_gate.py`` enforced (a miss fails the run); the
     aug-on gate at the JAX test's argv: its transfer check enforced, its
     pretext check's verdict printed and the check enforced as a majority
     over its pretraining at seeds 42 and 1-12 (ROADMAP Queue 3 item 4);
     neither pretraining kernel may launch, the strong views kernel once a
     consistency step
 16. ``--multi_step`` (``phase_multi_step``), cuDNN and PyTorch
     deterministic: each stage CLI at the config of record at
     ``--multi_step 8`` and then 1 (the pretrain CLI for 11 steps, Kather's
     fine-tune, Kather's consistency under ``--aug_mode`` fused and masked,
     Camelyon16's fine-tune), every pair's ``ckpt_1.pth`` bit-equal in
     every leaf (weights, BN statistics, optimizer state, schedule,
     Lookahead, step, generators, meta), and phase 12's NCCL world-1 run at
     8 bit-equal to the plain run at 1; the K = 8 pretrain run traced:
     ``rsp_augment_kernel`` once a step inside the graph, one graph launch
     a step after the first
 17. (no phase: the port's throughput is measured by ``port_bench``)
 18. checkpoints the JAX package trained (``phase_jax_checkpoint``): phase
     5's pretrain ``ckpt_1.pth`` (SGD-Nesterov, Lookahead, a Classifier)
     and phase 9's Camelyon16 fine-tune ``best.pth`` (Adam, a 2-way head)
     written as the JAX package's checkpoint directories (the card's
     machine has no flax: ``msgpack_pack`` and ``jax_tree``, the inverse of
     ``from_jax_params``, write the format here), each converted back by
     ``python3 -m ssl_cr_histo_tpu_torch.cli.convert_checkpoint`` in a
     process of its own: every tensor bit-equal to the source's but
     ``num_batches_tracked`` (0, as the JAX tool writes it), the epoch
     kept; the heatmap CLI over the tumor slide from the fine-tune
     directory against the ``.pth`` (maps bit-equal, or within 1e-6 with
     the reason printed); the Camelyon16 fine-tune CLI for its 4 steps
     with ``--model_path`` the pretrain directory; each CLI with every
     launch counter at 0 before and read after (neither kernel may
     launch); the conversion's wall for the resnet18 directories and a
     resnet50 one from a fresh state with Adam's moments (as a process,
     and read / to the reference layout / ``torch.save`` in this one)
 19. the whole run's wall time, the kernels line, then ``{"ok": true,
     "device": {...}}`` as the last line.  A kernel's ``launches`` is the
     count on its main path: phase 5's pretrain CLI for the two pretraining
     kernels, phase 7's consistency CLI for the strong views kernel;
     ``launches_by_path`` adds phase 7's two consistency paths, each CLI
     path of phases 10 and 11, each process of phase 12's paths, each stage of
     phase 13's recipes and phase 14's dryruns, ``profile_step`` and each
     gate of phase 15, each run of phase 16 and each CLI run of phase 18,
     each counted from 0

Imports nothing of JAX and nothing of the JAX package.  Tolerance 1e-4
(phases 3-4) on outputs in [0, 1]: the kernels and PyTorch's CUDA ops
differ by a few ulp in log/exp/division (the special-function forms of
csrc/photometric_common.cuh, whose header states their error budget) and in
FMA contraction.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

TOL = 1e-4
# the strong views kernel against its plain version (PyTorch ops on the card)
VIEWS_TOL = 1e-5
ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("photometric_chain", "rsp_augment", "strong_views")
# (triplets, tile edge) of the main path (the config of record) and of the
# odd shape that exercises the kernels' ragged edges
MAIN, ODD = (64, 256), (2, 37)
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
IDENTITY = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Arithmetic per pixel, counted from the kernels' source: each float add,
# multiply, division, comparison, min/max, floor, fmod, sqrt, log, exp, sin
# and cos counts one, and so does each integer multiply, xor and add of
# Philox (a wide multiply counts two).  Gated stages count only on tiles
# whose gate is on.  The bound is the least work the function needs: the
# two-pass warp samples pass 1 once per intermediate pixel and pass 2 once
# per output pixel; the blur's two passes slide their box sums (add the
# entering value, subtract the leaving one, scale by 1/k: 6 per channel,
# whatever k is); halo recompute is not counted.
PIXEL_OPS = {
    "warp": 70,       # 2 folded positions with their taps' hat weights (26 each), 18 mul/add
    "blur": 18,       # 2 sliding passes, 3 channels
    "hsv": 45,        # rgb2hsv, the three shifts, hsv2rgb
    "philox": 126,    # 10 rounds (4 + 4 xor + 2 key adds), 4 uniforms, Box-Muller
    "noise": 12,      # x + n * sigma, clipped, 3 channels
    "hed": 60,        # 3 log, 2 3x3 products, the shift, 3 exp, (e - 1) / 2, clip
    "bc": 15,         # x * (1 + c) + b, clipped, 3 channels
    "normalize": 12,  # clip, (x - mean) / std, 3 channels
    "clip": 6,        # min and max, 3 channels
}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def kernel_counters() -> dict:
    """Each hand-written kernel's wrapper module, whose ``launches`` counts
    the kernel's launches, by the kernel's name in ``KERNELS``."""
    from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK
    from ssl_cr_histo_tpu_torch.ops import rsp_augment_kernel as RK
    from ssl_cr_histo_tpu_torch.ops import strong_views_kernel as SV

    return {"photometric_chain": PK, "rsp_augment": RK, "strong_views": SV}


def reset_launches() -> None:
    for module in kernel_counters().values():
        module.launches = 0


def launch_counts() -> dict:
    """Every kernel's launches since the last ``reset_launches``."""
    return {name: module.launches for name, module in kernel_counters().items()}


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_kernel_ms(fn, name: str, iters: int) -> float:
    """Device milliseconds per launch of the kernels whose name contains
    ``name``, from torch.profiler over ``iters`` calls of ``fn`` (after 2
    warm-up calls): the kernel alone, without the small PyTorch ops a
    wrapper runs around it.  The mean is over the launches the profiler
    recorded, which may miss a few of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in device_events(prof) if name in e.key]
    seen = sum(e.count for e in hits)
    check(2 * seen >= iters, f"profiler saw {seen} launches of {name} in {iters} calls")
    return sum(e.self_device_time_total for e in hits) / seen / 1e3


def device_events(prof) -> list:
    """The profile's kernels and copies on the card (not the host ops that
    launched them, whose device time would count them twice)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    """The least time the card could take: the larger of bytes over the HBM
    peak and operations over the float32 peak, and which one it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def chain_ops(params, pixels: int, philox: bool) -> float:
    """Operations of stages 1-5 over tiles of ``pixels`` pixels with these
    (N, 16) params."""
    p = params.double().cpu()
    on = lambda j: (p[:, j] > 0.5).double()
    noise = PIXEL_OPS["noise"] + (PIXEL_OPS["philox"] if philox else 0)
    per_pixel = (PIXEL_OPS["hsv"] * on(3) + noise * on(5) + PIXEL_OPS["hed"]
                 + PIXEL_OPS["blur"] * on(10) + PIXEL_OPS["bc"] * on(13))
    return float(per_pixel.sum()) * pixels


def fused_ops(params, pixels: int, philox: bool) -> float:
    """Operations of the fused kernel: the warp, the chain, the normalize."""
    extra = (PIXEL_OPS["warp"] + PIXEL_OPS["normalize"]) * params.shape[0] * pixels
    return chain_ops(params, pixels, philox) + extra


def views_ops(table, pixels: int) -> float:
    """Operations of the strong views kernel for this packed table
    (``strong_views_kernel.pack_table``) over images of ``pixels`` pixels:
    each image's active photometric stages (noise read, not drawn), its
    warp, and both views' clip."""
    from ssl_cr_histo_tpu_torch.ops import randaugment as RA
    from ssl_cr_histo_tpu_torch.ops import strong_views_kernel as SV

    kind = {"hsv": "hsv", "noise": "noise", "color": "hed", "blur": "blur", "brightness": "bc", "contrast": "bc"}
    b, n = table.shape[0], (table.shape[1] - SV.TABLE_HEAD) // SV.STAGE_WIDTH
    stages = table[:, SV.TABLE_HEAD:].view(b, n, SV.STAGE_WIDTH)
    per_image = PIXEL_OPS["warp"] + 2 * PIXEL_OPS["clip"]
    total = b * per_image + sum(PIXEL_OPS[kind[RA.V1_POOL[int(op)]]]
                                for op, on in stages[..., :2].reshape(-1, 2).tolist() if on > 0.5)
    return float(total) * pixels


def bf16_ulp(x):
    """The spacing of bf16 values (8 significant bits) at |x|."""
    import torch

    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def phase_kernel_vs_plain(PK, torch, dev) -> float:
    """Phase 3: the chain kernel.  Returns the largest error seen."""
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0

    def compare(label, shape, params, noise):
        nonlocal worst
        imgs = torch.rand(shape, generator=gen, device=dev)
        seeds = PK.draw_seeds(gen, shape[0])
        got = PK.photometric_chain_cuda(imgs, seeds, params, noise)
        torch.cuda.synchronize()
        want = PK.reference_chain(imgs, params, noise if noise is not None
                                  else PK.philox_normal(seeds, shape))
        err = (got - want).abs().max().item()
        check(math.isfinite(err) and err <= TOL, f"{label}: max abs err {err} > {TOL}")
        worst = max(worst, err)
        print(f"  {label} {tuple(shape)}: max abs err {err:.3e}", flush=True)

    main_shape, odd_shape = (3 * MAIN[0], 3, MAIN[1], MAIN[1]), (2 * ODD[0], 3, ODD[1], ODD[1])
    gates = [3, 5, 10, 13]
    for shape in (main_shape, odd_shape):
        print(f"  launch plan {shape}: (cluster, rows, shared bytes) {PK.chain_launch_plan(*shape[2:])}", flush=True)
        n = shape[0]
        drawn = PK.draw_params(gen, n)
        all_on = drawn.clone()
        all_on[:, gates] = 1.0
        all_off = drawn.clone()
        all_off[:, gates] = 0.0
        cases = [("drawn params", drawn), ("all gates on", all_on), ("all gates off", all_off)]
        for k in (3.0, 5.0, 7.0):
            blur = all_off.clone()
            blur[:, 10], blur[:, 9] = 1.0, k
            cases.append((f"blur k={int(k)} only", blur))
        for label, params in cases:
            noise = torch.randn(shape, generator=gen, device=dev)
            compare(f"noise-input, {label}", shape, params, noise)
        compare("philox, drawn params", shape, drawn, None)
        compare("philox, all gates on", shape, all_on, None)
        compare("philox, all gates off", shape, all_off, None)

    # shapes the launch covers unevenly, one tile a case (all gates off, all
    # on, each gate alone, the blur alone at k = 3, 5, 7), both noise modes:
    # heights not a multiple of a CTA's rows or of the cluster, rows not a
    # multiple of 4 pixels, tiles smaller than the blur's halo, and one tile
    # more than the card runs clusters at once (a last wave of one cluster)
    rows = [[], gates] + [[g] for g in gates] + [[10]] * 3
    wave = PK.max_active_clusters(MAIN[1], MAIN[1]) + 1
    print(f"  {wave - 1} clusters of {MAIN[1]}^2 tiles at once on this card", flush=True)
    for n, hw in ((len(rows), (50, 64)), (len(rows), (13, 20)), (len(rows), (3, 3)), (len(rows), (2, 5)),
                  (wave, (MAIN[1], MAIN[1]))):
        params = PK.draw_params(gen, n)
        for i, on in enumerate(rows[:n]):
            params[i, gates] = 0.0
            params[i, on] = 1.0
        for i, k in zip(range(len(rows) - 3, n), (3.0, 5.0, 7.0)):
            params[i, 9] = k
        shape = (n, 3, *hw)
        compare(f"noise-input, each case, plan {PK.chain_launch_plan(*hw)}", shape, params,
                torch.randn(shape, generator=gen, device=dev))
        compare("philox, each case", shape, params, None)

    # a shape the launch cannot take: ValueError naming it, no launch
    before = PK.launches
    try:
        PK.photometric_chain_cuda(torch.rand(1, 3, 16, 260, device=dev), torch.zeros(1, dtype=torch.int32,
                                  device=dev), torch.zeros(1, PK.N_PARAMS, device=dev))
        fail("the chain wrapper took (1, 3, 16, 260) tiles")
    except ValueError as e:
        check("(3, 16, 260)" in str(e) and PK.launches == before, f"the refusal does not name the shape: {e}")
    print("  (1, 3, 16, 260): refused, naming the shape", flush=True)

    # Philox mode: same seeds -> same bits; other seeds -> other output
    n = main_shape[0]
    imgs = torch.rand(main_shape, generator=gen, device=dev)
    params = PK.draw_params(gen, n)
    params[:, 5] = 1.0
    seeds = PK.draw_seeds(gen, n)
    a = PK.photometric_chain_cuda(imgs, seeds, params)
    b = PK.photometric_chain_cuda(imgs, seeds.clone(), params)
    c = PK.photometric_chain_cuda(imgs, seeds + 1, params)
    torch.cuda.synchronize()
    check(torch.equal(a, b), "philox mode is not deterministic for equal seeds")
    check(not torch.equal(a, c), "philox mode ignores the seeds")
    print("  philox: equal seeds bitwise equal, other seeds differ", flush=True)

    # noise law: only the noise gate on, constant 0.5 input, sigma 0.05.  The
    # HED stage (always on, zero shift here) maps x -> (x + 1) / 2, undone below.
    sigma = 0.05
    params = torch.zeros(n, PK.N_PARAMS, device=dev)
    params[:, 4], params[:, 5] = sigma, 1.0
    params[:, 9] = 3.0
    out = PK.photometric_chain_cuda(torch.full(main_shape, 0.5, device=dev), seeds, params)
    resid = (2.0 * out.double() - 1.0) - 0.5
    mean, std = resid.mean().item(), resid.std().item()
    check(abs(mean) <= 1e-3, f"noise residual mean {mean} not within 1e-3 of 0")
    check(abs(std - sigma) <= 0.02 * sigma, f"noise residual std {std} not within 2% of {sigma}")
    print(f"  philox noise law: residual mean {mean:.2e}, std {std:.5f} (sigma {sigma})", flush=True)
    return worst


def phase_fused_vs_plain(RK, PK, fused, torch, dev) -> float:
    """Phase 4: the fused kernel against rsp_augment_plain, with and without
    an ordering, and its in-kernel warp plan against warp_pass_coefficients.
    Returns the largest float32 error seen (outputs in [0, 1]: mean 0, std
    1)."""
    from ssl_cr_histo_tpu_torch.ops import geometry

    gen = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    gates = [3, 5, 10, 13]
    for b, s in (MAIN, ODD):
        n = 3 * b
        tiles = torch.randint(0, 256, (b, 3, s, s, 3), dtype=torch.uint8, generator=gen, device=dev)
        mats = fused.draw_pretrain_geo_matrices(gen, n, s)
        # the warp's transpose fix-up, alone and after its 90-degree one
        mats[-2] = torch.tensor([[1.4, 0.2, -3.0], [0.1, 0.7, 2.0], [0.0, 0.0, 1.0]], device=dev)
        mats[-1] = torch.tensor([[0.1, 0.6, 2.0], [1.4, 0.2, -1.0], [0.0, 0.0, 1.0]], device=dev)
        seeds = PK.draw_seeds(gen, n)
        noise = torch.randn((n, 3, s, s), generator=gen, device=dev)
        drawn = PK.draw_params(gen, n)
        all_on, all_off = drawn.clone(), drawn.clone()
        all_on[:, gates], all_off[:, gates] = 1.0, 0.0
        # an ordering per triplet that uses every one of the six
        order = torch.randperm(max(b, 6), generator=gen, device=dev)[:b].remainder(6).to(torch.int32)
        cases = [(p, nz, IDENTITY, None) for p in ("drawn params", "all gates on", "all gates off")
                 for nz in ("host noise", "philox")] + [("drawn params", "philox", IMAGENET, None)]
        cases += [("drawn params", nz, IDENTITY, order) for nz in ("host noise", "philox")]
        cases += [("all gates on", "philox", IMAGENET, order)]
        for plabel, nlabel, norm, o in cases:
            params = {"drawn params": drawn, "all gates on": all_on, "all gates off": all_off}[plabel]
            args = (tiles, mats, params, seeds, noise if nlabel == "host noise" else None, *norm)
            want = RK.rsp_augment_plain(*args, torch.float32, order=o)
            got = RK.rsp_augment_cuda(*args, torch.float32, order=o)
            got16 = RK.rsp_augment_cuda(*args, torch.bfloat16, order=o)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(got16).all()),
                  f"fused {plabel}, {nlabel}: non-finite output")
            tol = TOL / min(norm[1])
            err = (got - want).abs().max().item()
            label = (f"{plabel}, {nlabel}" + (", ImageNet mean/std" if norm is IMAGENET else "")
                     + (", ordered" if o is not None else ""))
            check(math.isfinite(err) and err <= tol, f"fused {label} {tuple(tiles.shape)}: f32 max abs err {err} > {tol}")
            want16 = want.to(torch.bfloat16)
            err16 = (got16.float() - want16.float()).abs()
            # 1 ulp, or the float32 bound where an ulp is smaller
            ratio = (err16 / torch.clamp_min(bf16_ulp(want16), tol)).max().item()
            check(ratio <= 1.0, f"fused {label} {tuple(tiles.shape)}: bf16 error {ratio} x its bound")
            if norm is IDENTITY:
                worst = max(worst, err)
            print(f"  fused {label} {tuple(tiles.shape)}: f32 max abs err {err:.3e}; bf16 max abs err "
                  f"{err16.max().item():.3e}, at most {ratio:.2f} of max(1 ulp, {tol:.1e}); bf16 equal to "
                  f"the plain cast {(err16 == 0).double().mean().item() * 100:.3f}%", flush=True)

        # the plan the kernel computed for each tile, against warp_pass_coefficients
        # on the card and on the CPU: equal values, and bitwise equal rows counted
        plan = torch.full((n, RK.PLAN_WIDTH), float("nan"), device=dev)
        RK.rsp_augment_cuda(tiles, mats, drawn, seeds, None, *IDENTITY, torch.bfloat16, order=order,
                            plan_out=plan)
        torch.cuda.synchronize()
        for where, want in (("card", geometry.warp_pass_coefficients(mats, s)),
                            ("CPU", geometry.warp_pass_coefficients(mats.cpu(), s).to(dev))):
            check(torch.equal(plan, want), f"in-kernel warp plan differs from warp_pass_coefficients on the "
                                           f"{where} at {s}^2: {(plan != want).sum().item()} entries")
            bitwise = (plan.view(torch.int32) == want.view(torch.int32)).all(1).sum().item()
            print(f"  in-kernel warp plan ({n} tiles at {s}^2, incl. both fix-ups: rot {int(plan[:, 6].sum())}, "
                  f"swap {int(plan[:, 7].sum())}) equals warp_pass_coefficients on the {where}; "
                  f"{bitwise}/{n} rows bitwise", flush=True)
    return worst


def phase_views_vs_plain(torch, dev, card: str) -> tuple:
    """Phase 4, the consistency views: the strong views kernel, through
    ``ops.batch.transform_fix_batch`` on the card, against its plain
    version on the card (``fused.transform_fix_fused`` with
    ``randaugment_v1_fused``, the PyTorch ops it replaced) on the same
    draws, at the CR cell's shape (112 unlabeled images of 256^2, NAug 7):
    fused, fast and masked as drawn, and fused with every gate on, each
    within ``VIEWS_TOL`` and one launch a call.  Then, under fused as
    drawn, the wrapper on a packed table and the whole call (its host
    packing included) against the plain version, in turns (CUDA events),
    and the kernel's bound from its bytes.  Returns (the largest error, the
    timing for the kernels line)."""
    from ssl_cr_histo_tpu_torch.ops import batch as TB
    from ssl_cr_histo_tpu_torch.ops import fused
    from ssl_cr_histo_tpu_torch.ops import randaugment as RA
    from ssl_cr_histo_tpu_torch.ops import strong_views_kernel as SV

    b, s, n = 112, 256, 7
    host = torch.Generator().manual_seed(4)
    gen = torch.Generator(device=dev).manual_seed(4)
    imgs = torch.randint(0, 256, (b, s, s, 3), dtype=torch.uint8, device=dev, generator=gen)

    def plain(d):
        x = TB.to_float(imgs.permute(0, 3, 1, 2).contiguous())
        return [torch.clamp(v, 0.0, 1.0) for v in fused.transform_fix_fused(x, d)]

    cases = [(mode, mode, TB.draw_transform_fix(gen, b, s, n, host_gen=host, mode=mode))
             for mode in ("fused", "fast", "masked")]
    on = dict(cases[0][2], params=cases[0][2]["params"].clone())
    on["params"][..., RA.GATE] = 1.0
    cases.append(("fused, every gate on", "fused", on))
    worst = 0.0
    for label, mode, d in cases:
        before = SV.launches
        got = TB.transform_fix_batch(None, imgs, n, mode=mode, draws=d)
        launched = SV.launches - before
        err = max((a - w).abs().max().item() for a, w in zip(got, plain(d)))
        active = int(SV.pack_table(d, s)[:, SV.TABLE_HEAD + 1::SV.STAGE_WIDTH].sum())
        print(f"phase 4: strong views ({b}, {s}, {s}, 3) {label}: {active} active stages, {d['noise'].shape[0]} "
              f"noise fields, {launched} launch; weak and strong against the plain version max abs err {err:.2e}",
              flush=True)
        check(launched == 1, f"strong views {label}: {launched} launches in one call")
        check(err <= VIEWS_TOL, f"strong views {label}: kernel vs plain differ by {err} > {VIEWS_TOL}")
        worst = max(worst, err)

    d = cases[0][2]
    table = SV.pack_table(d, s)
    fns = {"kernel": lambda: SV.strong_views_cuda(imgs, table, d["noise"]),
           "call": lambda: TB.transform_fix_batch(None, imgs, n, draws=d),
           "plain": lambda: plain(d)}
    t = in_turns(fns, ["plain", "kernel", "call", "kernel", "call", "plain"], {"plain": 5, "kernel": 50, "call": 50})
    ms = {k: min(v) for k, v in t.items()}
    bytes_ = imgs.numel() + d["noise"].numel() * 4 + 2 * b * 3 * s * s * 4 + table.numel() * 4
    b_ms, b_by = bound_ms(bytes_, views_ops(table, s * s))
    cluster, rows, smem = SV.launch_plan(s, s, n)
    runs = lambda k: ", ".join(f"{v * 1e3:.1f}" for v in t[k])
    print(f"phase 4: strong views kernel ({b}, {s}, {s}, 3) fused as drawn, NAug {n}: wrapper {ms['kernel'] * 1e3:.1f} "
          f"us (CUDA events, runs {runs('kernel')}), {b_ms / ms['kernel'] * 100:.1f}% of its bound; the whole call "
          f"with its host packing {ms['call'] * 1e3:.1f} us (runs {runs('call')}); plain version "
          f"{ms['plain'] * 1e3:.1f} us (runs {runs('plain')}) = {ms['plain'] / ms['kernel']:.1f}x; bound "
          f"{b_ms * 1e3:.1f} us by {b_by} ({bytes_ / 1e6:.1f} MB); a cluster of {cluster} CTAs of {rows} rows an "
          f"image, {smem} bytes of shared memory a CTA [{card}]", flush=True)
    return worst, {"ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": b_ms, "bound_by": b_by}


def phase_step_card_vs_cpu(torch) -> float:
    """One float32 pretrain step on a small input (batch 4, 64^2) with the
    same weights and injected draws, on the card (kernel path) and on the
    CPU (plain path).  Returns the largest state difference after the step."""
    from ssl_cr_histo_tpu_torch.ops import batch as TB
    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train.init import init_triplet_state

    g = torch.Generator().manual_seed(5)
    b, s = 4, 64
    tiles = torch.randint(0, 256, (b, 3, s, s, 3), dtype=torch.uint8, generator=g)
    labels = torch.randint(0, 6, (b,), generator=g)
    draws = TB.draw_rsp_v1(g, b * 3, s)
    draws["noise"] = torch.randn(b * 3, 3, s, s, generator=g)
    out = {}
    for d in ("cpu", "cuda"):
        torch.manual_seed(0)
        state = init_triplet_state("resnet18", torch.device(d))
        m = S.pretrain_step(state, tiles.to(d), torch.Generator(device=d).manual_seed(0),
                            labels.to(d), {k: v.to(d) for k, v in draws.items()})
        out[d] = (float(m["loss"]), {k: v.detach().cpu() for k, v in state.model.state_dict().items()
                                     if v.is_floating_point()})
    (loss_cpu, sd_cpu), (loss_gpu, sd_gpu) = out["cpu"], out["cuda"]
    check(abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu),
          f"step loss card {loss_gpu} vs CPU {loss_cpu}")
    err = max((sd_gpu[k] - sd_cpu[k]).abs().max().item() for k in sd_cpu)
    check(err <= 1e-4, f"post-step state card vs CPU differs by {err}")
    print(f"phase 5: float32 step, batch 4 at 64^2, card vs CPU: loss {loss_gpu:.6f} vs "
          f"{loss_cpu:.6f}, post-step weights and BN statistics max abs err {err:.2e}", flush=True)
    return err


def write_slides(root: str) -> str:
    """Two 4096^2 slides, numpy only: a noisy pink tissue block on a white
    background that covers half the slide, so that the v1 LAB foreground test
    (tissue against the slide's mean) passes over the block and fails off it.
    Seeded; about 800 triplet positions of 256^2 at stride 16 per slide."""
    import numpy as np

    rng = np.random.default_rng(0)
    d = os.path.join(root, "wsis")
    os.makedirs(d)
    for i in range(2):
        level0 = np.full((4096, 4096, 3), 245, np.uint8)
        tissue = np.array([190, 80, 160], np.int16) + rng.integers(-20, 20, (2816, 2816, 3),
                                                                   dtype=np.int16)
        level0[512:3328, 512:3328] = np.clip(tissue, 0, 255)
        np.save(os.path.join(d, f"slide{i}.npy"), level0)
    return d


def old_augment(gen, triplets_u8, mode="fused", draws=None, mean=IDENTITY[0], std=IDENTITY[1],
                out_dtype=None, order=None, host_gen=None, shard=None):
    """The unfused composition of the augmentation, kept here to time the step
    against: the uint8 triplet permutation (a gather), uint8 -> float32
    planar copy, the plain two-pass warp, the chain kernel, clip, normalize;
    float32 out (autocast casts it for conv1).  One process's whole batch
    only (``shard`` None or (0, B))."""
    import torch
    from ssl_cr_histo_tpu_torch.ops import batch as TB
    from ssl_cr_histo_tpu_torch.ops import fused
    from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK
    from ssl_cr_histo_tpu_torch.ops import rsp_augment_kernel as RK

    if shard not in (None, (0, len(triplets_u8))):
        raise ValueError(f"the unfused composition takes a whole batch, not the rows of {shard}")
    if order is not None:
        triplets_u8 = RK.permute_triplets(triplets_u8, order)
    b, t, h, w, _ = triplets_u8.shape
    imgs = TB.to_float(triplets_u8.reshape(b * t, h, w, 3).permute(0, 3, 1, 2)).contiguous()
    if draws is None:
        draws = TB.draw_rsp_v1(gen, b * t, h)
    warped = fused.pretrain_geo_warp_planar(imgs, draws["geo"])
    out = PK.pretrain_photometric(warped, gen, noise=draws["noise"], params=draws["params"])
    return TB.normalize_batch(torch.clamp(out, 0.0, 1.0).reshape(b, t, 3, h, w), mean, std, channel_axis=2)


def phase_finetune_step_card_vs_cpu(torch) -> None:
    """Phase 6: the 3-view augmentation and one float32 fine-tune step
    (Kather's head and Adam, batch 4 at 64^2, injected draws) on the card
    and on the CPU, from the same weights."""
    from ssl_cr_histo_tpu_torch.cli.common import TASKS, make_optimizer
    from ssl_cr_histo_tpu_torch.ops import batch as TB
    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train.init import init_finetune_state

    cfg = TASKS["kather"]
    g = torch.Generator().manual_seed(6)
    b, s = 4, 64
    imgs = torch.randint(0, 256, (b, s, s, 3), dtype=torch.uint8, generator=g)
    labels = torch.randint(0, cfg.num_classes, (b,), generator=g)
    draws = TB.draw_3view(g, b, s)
    # angles on both sides of +-45 degrees, where the warp's 90-degree fix-up flips
    draws["angles"] = torch.tensor([[44.9, -45.1], [45.1, -44.9], [-89.9, 89.9], [10.0, -60.0]])
    draws["rotate"][:] = True
    views = {d: TB.augment_3view_batch(None, imgs.to(d), draws).cpu() for d in ("cpu", "cuda")}
    verr = (views["cuda"] - views["cpu"]).abs().max().item()
    check(verr <= TOL, f"3-view augmentation card vs CPU differs by {verr}")
    out = {}
    for d in ("cpu", "cuda"):
        torch.manual_seed(0)
        state = init_finetune_state("resnet18", cfg.num_classes, torch.device(d),
                                    lambda ps: make_optimizer(cfg.optimizer, ps, cfg.lr))
        m = S.finetune_step(state, imgs.to(d), labels.to(d), None, cfg.task, draws)
        sd = {**state.model.state_dict(), **state.head.state_dict()}
        out[d] = (float(m["loss"]), {k: v.detach().cpu() for k, v in sd.items() if v.is_floating_point()})
    (loss_cpu, sd_cpu), (loss_gpu, sd_gpu) = out["cpu"], out["cuda"]
    check(abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu), f"fine-tune step loss card {loss_gpu} vs CPU {loss_cpu}")
    err = max((sd_gpu[k] - sd_cpu[k]).abs().max().item() for k in sd_cpu)
    check(err <= 1e-4, f"post-step fine-tune state card vs CPU differs by {err}")
    print(f"phase 6: 3-view augmentation (4, 64^2, angles across +-45), card vs CPU: max abs err {verr:.2e}; "
          f"float32 fine-tune step, card vs CPU: loss {loss_gpu:.6f} vs {loss_cpu:.6f}, post-step weights and "
          f"BN statistics max abs err {err:.2e}", flush=True)


def write_kather(root: str, n_per_class: int, size: int = 224) -> str:
    """Nine class folders (Kather's names) of seeded PNG patches: a class
    colour plus noise, with cv2 (which the slide sampler needs too)."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(1)
    d = os.path.join(root, "kather")
    for c, name in enumerate(("ADI", "BACK", "DEB", "LYM", "MUC", "MUS", "NORM", "STR", "TUM")):
        os.makedirs(os.path.join(d, name))
        base = np.array([40 + 24 * c, 200 - 18 * c, 120 + 10 * (c % 3)], np.int16)
        for i in range(n_per_class):
            img = np.clip(base + rng.integers(-40, 40, (size, size, 3), dtype=np.int16), 0, 255).astype(np.uint8)
            cv2.imwrite(os.path.join(d, name, f"p{i}.png"), img)
    return d


def phase_finetune(torch, dev, tmp: str, pretrain_ckpt: str, card: str, profile_dir: str) -> None:
    """Phase 6: the fine-tune slice.  The step on the card against the CPU;
    the CLI at Kather's config of record (resnet18, batch 64 at 224^2,
    bf16, Adam 1e-5) for one epoch of 4 steps from the pretrain checkpoint,
    with both kernels' launch counters at 0 before and read after; then the
    bf16 step and the 3-view augmentation alone timed with CUDA events."""
    import numpy as np

    from ssl_cr_histo_tpu_torch.cli import finetune
    from ssl_cr_histo_tpu_torch.cli.common import TASKS, make_optimizer
    from ssl_cr_histo_tpu_torch.data import datasets as D
    from ssl_cr_histo_tpu_torch.ops import batch as TB
    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train.init import init_finetune_state

    phase_finetune_step_card_vs_cpu(torch)
    # 9 x 36 patches: a 0.2 holdout of 64, and 4 steps of 64 over the other 260
    data = write_kather(tmp, 36)
    run = os.path.join(tmp, "finetune")
    argv = ["--task", "kather", "--train_path", data, "--model_path", pretrain_ckpt, "--save_dir", run,
            "--model", "resnet18", "--batch_size", "64", "--num_epoch", "1", "--save_freq", "1"]
    print("phase 6: fine-tune CLI " + " ".join(argv), flush=True)
    reset_launches()
    t0 = time.time()
    finetune.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
    print(f"phase 6: fine-tune CLI wall {wall:.2f} s, kernel launches {launches} (the 3-view stack is "
          f"PyTorch ops, as in the JAX package)", flush=True)
    check(not any(launches.values()), f"a kernel launched on the fine-tune path: {launches}")
    with open(os.path.join(run, "fine_tuned_results.csv")) as f:
        rows = [r.strip() for r in f.read().splitlines()[1:] if r.strip()]
    check(len(rows) == 1, f"expected one fine-tune CSV row, got {rows}")
    vals = [float(v) for v in rows[0].split(",")[1:]]
    check(all(math.isfinite(v) for v in vals) and 0.0 <= vals[1] <= 1.0, f"fine-tune CSV row {rows[0]}")
    print(f"phase 6: fine-tune CSV (epoch, train_loss, val_err) {rows[0]}", flush=True)
    for name in ("best.pth", "final.pth", "ckpt_1.pth"):
        ckpt = torch.load(os.path.join(run, name), map_location="cpu", weights_only=False)
        check("model.conv1.weight" in ckpt["model"] and "fc.2.weight" in ckpt["model"]
              and tuple(ckpt["classifier"]["classifier.0.weight"].shape) == (9, 768),
              f"fine-tune {name} lacks the reference keys")
        check(all(torch.isfinite(v).all() for v in ckpt["model"].values() if v.is_floating_point()),
              f"non-finite weights in fine-tune {name}")
    check(ckpt["step"] == 4 and ckpt["scheduler"]["last_epoch"] == 4, "the final checkpoint is not at step 4")

    # BreastPathQ's regression head through ``run`` on numpy data (its .h5
    # loader needs h5py, which this machine may lack): batch 4 at 256^2,
    # Adam 1e-4, MSE, one epoch of 4 steps
    rng = np.random.default_rng(2)
    bpq = D.ArrayDataset(rng.integers(0, 256, (20, 256, 256, 3), dtype=np.uint8), rng.random(20).astype(np.float32))
    args = finetune.parse_args(["--task", "breastpathq", "--save_dir", os.path.join(tmp, "bpq"), "--num_epoch", "1",
                                "--save_freq", "0", "--model_path", pretrain_ckpt])
    reset_launches()
    finetune.run(args, TASKS["breastpathq"], *D.train_val_split(bpq, args.validation_split, seed=args.seed))
    check(not any(launch_counts().values()), "a kernel launched on the BreastPathQ fine-tune path")
    with open(os.path.join(tmp, "bpq", "fine_tuned_results.csv")) as f:
        row = f.read().splitlines()[1]
    check(all(math.isfinite(float(v)) for v in row.split(",")), f"BreastPathQ CSV row {row}")
    ckpt = torch.load(os.path.join(tmp, "bpq", "final.pth"), map_location="cpu", weights_only=False)
    check(tuple(ckpt["classifier"]["classifier.0.weight"].shape) == (1, 768) and ckpt["step"] == 4,
          "BreastPathQ final checkpoint")
    print(f"phase 6: BreastPathQ fine-tune run (16 train / 4 val at 256^2, MSE), CSV (epoch, train_loss, val_mse) "
          f"{row}, kernel launches 0", flush=True)

    # the bf16 step at the config of record and the 3-view stack alone
    cfg = TASKS["kather"]
    torch.manual_seed(0)
    state = init_finetune_state("resnet18", cfg.num_classes, dev,
                                lambda ps: make_optimizer(cfg.optimizer, ps, cfg.lr))
    gen = torch.Generator(device=dev).manual_seed(0)
    imgs = torch.randint(0, 256, (cfg.batch_size, cfg.image_size, cfg.image_size, 3), dtype=torch.uint8,
                         generator=gen, device=dev)
    labels = torch.randint(0, cfg.num_classes, (cfg.batch_size,), generator=gen, device=dev)
    losses = []
    step = lambda: losses.append(S.finetune_step(state, imgs, labels, gen, cfg.task, bf16=True)["loss"])
    step_ms = [cuda_ms(step, 20, warmup=5) for _ in range(2)]
    check(all(math.isfinite(float(v)) for v in losses), "non-finite loss in the timed fine-tune steps")
    aug_ms = [cuda_ms(lambda: TB.augment_3view_batch(gen, imgs), 20) for _ in range(2)]
    mean_step, views = sum(step_ms) / 2, 3 * cfg.batch_size
    print(f"phase 6: fine-tune step resnet18 b{cfg.batch_size} ({views} views of {cfg.image_size}^2) bf16 Adam: "
          f"{step_ms[0]:.3f}, {step_ms[1]:.3f} ms (mean {mean_step:.3f}) = {views / mean_step * 1e3:.1f} views/s; "
          f"3-view augmentation alone {aug_ms[0]:.3f}, {aug_ms[1]:.3f} ms = "
          f"{min(aug_ms) / mean_step * 100:.1f}% of the step [{card}]", flush=True)
    if profile_dir:
        profile_steps(torch, step, profile_dir, "finetune_step_profile.txt", "fine-tune", card)
    del state


def coverage_fix_draws(torch, b: int, s: int) -> dict:
    """Consistency-view draws for ``b`` >= 16 images of ``s``^2 (seeded, on
    the host) in which all nine strong ops occur with their gates on, and
    the composed maps fall on both sides of +-45 degrees: image i < 9 runs op
    i at its first stage; images 9-12 rotate by 44.9, -45.1, 45.1, -44.9
    degrees (rotate_crop, no flip); images 13-15 compose a shift-scale-rotate
    of 30 degrees with a rotation of 20, -80 and 10 degrees.  The other
    stages keep their drawn ops."""
    from ssl_cr_histo_tpu_torch.ops import batch as TB
    from ssl_cr_histo_tpu_torch.ops import randaugment as RA

    g = torch.Generator().manual_seed(8)
    d = TB.draw_transform_fix(g, b, s)
    ops = d["ops"]
    rot, ssr = RA.V1_POOL.index("rotate_crop"), RA.V1_POOL.index("shift_scale_rotate")
    ops[:9, 0] = torch.arange(9)
    ops[9:16, :2] = torch.tensor([[rot, 4]] * 4 + [[ssr, rot]] * 3)
    p = RA.draw_v1_params(g, ops, d["mags"])
    p[:9, 0, RA.GATE] = 1.0
    for i, angle in enumerate((44.9, -45.1, 45.1, -44.9)):
        p[9 + i, 0, :3] = torch.tensor([angle, 0.0, 0.0])  # rotation, no flip
        p[9 + i, 0, RA.GATE] = 1.0
    for i, angle in enumerate((20.0, -80.0, 10.0)):
        p[13 + i, 0, :4] = torch.tensor([0.02, -0.03, 1.1, 30.0])
        p[13 + i, 1, :3] = torch.tensor([angle, 0.0, 0.0])
        p[13 + i, :2, RA.GATE] = 1.0
    d["params"] = p
    d["noise"] = torch.randn(int((ops == RA.NOISE).sum()), 3, s, s, generator=g)
    return d


def phase_consistency_card_vs_cpu(torch) -> None:
    """Phase 7: the consistency views (all nine ops, maps across +-45
    degrees, 16 images of 224^2) and one float32 consistency step (Kather's
    head and Adam, batch 2 + 2 * mu 7 at 64^2, injected views) on the card
    and on the CPU, from the same weights; the teacher must not move."""
    from ssl_cr_histo_tpu_torch.cli.common import TASKS, make_optimizer
    from ssl_cr_histo_tpu_torch.ops import batch as TB
    from ssl_cr_histo_tpu_torch.ops import fused, geometry
    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train.init import init_finetune_state, init_teacher

    g = torch.Generator().manual_seed(9)
    b, s = 16, 224
    imgs = torch.randint(0, 256, (b, s, s, 3), dtype=torch.uint8, generator=g)
    d = coverage_fix_draws(torch, b, s)
    flags = geometry.warp_pass_coefficients(fused.strong_pool_matrix(d["ops"], d["params"], s), s)[:, 6]
    check(bool((flags[9:16] > 0.5).any()) and bool((flags[9:16] < 0.5).any()),
          "the coverage draws do not take the warp's 90-degree fix-up on both sides")
    out = {}
    for dev in ("cpu", "cuda"):
        draws = dict(d, noise=d["noise"].to(dev))
        out[dev] = [v.cpu() for v in TB.transform_fix_batch(None, imgs.to(dev), draws=draws)]
    verr = max((a - c).abs().max().item() for a, c in zip(out["cuda"], out["cpu"]))
    check(verr <= 1e-5, f"consistency views card vs CPU differ by {verr}")

    cfg, mu, bl, s = TASKS["kather"], 7, 2, 64
    x_l = torch.randint(0, 256, (bl, s, s, 3), dtype=torch.uint8, generator=g)
    x_u = torch.randint(0, 256, (bl * mu, s, s, 3), dtype=torch.uint8, generator=g)
    y_l = torch.randint(0, cfg.num_classes, (bl,), generator=g)
    weak, strong = TB.transform_fix_batch(g, x_u)
    x_lv, _ = S.expand_labeled_batch(g, x_l, y_l)
    res = {}
    for dev in ("cpu", "cuda"):
        torch.manual_seed(0)
        state = init_finetune_state("resnet18", cfg.num_classes, torch.device(dev),
                                    lambda ps: make_optimizer(cfg.optimizer, ps, cfg.lr), modules=15)
        teacher = init_teacher(state)
        with torch.no_grad():  # a teacher that differs from the student
            for t in teacher.model.parameters():
                t.mul_(0.99)
        t_sd = {k: v.clone() for k, v in teacher.model.state_dict().items()}
        m = S.consistency_step(state, teacher, x_l.to(dev), y_l.to(dev), x_u.to(dev), None, cfg.task,
                               views=tuple(v.to(dev) for v in (x_lv, weak, strong)))
        check(all(torch.equal(v, t_sd[k]) for k, v in teacher.model.state_dict().items()),
              f"the teacher moved in the consistency step on {dev}")
        sd = {**state.model.state_dict(), **state.head.state_dict()}
        res[dev] = ({k: float(m[k]) for k in ("loss", "sup", "cons")},
                    {k: v.detach().cpu() for k, v in sd.items() if v.is_floating_point()})
    (l_cpu, sd_cpu), (l_gpu, sd_gpu) = res["cpu"], res["cuda"]
    for k in l_cpu:
        check(abs(l_gpu[k] - l_cpu[k]) <= 1e-4 * abs(l_cpu[k]), f"consistency step {k} card {l_gpu[k]} vs CPU {l_cpu[k]}")
    err = max((sd_gpu[k] - sd_cpu[k]).abs().max().item() for k in sd_cpu)
    check(err <= 1e-4, f"post-step consistency state card vs CPU differs by {err}")
    print(f"phase 7: consistency views ({b}, 224^2, all nine ops, maps across +-45 degrees), card vs CPU: max abs "
          f"err {verr:.2e}; float32 consistency step (2 + 14 images at 64^2), card vs CPU: loss {l_gpu['loss']:.6f} "
          f"vs {l_cpu['loss']:.6f} (sup {l_gpu['sup']:.6f} vs {l_cpu['sup']:.6f}, cons {l_gpu['cons']:.6f} vs "
          f"{l_cpu['cons']:.6f}), post-step weights and BN statistics max abs err {err:.2e}, teacher unchanged",
          flush=True)


def phase_consistency(torch, dev, tmp: str, card: str, profile_dir: str) -> dict:
    """Phase 7: the consistency slice from phase 6's fine-tune checkpoints
    (the stage 2 -> 3 handoff).  Card vs CPU; the CLI at Kather's CR config
    (resnet18, 8 labeled images and 56 unlabeled at 224^2, NAug 7, bf16,
    Adam 1e-5) for one epoch on phase 6's PNG class folders, and
    BreastPathQ through ``run`` on numpy data, each with every launch
    counter at 0 before and read after: the strong views kernel once a
    step, no other kernel; the bf16 step and the views alone timed.
    Returns both paths' launches."""
    import numpy as np

    from ssl_cr_histo_tpu_torch.cli import consistency
    from ssl_cr_histo_tpu_torch.cli.common import TASKS, make_optimizer
    from ssl_cr_histo_tpu_torch.data import datasets as D
    from ssl_cr_histo_tpu_torch.ops import batch as TB
    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train.init import init_finetune_state, init_teacher

    phase_consistency_card_vs_cpu(torch)
    # phase 6's 9 x 36 patches: a 0.2 holdout, 26 labeled (0.1) in 3 batches of 8, 4 unlabeled batches of 56
    run = os.path.join(tmp, "consistency")
    argv = ["--task", "kather", "--train_path", os.path.join(tmp, "kather"), "--finetune_ckpt",
            os.path.join(tmp, "finetune", "best.pth"), "--save_dir", run, "--model", "resnet18",
            "--batch_size", "8", "--mu", "7", "--NAug", "7", "--num_epoch", "1", "--save_freq", "1"]
    print("phase 7: consistency CLI " + " ".join(argv), flush=True)
    reset_launches()
    t0 = time.time()
    with recorded_steps(S, "consistency") as steps:
        consistency.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    check(len(steps) > 0, "the consistency CLI took no step")
    launches = check_launches("consistency CLI", views=len(steps))
    print(f"phase 7: consistency CLI wall {wall:.2f} s, {len(steps)} steps, kernel launches {launches} (the views: "
          f"one strong_views launch a step)", flush=True)
    with open(os.path.join(run, "consistency_results.csv")) as f:
        rows = [r.strip() for r in f.read().splitlines()[1:] if r.strip()]
    check(len(rows) == 1, f"expected one consistency CSV row, got {rows}")
    vals = [float(v) for v in rows[0].split(",")[1:]]
    check(all(math.isfinite(v) for v in vals) and 0.0 <= vals[3] <= 1.0, f"consistency CSV row {rows[0]}")
    print(f"phase 7: consistency CSV (epoch, train_loss, sup_loss, cons_loss, val_err) {rows[0]}", flush=True)
    for name in ("best.pth", "final.pth"):
        ckpt = torch.load(os.path.join(run, name), map_location="cpu", weights_only=False)
        check("model.conv1.weight" in ckpt["model"]
              and tuple(ckpt["classifier"]["classifier.0.weight"].shape) == (9, 768),
              f"consistency {name} lacks the reference keys")
        check(all(torch.isfinite(v).all() for v in ckpt["model"].values() if v.is_floating_point()),
              f"non-finite weights in consistency {name}")
    check(ckpt["step"] >= 3, f"the consistency epoch took {ckpt['step']} steps, fewer than 3")

    # BreastPathQ's regression variant through ``run`` on numpy data: batch 4, mu 7 at 256^2, from
    # phase 6's BreastPathQ checkpoint; 64 train (16 labeled) / 16 val, two steps
    rng = np.random.default_rng(3)
    bpq = D.ArrayDataset(rng.integers(0, 256, (80, 256, 256, 3), dtype=np.uint8), rng.random(80).astype(np.float32))
    args = consistency.parse_args(["--task", "breastpathq", "--train_path", "numpy", "--finetune_ckpt",
                                   os.path.join(tmp, "bpq", "final.pth"), "--save_dir", os.path.join(tmp, "bpq_cr"),
                                   "--num_epoch", "1", "--save_freq", "0", "--labeled_train", "0.25"])
    train, val = D.train_val_split(bpq, args.validation_split, seed=args.seed)
    labeled = D.labeled_fraction(train, args.labeled_train, seed=args.seed)
    reset_launches()
    with recorded_steps(S, "consistency") as bpq_steps:
        consistency.run(args, TASKS["breastpathq"], labeled, train, val)
    bpq_launches = check_launches("BreastPathQ consistency", views=len(bpq_steps))
    with open(os.path.join(tmp, "bpq_cr", "consistency_results.csv")) as f:
        row = f.read().splitlines()[1]
    check(all(math.isfinite(float(v)) for v in row.split(",")), f"BreastPathQ consistency CSV row {row}")
    ckpt = torch.load(os.path.join(tmp, "bpq_cr", "final.pth"), map_location="cpu", weights_only=False)
    check(tuple(ckpt["classifier"]["classifier.0.weight"].shape) == (1, 768) and ckpt["step"] == 2,
          "BreastPathQ consistency final checkpoint")
    print(f"phase 7: BreastPathQ consistency run (16 labeled / 64 unlabeled / 16 val at 256^2, batch 4, mu 7, "
          f"MSE), CSV (epoch, train_loss, sup_loss, cons_loss, val_mse) {row}, kernel launches {bpq_launches}",
          flush=True)

    # the bf16 step at Kather's CR config and the consistency views alone
    cfg, b, mu = TASKS["kather"], TASKS["kather"].cr_batch, 7
    torch.manual_seed(0)
    state = init_finetune_state("resnet18", cfg.num_classes, dev,
                                lambda ps: make_optimizer(cfg.optimizer, ps, cfg.lr), modules=60)
    teacher = init_teacher(state)
    gen = torch.Generator(device=dev).manual_seed(0)
    host_gen = torch.Generator().manual_seed(1)
    size = cfg.image_size
    x_l = torch.randint(0, 256, (b, size, size, 3), dtype=torch.uint8, generator=gen, device=dev)
    x_u = torch.randint(0, 256, (b * mu, size, size, 3), dtype=torch.uint8, generator=gen, device=dev)
    y_l = torch.randint(0, cfg.num_classes, (b,), generator=gen, device=dev)
    losses = []
    step = lambda: losses.append(S.consistency_step(state, teacher, x_l, y_l, x_u, gen, cfg.task, host_gen=host_gen,
                                                    bf16=True)["loss"])
    step_ms = [cuda_ms(step, 20, warmup=5) for _ in range(2)]
    check(all(math.isfinite(float(v)) for v in losses), "non-finite loss in the timed consistency steps")
    aug_ms = [cuda_ms(lambda: TB.transform_fix_batch(gen, x_u, host_gen=host_gen), 20) for _ in range(2)]
    mean_step, n_img = sum(step_ms) / 2, b + b * mu
    print(f"phase 7: consistency step resnet18 {b} labeled (x3 views) + {b * mu} unlabeled (weak + strong) at "
          f"{size}^2, bf16 Adam: {step_ms[0]:.3f}, {step_ms[1]:.3f} ms (mean {mean_step:.3f}) = "
          f"{n_img / mean_step * 1e3:.1f} images/s; weak/strong views of {b * mu} images alone {aug_ms[0]:.3f}, "
          f"{aug_ms[1]:.3f} ms = {min(aug_ms) / mean_step * 100:.1f}% of the step [{card}]", flush=True)
    if profile_dir:
        profile_steps(torch, step, profile_dir, "consistency_step_profile.txt", "consistency", card)
    del state, teacher
    return {"consistency_cli": launches, "consistency_breastpathq": bpq_launches}


def with_events(torch, fn, pairs: list):
    """``fn`` with a CUDA event pair recorded around each call into
    ``pairs``; their sum (``events_s``, after a synchronize) is the card's
    time inside the calls."""
    def wrapped(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **kw)
        end.record()
        pairs.append((start, end))
        return out
    return wrapped


def events_s(pairs: list) -> float:
    return sum(s.elapsed_time(e) for s, e in pairs) / 1e3


@contextlib.contextmanager
def cuda_timed(torch, module, name: str):
    """``module.<name>`` timed by ``with_events`` for the block; yields the
    event pairs."""
    pairs, real = [], getattr(module, name)
    setattr(module, name, with_events(torch, real, pairs))
    try:
        yield pairs
    finally:
        setattr(module, name, real)


def trunk_layouts(text: str, where: str) -> list:
    """The ``trunk forwards`` readings of the stage CLIs' epoch lines in
    ``text``: there must be some, and each must count channels-last
    forwards alone (the ResNet trunk's layout on the card,
    ``models/resnet.py``)."""
    found = re.findall(r"; trunk forwards ([^;\n]*)", text)
    check(bool(found) and all(re.fullmatch(r"channels_last \d+", f) for f in found),
          f"{where}: the trunk's forwards on the card by layout: {found}")
    return found


class Tee:
    """A stdout that also keeps what is written (to read a CLI's prints)."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def phase_pretrain_feeds(torch, pretrain, S, argv: list, tmp: str, steps: int, card: str) -> None:
    """Phase 5's feed side by side, at ``--multi_step 1`` (one eager step a
    batch): the pretrain CLI run with its batches fed through the prefetch
    thread (``data.pipeline.prefetch_to_device``, which ``cli.common.
    chunked_feed`` runs a batch a chunk) and with the inline feed it had
    before (each batch pinned and copied on the loop's thread, then
    stepped), in the order inline, prefetch, prefetch, inline, all after
    phase 5's run has warmed the card.  Prints each run's epoch wall (the
    CLI's own print) and the stream time between the CUDA events around
    each of its steps."""
    import numpy as np

    from ssl_cr_histo_tpu_torch.cli import common

    real = common.prefetch_to_device

    def inline(it, device, size=2, counters=None, slot=0):
        for batch in it:
            yield tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(device, non_blocking=True)
                        for a in batch)

    walls = {"inline": [], "prefetch": []}
    for i, name in enumerate(("inline", "prefetch", "prefetch", "inline")):
        common.prefetch_to_device = inline if name == "inline" else real
        tee = Tee(io.StringIO())
        try:
            with cuda_timed(torch, S.StepGraph, "step") as pairs, contextlib.redirect_stdout(tee):
                pretrain.main(argv + ["--save_dir", os.path.join(tmp, f"feed_{i}_{name}"), "--multi_step", "1"])
            torch.cuda.synchronize()
        finally:
            common.prefetch_to_device = real
        epoch = re.search(r"Epoch time: ([0-9.]+) s", tee.buf.getvalue())
        check(epoch is not None and len(pairs) == steps, f"feed {name}: no epoch time or {len(pairs)} steps")
        walls[name].append(float(epoch.group(1)))
        print(f"phase 5: feed {name} (run {i + 1} of 4): epoch wall {float(epoch.group(1)):.2f} s against "
              f"{events_s(pairs):.4f} s of stream time between the events around its {steps} steps [{card}]",
              flush=True)
    print(f"phase 5: epoch wall, inline feed {walls['inline']} s, prefetch feed {walls['prefetch']} s [{card}]",
          flush=True)


def write_camelyon(root: str, patch: int, n_per_pool: int, n_valid: int, slide: int, resolution: int) -> dict:
    """Phase 9's Camelyon16 data, numpy and cv2 only, seeded:
      * train patch dirs 'tumor' (slide Tumor_026, centres in its positive
        polygon) and 'normal' (Normal_040), and VALID dirs (Tumor_030,
        Normal_050), each a list.txt of 'pid,x,y' and line-indexed
        '{idx}.png' files of ``patch``^2: tumor patches dense purple, normal
        ones pale pink, with noise; the annotation JSONs of the four slides;
      * slides 'tumor_001' and 'normal_001' as ``slide``^2 uint8 .npy: white,
        tissue over the left half (pink; the tumor slide with a purple block
        in it), and their tissue masks at ``resolution`` ((slide / res)^2
        cells, mask[x, y] as the serving path indexes it; half of them
        tissue); the ground-truth mask of the tumor slide's block.
    This is smaller than a real Camelyon16 slide (tens of thousands of
    tissue cells at resolution 64 or more)."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(9)
    d = {k: os.path.join(root, k) for k in ("tumor", "normal", "tumor_valid", "normal_valid", "json", "wsi",
                                            "mask", "gt")}
    for p in d.values():
        os.makedirs(p)
    colours = {"Tumor": (120, 50, 150), "Normal": (225, 170, 200)}
    for key, pid, n in (("tumor", "Tumor_026", n_per_pool), ("normal", "Normal_040", n_per_pool),
                        ("tumor_valid", "Tumor_030", n_valid), ("normal_valid", "Normal_050", n_valid)):
        base = np.array(colours[pid.split("_")[0]], np.int16)
        with open(os.path.join(d[key], "list.txt"), "w") as f:
            for i in range(n):
                x, y = (int(v) for v in rng.integers(1000, 9000, 2))
                f.write(f"{pid},{x},{y}\n")
                img = np.clip(base + rng.integers(-30, 30, (patch, patch, 3), dtype=np.int16), 0, 255)
                cv2.imwrite(os.path.join(d[key], f"{i}.png"), img.astype(np.uint8)[..., ::-1])
    square = [[0, 0], [10000, 0], [10000, 10000], [0, 10000]]
    for pid in ("Tumor_026", "Tumor_030", "Normal_040", "Normal_050"):
        doc = {"positive": [{"name": "t", "vertices": square}] if pid.startswith("Tumor") else [], "negative": []}
        with open(os.path.join(d["json"], f"{pid}.json"), "w") as f:
            json.dump(doc, f)

    cells = slide // resolution
    block = np.clip(rng.integers(-25, 25, (1024, 1024, 3), dtype=np.int16), -25, 25)
    for name in ("tumor_001", "normal_001"):
        level0 = np.full((slide, slide, 3), 245, np.uint8)
        half = slide // 2
        tissue = np.tile(block, (slide // 1024 + 1, half // 1024 + 1, 1))[:slide, :half]
        level0[:, :half] = np.clip(tissue + np.array(colours["Normal"], np.int16), 0, 255)
        mask = np.zeros((cells, cells), np.uint8)
        mask[: cells // 2] = 1  # mask[x, y]: x < half is tissue
        if name == "tumor_001":
            x0, x1, y0, y1 = cells // 8, cells * 5 // 16, cells * 5 // 16, cells * 5 // 8
            gt = np.zeros_like(mask)
            gt[x0:x1, y0:y1] = 1
            level0[y0 * resolution: y1 * resolution, x0 * resolution: x1 * resolution] = np.clip(
                tissue[: (y1 - y0) * resolution, : (x1 - x0) * resolution] + np.array(colours["Tumor"], np.int16),
                0, 255)
            np.save(os.path.join(d["gt"], f"{name}.npy"), gt)
        np.save(os.path.join(d["wsi"], f"{name}.npy"), level0)
        np.save(os.path.join(d["mask"], f"{name}_tissue.npy"), mask)
    return d


def check_launches(label: str, views: int = 0) -> dict:
    """The launches since the last ``reset_launches``: neither pretraining
    kernel, and the strong views kernel ``views`` times (once a consistency
    training step under a composed ``--aug_mode``)."""
    launches = launch_counts()
    want = {"photometric_chain": 0, "rsp_augment": 0, "strong_views": views}
    check(launches == want, f"the {label} path launched {launches}, want {want}")
    return launches


def phase_camelyon(torch, dev, tmp: str, pretrain_ckpt: str, card: str, profile_dir: str, patch: int = 256,
                   slide: int = 8192, resolution: int = 64) -> dict:
    """Phase 9: Camelyon16 from the pretrain checkpoint to a scored heatmap.
    The fine-tune CLI (--task camelyon16, 16 images a pool, 256^2, bf16,
    SGD-Nesterov 5e-4) for one epoch of 4 steps, then the consistency CLI
    (8 labeled + 56 unlabeled images a pool) for one step from its
    best.pth, then the heatmap CLI (batch 256, 256^2, bf16) over two
    ``slide``^2 slides from the consistency best.pth, each with every
    launch counter at 0 before and read after (the strong views kernel once
    in the consistency step, no other launch); one map card vs CPU in float32 on a 2048^2 crop; the FROC CLI on
    the maps; then the steps, the serving forward and each map's wall
    time (against the sum of its forwards) timed with CUDA events.  The
    sizes are parameters so that a CPU rehearsal can shrink them; the card
    runs the defaults.  Returns the data's paths (``write_camelyon``)."""
    import numpy as np
    import scipy

    from ssl_cr_histo_tpu_torch.cli import consistency, finetune
    from ssl_cr_histo_tpu_torch.cli import froc as froc_cli
    from ssl_cr_histo_tpu_torch.cli import heatmap as heatmap_cli
    from ssl_cr_histo_tpu_torch.cli.common import TASKS, make_optimizer
    from ssl_cr_histo_tpu_torch.data.wsi import ArrayPyramid, open_slide
    from ssl_cr_histo_tpu_torch.eval import heatmap as H
    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train.init import init_finetune_state, init_serving_state, init_teacher

    cfg = TASKS["camelyon16"]
    cpu = dev.type == "cpu"
    common = ["--model", "resnet18", "--device", dev.type] + (["--image_size", str(patch)] if cpu else [])
    t0 = time.time()
    d = write_camelyon(tmp, patch, 64, 16, slide, resolution)
    print(f"phase 9: wrote 2 x 64 train and 2 x 16 VALID Camelyon16 patches of {patch}^2, two {slide}^2 slides "
          f"with masks at resolution {resolution} in {time.time() - t0:.1f} s (scipy {scipy.__version__})",
          flush=True)
    sync = (lambda: None) if cpu else torch.cuda.synchronize

    # fine-tune, 16 images a pool a step: 4 steps over 2 x 64 patches
    run = os.path.join(tmp, "c16_finetune")
    argv = ["--task", "camelyon16", "--train_path", f"{d['tumor']},{d['normal']}", "--json_path", d["json"],
            "--val_path", f"{d['tumor_valid']},{d['normal_valid']}", "--model_path", pretrain_ckpt,
            "--save_dir", run, "--num_epoch", "1", "--save_freq", "1"] + common
    print("phase 9: fine-tune CLI " + " ".join(argv), flush=True)
    reset_launches()
    t0 = time.time()
    finetune.main(argv)
    sync()
    wall = time.time() - t0
    launches = check_launches("Camelyon16 fine-tune")
    with open(os.path.join(run, "fine_tuned_results.csv")) as f:
        row = f.read().splitlines()[1]
    vals = [float(v) for v in row.split(",")]
    check(all(math.isfinite(v) for v in vals) and 0.0 <= vals[2] <= 1.0, f"Camelyon16 fine-tune CSV row {row}")
    ckpt = torch.load(os.path.join(run, "final.pth"), map_location="cpu", weights_only=False)
    check(tuple(ckpt["classifier"]["classifier.0.weight"].shape) == (2, 768) and ckpt["step"] == 4,
          f"Camelyon16 fine-tune checkpoint: step {ckpt['step']}")
    print(f"phase 9: Camelyon16 fine-tune CLI wall {wall:.2f} s (4 steps of 16 + 16 images, validation of 32), "
          f"CSV (epoch, train_loss, val_err) {row}, kernel launches {launches}", flush=True)

    # consistency from its best.pth: 8 labeled (0.125 of 64) and 56 unlabeled a pool, one step
    cr = os.path.join(tmp, "c16_consistency")
    argv = ["--task", "camelyon16", "--train_path", f"{d['tumor']},{d['normal']}", "--json_path", d["json"],
            "--val_path", f"{d['tumor_valid']},{d['normal_valid']}", "--finetune_ckpt",
            os.path.join(run, "best.pth"), "--save_dir", cr, "--labeled_train", "0.125", "--num_epoch", "1",
            "--save_freq", "1"] + common
    print("phase 9: consistency CLI " + " ".join(argv), flush=True)
    reset_launches()
    t0 = time.time()
    consistency.main(argv)
    sync()
    wall = time.time() - t0
    launches = check_launches("Camelyon16 consistency", views=0 if cpu else 1)
    with open(os.path.join(cr, "consistency_results.csv")) as f:
        row = f.read().splitlines()[1]
    check(all(math.isfinite(float(v)) for v in row.split(",")), f"Camelyon16 consistency CSV row {row}")
    ckpt = torch.load(os.path.join(cr, "final.pth"), map_location="cpu", weights_only=False)
    check(ckpt["step"] == 1 and tuple(ckpt["classifier"]["classifier.0.weight"].shape) == (2, 768),
          f"Camelyon16 consistency checkpoint: step {ckpt['step']}")
    print(f"phase 9: Camelyon16 consistency CLI wall {wall:.2f} s (1 step of 8 + 8 labeled and 56 + 56 unlabeled "
          f"images), CSV (epoch, train_loss, sup_loss, cons_loss, val_err) {row}, kernel launches {launches}",
          flush=True)

    # serving: the heatmap CLI over both slides from the consistency checkpoint
    maps_dir, best = os.path.join(tmp, "c16_maps"), os.path.join(cr, "best.pth")
    report = os.path.join(tmp, "froc.json")
    argv = ["--test_image_pth", d["wsi"], "--test_mask_pth", d["mask"], "--probs_map_path", maps_dir,
            "--finetune_ckpt", best, "--batch_size", "256"] + common
    print("phase 9: heatmap CLI " + " ".join(argv), flush=True)
    reset_launches()
    t0 = time.time()
    maps = heatmap_cli.main(argv)
    sync()
    wall = time.time() - t0
    launches = check_launches("serving")
    cells = slide // resolution
    for name, pm in sorted(maps.items()):
        mask = np.load(os.path.join(d["mask"], f"{name}_tissue.npy"))
        check(pm.shape == (cells, cells) and pm.dtype == np.float32, f"map {name}: {pm.shape} {pm.dtype}")
        check(bool(np.all((pm >= 0) & (pm <= 1))), f"map {name} leaves [0, 1]")
        check(not pm[mask == 0].any() and bool((pm[mask > 0] > 0).all()), f"map {name} is not 0 exactly off the mask")
        files = sorted(f for f in os.listdir(maps_dir) if f.startswith(name + ".") or f.startswith(name + "_"))
        check({f"{name}.npy", f"{name}.png", f"{name}_heatmap.png"} <= set(files), f"artifacts of {name}: {files}")
        print(f"phase 9: map {name} {pm.shape}, {int(mask.sum())} tissue cells, in [{pm[mask > 0].min():.4f}, "
              f"{pm[mask > 0].max():.4f}], 0 off the mask; artifacts {files}", flush=True)
    check(sorted(maps) == ["normal_001", "tumor_001"], f"maps written: {sorted(maps)}")
    print(f"phase 9: heatmap CLI wall {wall:.2f} s for two slides, kernel launches {launches}", flush=True)

    # the FROC on both maps
    froc_cli.main(["--probs_map_path", maps_dir, "--gt_path", d["gt"], "--out", report])
    with open(report) as f:
        rep = json.load(f)
    check(rep["n_slides"] == 2 and rep["total_lesions"] == 1 and math.isfinite(rep["froc"]), f"FROC report {rep}")
    rep.pop("curve")
    print("phase 9: FROC report " + json.dumps(rep), flush=True)

    if cpu:  # a rehearsal on the CPU stops here: the rest compares with the card and times it
        return d
    # one map card vs CPU in float32, on a crop of the tumor slide (half of it tissue)
    crop, iters = 2048, 20
    level0 = np.load(os.path.join(d["wsi"], "tumor_001.npy"))
    x0, y0 = slide // 2 - crop // 2, slide // 4
    c = crop // resolution
    sub = ArrayPyramid(np.ascontiguousarray(level0[y0: y0 + crop, x0: x0 + crop]), levels=1)
    sub_mask = np.load(os.path.join(d["mask"], "tumor_001_tissue.npy"))[x0 // resolution: x0 // resolution + c,
                                                                         y0 // resolution: y0 // resolution + c]
    crops = {}
    for where in ("cuda", "cpu"):
        state = init_serving_state("resnet18", 2, torch.device(where), best)
        crops[where] = H.compute_probs_map(sub, sub_mask, lambda x, s=state: S.forward(s, x), torch.device(where),
                                           image_size=patch, batch_size=256)
    err = float(np.abs(crops["cuda"] - crops["cpu"]).max())
    print(f"phase 9: map of a {crop}^2 crop ({int(sub_mask.sum())} patches), float32, card vs CPU: max abs "
          f"diff {err:.3e}", flush=True)
    check(err <= 1e-4, f"the crop's map, card vs CPU, differs by {err}")

    # timing: the Camelyon16 fine-tune and consistency steps, the serving
    # forward alone, and each map's wall against the sum of its forwards
    gen = torch.Generator(device=dev).manual_seed(0)
    host_gen = torch.Generator().manual_seed(1)
    torch.manual_seed(0)
    state = init_finetune_state("resnet18", 2, dev, lambda ps: make_optimizer(cfg.optimizer, ps, cfg.lr))
    rows, b = cfg.rows_per_step(cfg.batch_size), cfg.cr_batch
    imgs = torch.randint(0, 256, (rows, patch, patch, 3), dtype=torch.uint8, generator=gen, device=dev)
    labels = torch.randint(0, 2, (rows,), generator=gen, device=dev)
    losses = []
    step = lambda: losses.append(S.finetune_step(state, imgs, labels, gen, cfg.task, bf16=True)["loss"])
    ft_ms = [cuda_ms(step, iters, 5) for _ in range(2)]
    del state
    torch.manual_seed(0)
    state = init_finetune_state("resnet18", 2, dev, lambda ps: make_optimizer(cfg.optimizer, ps, cfg.lr), modules=60)
    teacher = init_teacher(state)
    x_l = torch.randint(0, 256, (2 * b, patch, patch, 3), dtype=torch.uint8, generator=gen, device=dev)
    y_l = torch.randint(0, 2, (2 * b,), generator=gen, device=dev)
    x_u = torch.randint(0, 256, (2 * b * 7, patch, patch, 3), dtype=torch.uint8, generator=gen, device=dev)
    cr_step = lambda: losses.append(S.consistency_step(state, teacher, x_l, y_l, x_u, gen, cfg.task,
                                                       host_gen=host_gen, bf16=True)["loss"])
    cr_ms = [cuda_ms(cr_step, iters // 2, 3) for _ in range(2)]
    check(all(math.isfinite(float(v)) for v in losses), "non-finite loss in the timed Camelyon16 steps")
    print(f"phase 9: Camelyon16 fine-tune step resnet18 {rows} images ({3 * rows} views) of {patch}^2, bf16 "
          f"SGD-Nesterov: {ft_ms[0]:.3f}, {ft_ms[1]:.3f} ms (mean {sum(ft_ms) / 2:.3f}) = "
          f"{3 * rows / (sum(ft_ms) / 2) * 1e3:.1f} views/s; consistency step {2 * b} labeled (x3 views) + "
          f"{14 * b} unlabeled (weak + strong) at {patch}^2, --modules_student 60, bf16: {cr_ms[0]:.3f}, "
          f"{cr_ms[1]:.3f} ms (mean {sum(cr_ms) / 2:.3f}) = {16 * b / (sum(cr_ms) / 2) * 1e3:.1f} images/s [{card}]",
          flush=True)
    del state, teacher

    serve = init_serving_state("resnet18", 2, dev, best)
    patches = torch.randint(0, 256, (256, patch, patch, 3), dtype=torch.uint8, generator=gen, device=dev)
    fwd_ms = [cuda_ms(lambda: S.forward(serve, patches, bf16=True), iters, 3) for _ in range(2)]
    fwd = sum(fwd_ms) / 2
    print(f"phase 9: serving forward resnet18 eval, batch 256 of {patch}^2 uint8, bf16: {fwd_ms[0]:.3f}, "
          f"{fwd_ms[1]:.3f} ms (mean {fwd:.3f}) = {256 / fwd * 1e3:.1f} patches/s [{card}]", flush=True)
    forward = lambda x: S.forward(serve, x, bf16=True)  # noqa: E731
    for name in ("tumor_001", "normal_001"):
        reader, mask = open_slide(os.path.join(d["wsi"], f"{name}.npy")), np.load(
            os.path.join(d["mask"], f"{name}_tissue.npy"))
        n = int(mask.sum())
        H.compute_probs_map(reader, mask, forward, dev, image_size=patch, batch_size=256)  # warm
        pairs = []
        torch.cuda.synchronize()
        t0 = time.time()
        H.compute_probs_map(reader, mask, with_events(torch, forward, pairs), dev, image_size=patch, batch_size=256)
        torch.cuda.synchronize()
        map_s = time.time() - t0
        # the patch reads alone: the same batches into pinned memory, no forward
        x_idcs, y_idcs, res = H.mask_work_list(reader, mask)
        t0 = time.time()
        for _ in H.iter_patch_batches(reader, x_idcs, y_idcs, res, patch, 256, pin=True):
            pass
        read_s = time.time() - t0
        print(f"phase 9: map {name}: {n} patches in {map_s:.3f} s wall = {n / map_s:.1f} patches/s; the sum of its "
              f"{len(pairs)} forwards at the forward's own rate {len(pairs) * fwd / 1e3:.3f} s; between each "
              f"forward's events in the loop {events_s(pairs):.3f} s (the card also waits there for the host's "
              f"launches); the patch reads alone {read_s:.3f} s = {n / read_s:.1f} patches/s (8 threads, pinned); "
              f"slide {slide}^2, smaller than a real Camelyon16 slide [{card}]", flush=True)
        if profile_dir and name == "tumor_001":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.time()
                H.compute_probs_map(reader, mask, forward, dev, image_size=patch, batch_size=256)
                torch.cuda.synchronize()
                wall_ms = (time.time() - t0) * 1e3
            device_ms = sum(e.self_device_time_total for e in device_events(prof)) / 1e3
            table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=30)
            os.makedirs(profile_dir, exist_ok=True)
            with open(os.path.join(profile_dir, "heatmap_profile.txt"), "w") as f:
                f.write(f"{card}\nmap {name} ({n} patches): device {device_ms:.3f} ms, wall {wall_ms:.3f} ms "
                        f"(profiled)\n{table}\n")
            print(f"profile: map {name}, device time {device_ms:.3f} ms against {wall_ms:.3f} ms of wall "
                  f"({device_ms / wall_ms * 100:.1f}% busy, profiled); table in {profile_dir}/heatmap_profile.txt "
                  f"[{card}]", flush=True)
    return d


@contextlib.contextmanager
def plot_recorders(RP, label: str):
    """Where matplotlib (or, for the t-SNE plot, scikit-learn) is missing,
    the reporting module's plot writers are swapped for recorders for the
    block, and the plots not drawn are printed; the arrays they were given
    are kept (``calls``).  Nothing else is swapped."""
    import importlib.util

    have = {m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "sklearn")}
    needs = {"save_confusion_matrix_plot": ("matplotlib",), "save_scatter_plot": ("matplotlib",),
             "save_bland_altman_plot": ("matplotlib",), "save_tsne_plot": ("matplotlib", "sklearn")}
    calls, real = [], {}
    for name, mods in needs.items():
        if not all(have[m] for m in mods):
            real[name] = getattr(RP, name)
            setattr(RP, name, lambda *a, _name=name, **kw: calls.append((_name, a, kw)))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(RP, name, fn)
        if calls:
            missing = [m for m, ok in have.items() if not ok]
            print(f"{label}: not drawn (no {' or '.join(missing)} on this machine): "
                  f"{', '.join(sorted({os.path.basename(str(a[-1])) for _, a, _ in calls}))}", flush=True)


def phase_remaining_modes(torch, dev, tmp: str, slides: str, card: str, profile_dir: str) -> dict:
    """Phase 10: the stage CLIs' remaining modes, on the checkpoints and data
    of phases 5-9.  Returns each path's launches of each kernel, every count
    set to 0 just before its path and read just after.

    1. pretrain --resume: 2 epochs of 2 steps straight, against 1 epoch and
       then --resume auto for the second, cuDNN deterministic; ckpt_2.pth
       bit-equal (weights, optimizer, slow weights, la_count, step,
       generator, best value);
    2. pretrain --expand_orderings --cache_tiles --tsne, 2 full epochs: the
       fused kernel launches once a step (6x the steps of a plain epoch),
       the reader once a position, the features' shapes and finiteness;
    3-5. --mode evaluation of the fine-tune CLI (Kather, from phase 6's
       best.pth, on a seeded test folder), BreastPathQ through the report
       function on numpy data (two raters), Camelyon16 from phase 9's
       best.pth: the report's keys; for Kather the card's float32 logits
       against the CPU's on 64 of the images, and predict_all's images/s,
       warm, over a set the size of Kather's test set (7180), beside its
       feed alone and its forward alone (``--profile``: one call traced);
    6. the consistency CLI's --mode evaluation, and --resume auto --ema for
       a second epoch with the teacher restored bit-equal.
    No kernel may launch on an evaluation path; the strong views kernel
    launches once a consistency training step."""
    import warnings

    import numpy as np

    from ssl_cr_histo_tpu_torch.cli import consistency, finetune, pretrain
    from ssl_cr_histo_tpu_torch.cli.common import TASKS
    from ssl_cr_histo_tpu_torch.data import RSPTripletSampler
    from ssl_cr_histo_tpu_torch.data import datasets as D
    from ssl_cr_histo_tpu_torch.eval import reporting as RP
    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train.init import init_serving_state

    tile, stride, expand_stride, batch, image, patch = 256, 16, 80, 64, 224, 256
    sync = torch.cuda.synchronize
    common = ["--device", dev.type, "--model", "resnet18"]
    load = lambda p: torch.load(p, map_location="cpu", weights_only=False)
    launches = {}

    def read_launches(path: str) -> dict:
        launches[path] = launch_counts()
        return launches[path]

    # 1. pretrain --resume, bit for bit
    base = ["--train_image_pth", slides, "--batch_size", str(batch), "--tile_h", str(tile), "--tile_w", str(tile),
            "--tile_stride", str(stride), "--steps_per_epoch", "2", "--validation_size", str(batch), "--save_freq", "1",
            "--index_cache_dir", os.path.join(tmp, "rsp_index")] + common
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    walls = {}
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for name, extra in (("straight", ["--num_epoch", "2"]), ("first", ["--num_epoch", "1"]),
                                ("resumed", ["--num_epoch", "2", "--resume", "auto"])):
                run = os.path.join(tmp, "resume", "resumed" if name != "straight" else "straight")
                reset_launches()
                t0 = time.time()
                with contextlib.redirect_stdout(io.StringIO()):
                    pretrain.main(base + ["--save_dir", run] + extra)
                sync()
                walls[name] = time.time() - t0
                steps = 4 if name == "straight" else 2
                n = read_launches(f"pretrain_resume_{name}")
                check(n["rsp_augment"] == steps and n["photometric_chain"] == 0,
                      f"pretrain {name} run: fused kernel launched {n['rsp_augment']} times in {steps} steps, "
                      f"chain kernel {n['photometric_chain']}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
        torch.use_deterministic_algorithms(False)
    a, b = (load(os.path.join(tmp, "resume", d, "ckpt_2.pth")) for d in ("straight", "resumed"))
    for k in ("step", "la_count"):
        check(a[k] == b[k], f"resumed pretrain run: {k} {b[k]} against {a[k]}")
    check(a["meta"]["best_val"] == b["meta"]["best_val"], "resumed pretrain run: best value differs")
    check(torch.equal(a["generators"]["gen"], b["generators"]["gen"]), "resumed pretrain run: generator state")
    tensors = lambda c: ([(f"{part}.{k}", v) for part in ("model", "classifier") for k, v in c[part].items()]
                         + [(f"slow.{i}", v) for i, v in enumerate(c["slow"])]
                         + [(f"momentum.{i}", s["momentum_buffer"]) for i, s in c["optimizer"]["state"].items()])
    diffs = [(k, (x.double() - y.double()).abs().max().item()) for (k, x), (_, y) in zip(tensors(a), tensors(b))]
    worst = max(diffs, key=lambda kv: kv[1])
    ops = sorted({str(w.message).split(" does not have a deterministic")[0] for w in caught
                  if "deterministic" in str(w.message)})
    check(worst[1] == 0.0, f"resumed pretrain run: weights differ, largest {worst[1]:.3e} at {worst[0]}; ops "
                           f"PyTorch names non-deterministic on this path: {ops or 'none'}")
    print(f"phase 10: pretrain --resume: ckpt_2.pth of 1 epoch + --resume auto bit-equal to 2 epochs straight "
          f"({len(diffs)} tensors: weights, slow weights, momentum; step {b['step']}, la_count "
          f"{b['la_count']}, generator, best value {b['meta']['best_val']:.6f}); walls straight "
          f"{walls['straight']:.2f} s, first {walls['first']:.2f} s, resumed {walls['resumed']:.2f} s "
          f"[{card}]", flush=True)

    # 2. --expand_orderings --cache_tiles --tsne, two full epochs (at stride 80, 72 positions: 64 train, 8 val)
    n_pos = sum(len(i.coords) for i in RSPTripletSampler(tile=tile, stride=expand_stride).index_directory(
        slides, cache_dir=None))
    n_train = n_pos - min(8, n_pos // 5)
    reads = []
    real_read = RSPTripletSampler.read_triplet
    RSPTripletSampler.read_triplet = lambda self, r, x, y: reads.append((id(r), x, y)) or real_read(self, r, x, y)
    run = os.path.join(tmp, "expand")
    argv = ["--train_image_pth", slides, "--batch_size", str(batch), "--tile_h", str(tile), "--tile_w", str(tile),
            "--tile_stride", str(expand_stride), "--validation_size", "8", "--num_epoch", "2", "--save_freq", "0",
            "--index_cache_dir", "", "--expand_orderings", "--cache_tiles", "--tsne", "--save_dir", run] + common
    reset_launches()
    t0 = time.time()
    try:
        with plot_recorders(RP, "phase 10: pretrain --tsne") as plots, contextlib.redirect_stdout(io.StringIO()):
            pretrain.main(argv)
        sync()
    finally:
        RSPTripletSampler.read_triplet = real_read
    wall = time.time() - t0
    steps = 2 * (6 * n_train // batch)
    n = read_launches("pretrain_expand_orderings_cache_tiles_tsne")
    check(n["rsp_augment"] == steps and n["photometric_chain"] == 0,
          f"--expand_orderings: fused kernel launched {n['rsp_augment']} times, expected {steps} (6x "
          f"{n_train // batch} a plain epoch, 2 epochs); chain kernel {n['photometric_chain']}")
    check(len(reads) == len(set(reads)) == n_pos,
          f"--cache_tiles: {len(reads)} reads of {len(set(reads))} positions ({n_pos} indexed) over two epochs")
    feats = np.load(os.path.join(run, "best_pre_trained_feats_1.npy"))
    targets = np.load(os.path.join(run, "best_pre_trained_targets_1.npy"))
    check(feats.shape == (6 * n_train // batch * batch, 768) and np.isfinite(feats).all()
          and targets.shape == feats.shape[:1] and set(np.unique(targets)) <= set(range(6)),
          f"--tsne best-epoch features {feats.shape}, targets {targets.shape}")
    val = [a for name, a, _ in plots if name == "save_tsne_plot" and a[-1].endswith(f"{os.sep}tsne.png")]
    n_val = 6 * (n_pos - n_train)
    if val:
        check(val[0][0].shape == (n_val, 768) and np.isfinite(val[0][0]).all(), "--tsne validation features")
    else:
        check(np.load(os.path.join(run, "tsne_feats.npy")).shape == (n_val, 768), "--tsne validation features")
    print(f"phase 10: pretrain --expand_orderings --cache_tiles --tsne, 2 epochs: {steps} steps (6x "
          f"{n_train // batch} a plain epoch), fused kernel launches {n['rsp_augment']}, {len(reads)} reads of {n_pos} "
          f"positions; best-epoch features {feats.shape}, finite; wall {wall:.2f} s [{card}]", flush=True)

    # 3. fine-tune --mode evaluation, Kather from phase 6's best.pth on a seeded test folder
    kather_cfg = dataclasses.replace(TASKS["kather"], image_size=image)
    test_dir = write_kather(os.path.join(tmp, "kather_test"), 64, image)
    ckpt = os.path.join(tmp, "finetune", "best.pth")
    argv = ["--task", "kather", "--mode", "evaluation", "--test_path", test_dir, "--finetune_ckpt", ckpt,
            "--save_dir", os.path.join(tmp, "eval_kather"), "--eval_batch_size", str(batch),
            "--image_size", str(image)] + common
    reset_launches()
    with plot_recorders(RP, "phase 10: Kather evaluation"), contextlib.redirect_stdout(io.StringIO()):
        report = finetune.main(argv)
    launches["finetune_evaluation_kather"] = check_launches("Kather evaluation")
    check(list(report) == ["confusion", "per_class", "weighted_f1", "accuracy", "ovr_auc"]
          and int(np.sum(report["confusion"])) == 9 * 64, f"Kather report keys {list(report)}")
    ds = D.load_kather_folder(test_dir, image)
    states = {d: init_serving_state("resnet18", 9, torch.device(d), ckpt) for d in ("cpu", dev.type)}
    some = ds.subset(np.arange(0, len(ds), 9))
    logits = {d: finetune.predict_all(states[d], some, kather_cfg, torch.device(d), batch_size=batch)
              for d in states}
    lerr = float(np.abs(logits[dev.type] - logits["cpu"]).max())
    check(lerr <= 1e-4, f"Kather evaluation logits, card vs CPU float32: max abs err {lerr}")
    print(f"phase 10: Kather --mode evaluation from phase 6's best.pth on {len(ds)} images of {image}^2: accuracy "
          f"{report['accuracy']:.4f}, weighted F1 {report['weighted_f1']:.4f}, OvR AUC {report['ovr_auc']}; "
          f"float32 logits card vs CPU on {len(some)} of them max abs err {lerr:.2e} [{card}]", flush=True)
    phase_eval_rate(torch, finetune, states[dev.type], ds, kather_cfg, dev, batch, profile_dir, card)

    # 4. BreastPathQ through the report function on numpy data, two raters, from phase 6's checkpoint
    bpq_cfg = dataclasses.replace(TASKS["breastpathq"], image_size=patch)
    rng = np.random.default_rng(5)
    bpq = D.ArrayDataset(rng.integers(0, 256, (48, patch, patch, 3), dtype=np.uint8),
                         rng.random(48).astype(np.float32))
    labels_b = np.clip(bpq.labels + rng.normal(0, 0.1, 48), 0, 1).astype(np.float32)
    state = init_serving_state("resnet18", 1, dev, os.path.join(tmp, "bpq", "final.pth"))
    reset_launches()
    with plot_recorders(RP, "phase 10: BreastPathQ evaluation"), contextlib.redirect_stdout(io.StringIO()):
        out = finetune.predict_all(state, bpq, bpq_cfg, dev, batch_size=16, bf16=True)
        report = finetune.eval_report(bpq_cfg, bpq.labels, out, labels_b)
        path = finetune.write_eval(os.path.join(tmp, "eval_bpq"), bpq_cfg, report, bpq.labels, out, labels_b)
    launches["finetune_evaluation_breastpathq"] = check_launches("BreastPathQ evaluation")
    check(list(report) == ["icc_MA", "icc_MB", "icc_AB", "tau_MA", "mse_MA"] and out.shape == (48,)
          and os.path.exists(path) and math.isfinite(report["mse_MA"]), f"BreastPathQ report {list(report)}")
    print(f"phase 10: BreastPathQ evaluation (48 patches of {patch}^2, two raters): ICC2 MA "
          f"{report['icc_MA']['ICC2']:.4f}, AB {report['icc_AB']['ICC2']:.4f}, tau MA {report['tau_MA']:.4f}, "
          f"MSE MA {report['mse_MA']:.4f}", flush=True)

    # 5. Camelyon16 --mode evaluation from phase 9's fine-tune best.pth on its VALID patches
    c16 = os.path.join(tmp, "c16_finetune", "best.pth")
    test = ",".join(os.path.join(tmp, k) for k in ("tumor_valid", "normal_valid"))
    argv = ["--task", "camelyon16", "--mode", "evaluation", "--test_path", test, "--json_path",
            os.path.join(tmp, "json"), "--finetune_ckpt", c16, "--save_dir", os.path.join(tmp, "eval_c16"),
            "--eval_batch_size", str(batch), "--image_size", str(patch)] + common
    reset_launches()
    with plot_recorders(RP, "phase 10: Camelyon16 evaluation"), contextlib.redirect_stdout(io.StringIO()):
        report = finetune.main(argv)
    launches["finetune_evaluation_camelyon16"] = check_launches("Camelyon16 evaluation")
    check(list(report) == ["confusion", "per_class", "weighted_f1", "accuracy", "auc"]
          and int(np.sum(report["confusion"])) == 32, f"Camelyon16 report {list(report)}")
    print(f"phase 10: Camelyon16 --mode evaluation from phase 9's best.pth on 32 VALID patches: accuracy "
          f"{report['accuracy']:.4f}, AUC {report['auc']}, confusion {report['confusion']}", flush=True)

    # 6. consistency: --mode evaluation on phase 7's best.pth, then --resume auto --ema for a second epoch
    cr = os.path.join(tmp, "consistency", "best.pth")
    argv = ["--task", "kather", "--mode", "evaluation", "--test_path", test_dir, "--eval_ckpt", cr, "--save_dir",
            os.path.join(tmp, "eval_cr"), "--eval_batch_size", str(batch), "--image_size", str(image)] + common
    reset_launches()
    with plot_recorders(RP, "phase 10: consistency evaluation"), contextlib.redirect_stdout(io.StringIO()):
        report = consistency.main(argv)
    launches["consistency_evaluation"] = check_launches("consistency evaluation")
    check(int(np.sum(report["confusion"])) == 9 * 64, "consistency evaluation report")
    run = os.path.join(tmp, "cr_ema")
    argv = ["--task", "kather", "--train_path", os.path.join(tmp, "kather"), "--finetune_ckpt",
            os.path.join(tmp, "finetune", "best.pth"), "--save_dir", run, "--batch_size", "8", "--mu", "7",
            "--NAug", "7", "--save_freq", "1", "--ema", "0.99", "--image_size", str(image)] + common
    restored, real_resume = [], consistency.resume_teacher

    def resume_teacher(args, teacher, state, path):
        real_resume(args, teacher, state, path)
        restored.append({k: v.detach().cpu().clone() for k, v in
                         list(teacher.model.state_dict().items()) + list(teacher.head.state_dict().items())})

    walls, cr_counts = {}, {}
    consistency.resume_teacher = resume_teacher
    reset_launches()
    try:
        for name, extra in (("first", ["--num_epoch", "1"]), ("resumed", ["--num_epoch", "2", "--resume", "auto"])):
            t0 = time.time()
            with recorded_steps(S, "consistency") as cr_steps, contextlib.redirect_stdout(io.StringIO()):
                consistency.main(argv + extra)
            sync()
            walls[name] = time.time() - t0
            cr_counts[name] = len(cr_steps)
    finally:
        consistency.resume_teacher = real_resume
    check(all(cr_counts.values()), f"--resume --ema: consistency steps by run {cr_counts}")
    launches["consistency_ema_first_then_resumed"] = check_launches("consistency --ema and --resume",
                                                                    views=sum(cr_counts.values()))
    saved = load(os.path.join(run, "teacher_ckpt_1.pth"))
    want = {**saved["model"], **saved["classifier"]}
    check(len(restored) == 1 and set(restored[0]) == set(want)
          and all(torch.equal(restored[0][k], v) for k, v in want.items()),
          "--resume --ema: the restored teacher is not teacher_ckpt_1.pth")
    final = load(os.path.join(run, "final.pth"))
    check(final["meta"]["epoch"] == 2 and set(final["generators"]) == {"gen", "host_gen"}
          and os.path.exists(os.path.join(run, "teacher_ckpt_2.pth")), "--resume --ema: the second epoch's files")
    print(f"phase 10: consistency --mode evaluation (phase 7's best.pth): accuracy {report['accuracy']:.4f}; "
          f"--ema run 1 epoch {walls['first']:.2f} s, then --resume auto --ema epoch 2 {walls['resumed']:.2f} s, "
          f"the restored teacher bit-equal to teacher_ckpt_1.pth ({len(want)} tensors) [{card}]", flush=True)
    return launches


def phase_eval_rate(torch, finetune, state, ds, cfg, dev, batch: int, profile_dir: str, card: str) -> None:
    """predict_all's images/s in bf16, warm, over a set the size of Kather's
    test set (CRC-VAL-HE-7K, 7180 images; ``ds``'s images repeated), beside
    the same batches fed to the card with no forward, and the forward alone
    on a batch already there.  ``--profile``: one call traced, its device
    busy share and ``eval_profile.txt``."""
    import numpy as np

    from ssl_cr_histo_tpu_torch.data import datasets as D
    from ssl_cr_histo_tpu_torch.data.pipeline import prefetch_to_device
    from ssl_cr_histo_tpu_torch.parallel import steps as S

    n = 7180
    big = D.ArrayDataset(np.resize(ds.images, (n,) + ds.images.shape[1:]), np.resize(ds.labels, n))
    call = lambda: finetune.predict_all(state, big, cfg, dev, batch_size=batch, bf16=True)
    finetune.predict_all(state, ds, cfg, dev, batch_size=batch, bf16=True)  # cold: left out
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        call()
        torch.cuda.synchronize()
        rates.append(n / (time.time() - t0))
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in prefetch_to_device(big.batches(batch, shuffle=False, drop_last=False), dev):
        pass
    torch.cuda.synchronize()
    feed = n / (time.time() - t0)
    x = torch.from_numpy(ds.images[:batch]).to(dev)
    fwd = batch / cuda_ms(lambda: S.forward(state, x, bf16=True), 20) * 1e3
    print(f"phase 10: predict_all bf16 batch {batch}, warm, on {n} images of {ds.images.shape[1]}^2: "
          f"{', '.join(f'{r:.1f}' for r in rates)} images/s; the same batches fed to the card with no forward "
          f"{feed:.1f} images/s; the forward alone on a batch on the card {fwd:.1f} images/s [{card}]", flush=True)
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            call()
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
        device_ms = sum(e.self_device_time_total for e in device_events(prof)) / 1e3
        table = prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=30)
        os.makedirs(profile_dir, exist_ok=True)
        with open(os.path.join(profile_dir, "eval_profile.txt"), "w") as f:
            f.write(f"{card}\npredict_all over {n} images: device {device_ms:.3f} ms, wall {wall_ms:.3f} ms "
                    f"(profiled)\n{table}\n")
        print(f"profile: predict_all over {n} images, device time {device_ms:.3f} ms against {wall_ms:.3f} ms of "
              f"wall ({device_ms / wall_ms * 100:.1f}% busy, profiled); table in {profile_dir}/eval_profile.txt "
              f"[{card}]", flush=True)


def in_turns(fns: dict, order: list, iters: dict, warmup: int = 2) -> dict:
    """CUDA-event ms of each named function, run in the given order;
    returns every run's time per name."""
    t = {}
    for name in order:
        t.setdefault(name, []).append(cuda_ms(fns[name], iters[name], warmup))
    return t


def phase_timing(torch, dev, tiles, card) -> dict:
    """Phase 8.  Returns the kernels' timings for the kernels line."""
    from ssl_cr_histo_tpu_torch.ops import batch as TB
    from ssl_cr_histo_tpu_torch.ops import fused
    from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK
    from ssl_cr_histo_tpu_torch.ops import rsp_augment_kernel as RK
    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train.init import init_triplet_state

    torch.manual_seed(0)
    state = init_triplet_state("resnet18", dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses = []
    fused_aug = TB.augment_rsp_batch_v1

    def step_with(aug):
        def run():
            TB.augment_rsp_batch_v1 = aug
            try:
                losses.append(S.pretrain_step(state, tiles, gen, bf16=True)["loss"])
            finally:
                TB.augment_rsp_batch_v1 = fused_aug
        return run

    order = ["old", "fused", "fused", "old"]
    steps = in_turns({"old": step_with(old_augment), "fused": step_with(fused_aug)}, order,
                     {"old": 20, "fused": 20}, warmup=5)
    check(all(math.isfinite(float(v)) for v in losses), "non-finite loss in the timed steps")
    runs = lambda k: ", ".join(f"{v:.3f}" for v in steps[k])
    step_ms = {k: sum(v) / len(v) for k, v in steps.items()}
    print(f"phase 8: pretrain step resnet18 b64 256^2 bf16 joint, in turns old/fused/fused/old: "
          f"fused kernel {runs('fused')} ms, unfused composition {runs('old')} ms; means "
          f"{step_ms['fused']:.3f} vs {step_ms['old']:.3f} ms/step = "
          f"{64 * 3 / step_ms['fused'] * 1e3:.1f} vs {64 * 3 / step_ms['old'] * 1e3:.1f} patches/s [{card}]",
          flush=True)

    # one step's path: the fused kernel with the labels as its ordering, and
    # neither the uint8 permutation gather nor the PyTorch warp plan
    from ssl_cr_histo_tpu_torch.ops import geometry

    calls = {"permute_triplets": 0, "warp_pass_coefficients": 0}
    # every module's name for each function, each call counted
    names = [(S, "permute_triplets"), (RK, "permute_triplets"), (geometry, "warp_pass_coefficients")]
    real = [getattr(mod, name) for mod, name in names]

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for (mod, name), fn in zip(names, real):
        setattr(mod, name, counted(name, fn))
    launched = RK.launches
    try:
        S.pretrain_step(state, tiles, gen, bf16=True)
    finally:
        for (mod, name), fn in zip(names, real):
            setattr(mod, name, fn)
    launched = RK.launches - launched
    print(f"phase 8: one bf16 step: fused kernel launches {launched}, calls {calls}", flush=True)
    check(launched == 1 and not any(calls.values()), f"the step's path: {launched} fused launches, {calls}")
    del state

    # the augmentation alone at the main path's shape, Philox noise, bf16 out
    b, n, s = tiles.shape[0], 3 * tiles.shape[0], tiles.shape[2]
    mats = fused.draw_pretrain_geo_matrices(gen, n, s)
    params = PK.draw_params(gen, n)
    seeds = PK.draw_seeds(gen, n)
    args = (tiles, mats, params, seeds, None, *IDENTITY)
    draws = {"geo": mats, "params": params, "noise": None}
    fns = {
        "old": lambda: old_augment(gen, tiles, draws=draws),
        "fused": lambda: RK.rsp_augment_cuda(*args, torch.bfloat16),
        "plain": lambda: RK.rsp_augment_plain(*args, torch.bfloat16),
    }
    aug = in_turns(fns, ["old", "fused", "fused", "old", "plain"], {"old": 10, "fused": 50, "plain": 3})
    fused_f32 = cuda_ms(lambda: RK.rsp_augment_cuda(*args, torch.float32), 50)
    kernel = profiled_kernel_ms(fns["fused"], "rsp_augment_kernel", 50)
    aug_ms = {k: min(v) for k, v in aug.items()}
    # bytes: uint8 tiles in, bf16 out, the (n, 3, 3) maps, params and seeds
    bytes_ = tiles.numel() + n * 3 * s * s * 2 + n * (PK.N_PARAMS + 9 + 1) * 4
    b_ms, b_by = bound_ms(bytes_, fused_ops(params, s * s, philox=True))
    print(f"phase 8: fused kernel ({b}, 3, {s}, {s}, 3) Philox bf16 out: kernel {kernel * 1e3:.1f} us "
          f"(profiler), {b_ms / kernel * 100:.1f}% of its bound; wrapper called back to back "
          f"{aug_ms['fused'] * 1e3:.1f} us = {aug_ms['fused'] / kernel:.2f}x the kernel (runs "
          f"{aug['fused'][0] * 1e3:.1f}, {aug['fused'][1] * 1e3:.1f}), f32 out wrapper {fused_f32 * 1e3:.1f} us; "
          f"unfused composition {aug_ms['old'] * 1e3:.1f} us (runs {aug['old'][0] * 1e3:.1f}, "
          f"{aug['old'][1] * 1e3:.1f}); plain version {aug_ms['plain'] * 1e3:.1f} us; bound {b_ms * 1e3:.1f} us "
          f"by {b_by} ({bytes_ / 1e6:.1f} MB) [{card}]", flush=True)
    out = {"rsp_augment": {"ms": kernel, "plain_ms": aug_ms["plain"], "bound_ms": b_ms, "bound_by": b_by}}

    # host-noise mode: the same work with the noise read, not drawn
    noise = torch.randn((n, 3, s, s), generator=gen, device=dev)
    ni_args = (tiles, mats, params, seeds, noise, *IDENTITY, torch.bfloat16)
    ni_kernel = profiled_kernel_ms(lambda: RK.rsp_augment_cuda(*ni_args), "rsp_augment_kernel", 50)
    ni_plain = cuda_ms(lambda: RK.rsp_augment_plain(*ni_args), 3)
    ni_bytes = bytes_ + noise.numel() * 4
    ni_ms, ni_by = bound_ms(ni_bytes, fused_ops(params, s * s, philox=False))
    print(f"phase 8: fused kernel host-noise mode: kernel {ni_kernel * 1e3:.1f} us (profiler), plain "
          f"{ni_plain * 1e3:.1f} us; bound {ni_ms * 1e3:.1f} us by {ni_by} ({ni_bytes / 1e6:.1f} MB), "
          f"{ni_ms / ni_kernel * 100:.1f}% of it [{card}]", flush=True)

    # where the fused kernel's time goes: each gate alone on every tile (blur
    # at k = 7), and the warp's gathers (identity maps read the source in
    # order; the drawn maps rotate and zoom it)
    gates = [3, 5, 10, 13]
    eye = torch.eye(3, device=dev).expand(n, 3, 3).contiguous()
    parts = []
    for label, on, m in (("all gates off, identity warp", [], eye), ("all gates off", [], mats),
                         ("HSV only", [3], mats), ("noise only", [5], mats), ("blur k=7 only", [10], mats),
                         ("brightness/contrast only", [13], mats), ("all gates on, k=7", gates, mats)):
        p = params.clone()
        p[:, gates], p[:, 9] = 0.0, 7.0
        p[:, on] = 1.0
        a = (tiles, m, p, seeds, None, *IDENTITY, torch.bfloat16)
        parts.append(f"{label} {profiled_kernel_ms(lambda: RK.rsp_augment_cuda(*a), 'rsp_augment_kernel', 20) * 1e3:.1f}")
    print(f"phase 8: fused kernel by gate (us, profiler): {'; '.join(parts)} [{card}]", flush=True)

    # the chain kernel at its (192, 3, 256, 256) float32 shape, Philox mode
    shape = (n, 3, s, s)
    imgs = torch.rand(shape, generator=gen, device=dev)
    noise = torch.randn(shape, generator=gen, device=dev)
    fns = {
        "kernel": lambda: PK.photometric_chain_cuda(imgs, seeds, params),
        "plain": lambda: PK.reference_chain(imgs, params, PK.philox_normal(seeds, shape)),
        "kernel_ni": lambda: PK.photometric_chain_cuda(imgs, seeds, params, noise),
        "plain_ni": lambda: PK.reference_chain(imgs, params, noise),
    }
    t = in_turns(fns, ["plain", "kernel", "kernel", "plain", "plain_ni", "kernel_ni"],
                 {"plain": 5, "kernel": 50, "plain_ni": 5, "kernel_ni": 50})
    ms = {k: min(v) for k, v in t.items()}
    kernel = profiled_kernel_ms(fns["kernel"], "photometric_chain_kernel", 50)
    bytes_ = 2 * imgs.numel() * 4 + n * (PK.N_PARAMS + 1) * 4
    c_ms, c_by = bound_ms(bytes_, chain_ops(params, s * s, philox=True))
    ni_kernel = profiled_kernel_ms(fns["kernel_ni"], "photometric_chain_kernel", 50)
    ni_ms, ni_by = bound_ms(bytes_ + noise.numel() * 4, chain_ops(params, s * s, philox=False))
    print(f"phase 8: photometric chain {shape}: kernel {kernel * 1e3:.1f} us (profiler; the design "
          f"of one 32x32 patch and its halo a block: 265.1 on an H100 80GB HBM3 at 700 W), {ms['kernel'] * 1e3:.1f} us (CUDA events), plain {ms['plain'] * 1e3:.1f} us (Philox mode, "
          f"plain includes its noise), bound {c_ms * 1e3:.1f} us by {c_by}, {c_ms / kernel * 100:.1f}% of it; "
          f"host-noise mode: kernel {ni_kernel * 1e3:.1f} us (profiler; that design 227.0), "
          f"{ms['kernel_ni'] * 1e3:.1f} us (CUDA events), plain {ms['plain_ni'] * 1e3:.1f} us, bound "
          f"{ni_ms * 1e3:.1f} us by {ni_by}, {ni_ms / ni_kernel * 100:.1f}% of it [{card}]", flush=True)
    cluster, rows, smem = PK.chain_launch_plan(s, s)
    at_once = PK.max_active_clusters(s, s)
    print(f"phase 8: photometric chain launch: a cluster of {cluster} CTAs of {rows} rows a tile, {smem} bytes of "
          f"shared memory a CTA, {at_once} clusters at once = {math.ceil(n / at_once)} waves for {n} tiles "
          f"(the last {n - (math.ceil(n / at_once) - 1) * at_once} clusters); stages 1-3 run "
          f"{4 * math.ceil(s / 4) / s:.2f}x a tile's pixels (a 32x32 patch with its halo: 1.41x on blur tiles)", flush=True)
    # where the chain kernel's time goes: each gate alone on every tile (blur at k = 7)
    parts = []
    for label, on in (("all gates off", []), ("HSV only", [3]), ("noise only", [5]), ("blur k=7 only", [10]),
                      ("brightness/contrast only", [13]), ("all gates on, k=7", gates)):
        p = params.clone()
        p[:, gates], p[:, 9] = 0.0, 7.0
        p[:, on] = 1.0
        t_gate = profiled_kernel_ms(lambda: PK.photometric_chain_cuda(imgs, seeds, p), "photometric_chain_kernel", 20)
        parts.append(f"{label} {t_gate * 1e3:.1f}")
    print(f"phase 8: chain kernel by gate, Philox mode (us, profiler): {'; '.join(parts)} [{card}]", flush=True)
    warp_ms = cuda_ms(lambda: fused.pretrain_geo_warp_planar(imgs, mats), iters=5)
    print(f"phase 8: plain warp {shape}: {warp_ms * 1e3:.1f} us [{card}]", flush=True)
    out["photometric_chain"] = {"ms": kernel, "plain_ms": ms["plain"], "bound_ms": c_ms, "bound_by": c_by}
    return out


def profile_steps(torch, step, out_dir: str, filename: str, label: str, card: str):
    """torch.profiler over 3 calls of ``step`` after 5 warm-up calls and 3
    timed unprofiled ones: device time by kernel into ``out_dir/filename``
    (40 rows; 15 printed), and the device's busy share, its kernel time over
    the unprofiled steps' wall time.  Returns the profile."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in device_events(prof)) / 1e3
    table = lambda rows: prof.key_averages().table(sort_by="self_device_time_total", row_limit=rows)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, filename), "w") as f:
        f.write(f"{card}\n3 {label} steps: device {device_ms:.3f} ms (profiled), wall {wall_ms:.3f} ms "
                f"(3 unprofiled steps just before)\n{table(40)}\n")
    print(f"profile: 3 bf16 {label} steps, device time {device_ms:.3f} ms against {wall_ms:.3f} ms of wall for 3 "
          f"unprofiled steps ({device_ms / wall_ms * 100:.1f}% busy); table in {out_dir}/{filename} [{card}]",
          flush=True)
    print(table(15), flush=True)
    return prof


def phase_profile(torch, dev, tiles, out_dir: str, card: str) -> None:
    """The pretrain step's profile (``profile_steps``) into
    ``out_dir/step_profile.txt``, and the gather kernels in it."""
    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train.init import init_triplet_state

    torch.manual_seed(0)
    state = init_triplet_state("resnet18", dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    prof = profile_steps(torch, lambda: S.pretrain_step(state, tiles, gen, bf16=True), out_dir,
                         "step_profile.txt", "pretrain", card)
    gathers = [f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms" for e in device_events(prof)
               if "gather" in e.key.lower()]
    print(f"profile: device kernels named gather in 3 pretrain steps: {gathers or 'none'}", flush=True)


def phase_modes_ops(torch) -> None:
    """Phase 11: each op the augmentation modes add, on the card against the
    CPU in float32 on the same inputs and parameters (16 images of 224^2:
    random, two-level, one-level, dark and uint8 ones): the gather warp
    (nearest and bilinear x constant, reflect-101, edge padding), rot90 per
    image, the PIL ops, autocontrast, equalize, the HED and HSB augmenters,
    within 1e-4; equalize, autocontrast and PIL's gray level equal
    exactly."""
    from ssl_cr_histo_tpu_torch.ops import geometry as G
    from ssl_cr_histo_tpu_torch.ops import photometric as P
    from ssl_cr_histo_tpu_torch.ops import stain as ST

    g = torch.Generator().manual_seed(11)
    n, s = 16, 224
    x = torch.rand(n, 3, s, s, generator=g)
    x[1] = (torch.rand(3, s, s, generator=g) < 0.5).float() * 0.6 + 0.2
    x[2] = 0.5
    x[3] *= 0.1
    x[4] = torch.randint(0, 256, (3, s, s), generator=g).float() / 255.0
    u = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(*(shape or (n,)), generator=g)
    f, k = u(0.1, 1.9), torch.randint(0, 4, (n,), generator=g)
    mats = (G.rotation_matrix(u(-60.0, 60.0), s, s) @ G.shear_x_matrix(u(-0.3, 0.3)) @ G.shear_y_matrix(u(-0.3, 0.3))
            @ G.translation_matrix(u(-20.0, 20.0), u(-20.0, 20.0)))
    sig, bias, hsb = u(-0.1, 0.1, n, 3), u(-0.1, 0.1, n, 3), u(-1.2, 1.2, n, 3)
    cases = {f"warp_affine {i} {p}": (lambda t, d, i=i, p=p: G.warp_affine(t, mats.to(d), interp=i, pad_mode=p,
                                                                          fill=0.25), False)
             for i in ("nearest", "bilinear") for p in ("constant", "reflect101", "edge")}
    cases.update({
        "rot90": (lambda t, d: G.rot90(t, k.to(d)), True),
        "_pil_gray255": (lambda t, d: P._pil_gray255(t), True),
        "autocontrast": (lambda t, d: P.autocontrast(t), True),
        "equalize": (lambda t, d: P.equalize(t), True),
        **{name: (lambda t, d, name=name: getattr(P, name)(t, f.to(d)), False)
           for name in ("pil_brightness", "pil_contrast", "pil_color", "pil_sharpness")},
        "hed_color_augment": (lambda t, d: ST.hed_color_augment(t, sig.to(d), bias.to(d)), False),
        "hsb_color_augment": (lambda t, d: ST.hsb_color_augment(t, hsb.to(d)), False),
    })
    errs = {name: (fn(x.cuda(), "cuda").cpu() - fn(x, "cpu")).abs().max().item()
            for name, (fn, _) in cases.items()}
    print("phase 11: the new ops, card vs CPU (float32, 16 x 224^2), max abs err: "
          + "; ".join(f"{k} {v:.2e}" for k, v in errs.items()), flush=True)
    for name, (_, exact) in cases.items():
        check(errs[name] == 0.0 if exact else errs[name] <= TOL, f"{name}: card vs CPU differ by {errs[name]}")


def phase_modes_policies(torch) -> None:
    """Phase 11: each new policy on the card against the CPU in float32 on
    the same inputs and draws: the v1 pretraining pool op by op and the v2
    pool (fused, masked, exact) on 16 triplets of 256^2 with an ordering,
    and the consistency views under fast, masked and exact on 56 images of
    224^2 (NAug 7).  A policy without a quantized op is held to max abs err
    1e-4; a v2 policy (PIL's gray level, equalize and nearest warps can
    take another integer level after one float op differs by an ulp) to
    its 99.9th percentile of abs err <= 1e-4, beside its max and the share
    of values above 1e-4."""
    import numpy as np

    from ssl_cr_histo_tpu_torch.ops import batch as TB
    from ssl_cr_histo_tpu_torch.ops import randaugment as RA

    g = torch.Generator().manual_seed(12)
    b, s = 16, 256
    tiles = torch.randint(0, 256, (b, 3, s, s, 3), dtype=torch.uint8, generator=g)
    order = torch.randint(0, 6, (b,), generator=g)
    imgs = torch.randint(0, 256, (56, 224, 224, 3), dtype=torch.uint8, generator=g)
    to = lambda d, dev: {k: v.to(dev) for k, v in d.items()}
    runs = {"v1 exact": (RA.draw_pretrain_v1(g, b, s, host_gen=g),
                         lambda d, dev: TB.augment_rsp_batch_v1(None, tiles.to(dev), mode="exact", draws=d,
                                                                order=order.to(dev)))}
    for mode in ("fused", "masked", "exact"):
        runs[f"v2 {mode}"] = (RA.draw_v2(g, b * 3, 2, 3.0, masked=mode == "masked"),
                              lambda d, dev, mode=mode: TB.augment_rsp_batch_v2(None, tiles.to(dev), 2, 3.0,
                                                                               mode=mode, draws=d,
                                                                               order=order.to(dev)))
    for mode in ("fast", "masked", "exact"):
        runs[f"transform_fix_batch {mode}"] = (
            TB.draw_transform_fix(g, 56, 224, 7, 10, host_gen=g, mode=mode),
            lambda d, dev, mode=mode: torch.cat(TB.transform_fix_batch(None, imgs.to(dev), 7, 10, mode=mode,
                                                                       draws=d)))
    stats = {}
    for name, (d, fn) in runs.items():
        err = (fn(to(d, "cuda"), "cuda").float().cpu() - fn(d, "cpu").float()).abs().numpy().ravel()
        stats[name] = float(err.max()), float(np.percentile(err, 99.9)), float((err > TOL).mean())
    print("phase 11: the new policies, card vs CPU (float32): " + "; ".join(
        f"{k} max {w:.2e}, p99.9 {p:.2e}, share > 1e-4 {f:.2e}" for k, (w, p, f) in stats.items()), flush=True)
    for name, (worst, p999, _) in stats.items():
        if name.startswith("v2"):
            check(p999 <= TOL, f"{name}: 99.9th percentile of card vs CPU abs err {p999}")
        else:
            check(worst <= TOL, f"{name}: card vs CPU differ by {worst}")


@contextlib.contextmanager
def recorded(module, name: str):
    """``module.<name>`` with the keyword arguments of each call recorded
    (labels included) for the block; yields the list."""
    calls, real = [], getattr(module, name)

    def wrapped(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def phase_modes_remat(torch, dev, card: str) -> None:
    """Phase 11: ``--remat``.  One pretrain step with the blocks recomputed
    (batch 4 at 64^2, injected draws), held against the CPU's float64 step
    (the model in float64 on the augmentation's float32 views): the card's
    float64 step within 1e-5, the card's float32 step at most 3 times as far
    from it as the CPU's float32 step (largest entry), and against the
    card's float32 step without it (weights and BN statistics within 2e-5,
    the batch counts equal); then resnet50 at batch 64 triplets of 256^2,
    bf16, with and without it in turns (plain, remat, remat, plain): the
    peak memory (``max_memory_allocated``) and the step time."""
    from ssl_cr_histo_tpu_torch.ops import batch as TB
    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train.init import init_triplet_state

    g = torch.Generator().manual_seed(13)
    b, s = 4, 64
    tiles = torch.randint(0, 256, (b, 3, s, s, 3), dtype=torch.uint8, generator=g)
    labels = torch.randint(0, 6, (b,), generator=g)
    draws = TB.draw_rsp_v1(g, b * 3, s)
    draws["noise"] = torch.randn(b * 3, 3, s, s, generator=g)
    out = {}
    augment = S.aug_batch.augment_rsp_batch_v1
    f32, f64 = torch.float32, torch.float64
    for d, remat, dtype in (("cpu", True, f64), ("cpu", True, f32), ("cuda", True, f64), ("cuda", True, f32),
                            ("cuda", False, f32)):
        torch.manual_seed(0)
        state = init_triplet_state("resnet18", torch.device(d), remat=remat)
        state.model.to(dtype)
        state.classifier.to(dtype)
        S.aug_batch.augment_rsp_batch_v1 = lambda *a, **k: augment(*a, **k).to(dtype)
        try:
            S.pretrain_step(state, tiles.to(d), torch.Generator(device=d).manual_seed(0), labels.to(d),
                            {k: v.to(d) for k, v in draws.items()})
        finally:
            S.aug_batch.augment_rsp_batch_v1 = augment
        out[(d, remat, dtype)] = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    diff = lambda a, c: max((a[k].double() - c[k].double()).abs().max().item() for k in a)
    truth = out[("cpu", True, f64)]
    card64 = diff(out[("cuda", True, f64)], truth)
    card32, cpu32 = diff(out[("cuda", True, f32)], truth), diff(out[("cpu", True, f32)], truth)
    vs_cpu, vs_plain = diff(out[("cuda", True, f32)], out[("cpu", True, f32)]), diff(out[("cuda", True, f32)],
                                                                                      out[("cuda", False, f32)])
    check(card64 <= 1e-5, f"float64 remat step card vs CPU differs by {card64}")
    check(card32 <= 3 * cpu32, f"float32 remat step on the card is {card32} from the CPU's float64 step, the CPU's "
                               f"float32 step {cpu32}")
    check(vs_plain <= 2e-5, f"remat step vs the plain step on the card differs by {vs_plain}")
    tracked = [k for k in truth if k.endswith("num_batches_tracked")]
    check(all(int(out[key][k]) == 1 for key in out for k in tracked), "a BatchNorm counted other than one batch")
    print(f"phase 11: pretrain step with --remat (batch 4 at 64^2) against the CPU's float64 step, max abs err: "
          f"float64 card {card64:.2e} (bound 1e-5); float32 card {card32:.2e}, CPU {cpu32:.2e}, card over CPU "
          f"{card32 / cpu32:.2f} (bound 3); float32 card vs CPU {vs_cpu:.2e}; the card's float32 step against its "
          f"step without --remat {vs_plain:.2e}; every num_batches_tracked 1", flush=True)

    big = torch.randint(0, 256, (64, 3, 256, 256, 3), dtype=torch.uint8, generator=g).to(dev)
    states, peaks = {}, {}
    for remat in (False, True):
        torch.manual_seed(0)
        states[remat] = init_triplet_state("resnet50", dev, remat=remat)
    gen = torch.Generator(device=dev).manual_seed(0)
    step = lambda remat: lambda: S.pretrain_step(states[remat], big, gen, bf16=True)
    for remat in (False, True):  # the peak of each, after its warm-up
        step(remat)()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(remat)()
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() / 2**30
    t = in_turns({"plain": step(False), "remat": step(True)}, ["plain", "remat", "remat", "plain"],
                 {"plain": 10, "remat": 10}, warmup=2)
    mean = {k: sum(v) / len(v) for k, v in t.items()}
    print(f"phase 11: resnet50 pretrain step, 64 triplets of 256^2, bf16, in turns plain/remat/remat/plain: without "
          f"--remat {', '.join(f'{v:.3f}' for v in t['plain'])} ms, peak {peaks[False]:.3f} GiB; with --remat "
          f"{', '.join(f'{v:.3f}' for v in t['remat'])} ms, peak {peaks[True]:.3f} GiB; remat/plain time "
          f"{mean['remat'] / mean['plain']:.3f}, memory {peaks[True] / peaks[False]:.3f} [{card}]", flush=True)
    del states


def launches_per_step(torch, step) -> int:
    """The CUDA kernels one warm call of ``step`` launches (torch.profiler;
    copies and memsets left out)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    return sum(e.count for e in device_events(prof) if not e.key.startswith(("Memcpy", "Memset")))


def phase_modes_timing(torch, dev, tiles, card: str, profile_dir: str) -> None:
    """Phase 11 timings (CUDA events, two means of 10 steps after 3 warm-up
    calls): the v2 pretrain step (64 triplets of 256^2, resnet18, bf16, n 2,
    m 3) fused and masked; the v1 exact pretrain step (float32, one
    backbone pass a view, as under --reference_exact); the Kather CR
    consistency step (8 + 56 images at 224^2, NAug 7, bf16) under fused,
    fast, masked and exact, each beside its views alone and its kernel
    launches a step (``--profile``: each step's profile table and busy
    share)."""
    from ssl_cr_histo_tpu_torch.cli.common import TASKS, make_optimizer
    from ssl_cr_histo_tpu_torch.ops import batch as TB
    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train.init import init_finetune_state, init_teacher, init_triplet_state

    gen = torch.Generator(device=dev).manual_seed(0)
    host_gen = torch.Generator().manual_seed(1)
    losses = []
    torch.manual_seed(0)
    state = init_triplet_state("resnet18", dev)
    pre = {f"v2 {m}": dict(augment="v2", aug_mode=m, bf16=True) for m in ("fused", "masked")}
    pre["v1 exact float32 per-view"] = dict(aug_mode="exact", bf16=False, joint_encode=False)
    for name, kw in pre.items():
        step = lambda kw=kw: losses.append(S.pretrain_step(state, tiles, gen, host_gen=host_gen, **kw)["loss"])
        ms = [cuda_ms(step, 10, warmup=3) for _ in range(2)]
        print(f"phase 11: pretrain step {name}, resnet18, 64 triplets of 256^2: {ms[0]:.3f}, {ms[1]:.3f} ms = "
              f"{3 * 64 / (sum(ms) / 2) * 1e3:.1f} patches/s; {launches_per_step(torch, step)} kernel launches a "
              f"step [{card}]", flush=True)
    del state
    cfg, b, mu = TASKS["kather"], TASKS["kather"].cr_batch, 7
    torch.manual_seed(0)
    state = init_finetune_state("resnet18", cfg.num_classes, dev,
                                lambda ps: make_optimizer(cfg.optimizer, ps, cfg.lr), modules=60)
    teacher = init_teacher(state)
    size = cfg.image_size
    x_l = torch.randint(0, 256, (b, size, size, 3), dtype=torch.uint8, generator=gen, device=dev)
    x_u = torch.randint(0, 256, (b * mu, size, size, 3), dtype=torch.uint8, generator=gen, device=dev)
    y_l = torch.randint(0, cfg.num_classes, (b,), generator=gen, device=dev)
    for mode in ("fused", "fast", "masked", "exact"):
        step = lambda mode=mode: losses.append(S.consistency_step(state, teacher, x_l, y_l, x_u, gen, cfg.task,
                                                                  host_gen=host_gen, aug_mode=mode, bf16=True)["loss"])
        ms = [cuda_ms(step, 10, warmup=3) for _ in range(2)]
        views = lambda mode=mode: TB.transform_fix_batch(gen, x_u, mode=mode, host_gen=host_gen)
        view_ms = [cuda_ms(views, 10) for _ in range(2)]
        mean = sum(ms) / 2
        print(f"phase 11: consistency step --aug_mode {mode}, Kather CR (8 + 56 at 224^2, NAug 7, bf16): "
              f"{ms[0]:.3f}, {ms[1]:.3f} ms = {(b + b * mu) / mean * 1e3:.1f} images/s; views alone {view_ms[0]:.3f}, "
              f"{view_ms[1]:.3f} ms = {min(view_ms) / mean * 100:.1f}% of the step; {launches_per_step(torch, step)} "
              f"kernel launches a step, {launches_per_step(torch, views)} for the views [{card}]", flush=True)
        if profile_dir:
            profile_steps(torch, step, profile_dir, f"consistency_{mode}_profile.txt", f"consistency {mode}", card)
    check(all(math.isfinite(float(v)) for v in losses), "non-finite loss in phase 11's timed steps")


def phase_modes(torch, dev, tmp: str, slides: str, tiles, card: str, profile_dir: str) -> dict:
    """Phase 11: the augmentation modes and the last stage-CLI flags: the
    new ops and policies card vs CPU, the CLIs (``phase_modes_clis``),
    --remat, the timings.  Returns each CLI path's launches."""
    phase_modes_ops(torch)
    phase_modes_policies(torch)
    launches = phase_modes_clis(torch, tmp, slides, card)
    phase_modes_remat(torch, dev, card)
    phase_modes_timing(torch, dev, tiles, card, profile_dir)
    return launches


@contextlib.contextmanager
def recorded_steps(S, name: str):
    """Each step that a ``parallel.steps.StepGraph`` named ``name`` runs
    for the block (eager or replayed), as the row it took; yields the
    list."""
    rows, real = [], S.StepGraph.step

    def wrapped(self, *row):
        if self.name == name:
            rows.append(row)
        return real(self, *row)

    S.StepGraph.step = wrapped
    try:
        yield rows
    finally:
        S.StepGraph.step = real


def phase_modes_clis(torch, tmp: str, slides: str, card: str) -> dict:
    """Phase 11's CLI runs on phases 5-6's data, every launch counter set to
    0 before each run and read after: the pretrain CLI (batch 64, 256^2,
    bf16) with --variant v2 (4 steps; neither kernel), with --aug_mode fast
    (4 steps; the fused kernel once a step) and with --reference_exact (2
    steps; no kernel, float32, one backbone pass a view, the x6
    orderings); the consistency CLI at Kather's CR config from phase 6's
    best.pth under --aug_mode fast and masked (the strong views kernel once
    a step) and exact (no kernel).  Returns each path's launches."""
    from ssl_cr_histo_tpu_torch.cli import consistency, pretrain
    from ssl_cr_histo_tpu_torch.parallel import steps as S

    launches = {}
    common = ["--device", "cuda", "--model", "resnet18"]
    base = ["--train_image_pth", slides, "--batch_size", "64", "--tile_h", "256", "--tile_w", "256", "--num_epoch",
            "1", "--validation_size", "64", "--save_freq", "0", "--index_cache_dir", os.path.join(tmp, "rsp_index")]
    runs = {"pretrain_v2_cli": ["--variant", "v2", "--tile_stride", "32", "--steps_per_epoch", "4"],
            "pretrain_fast_cli": ["--aug_mode", "fast", "--tile_stride", "16", "--steps_per_epoch", "4"],
            "pretrain_reference_exact_cli": ["--reference_exact", "--tile_stride", "16", "--steps_per_epoch", "2"]}
    for path, extra in runs.items():
        reset_launches()
        t0 = time.time()
        with recorded(S, "make_pretrain_multi_step") as made, recorded_steps(S, "pretrain") as rows, \
                contextlib.redirect_stdout(io.StringIO()):
            pretrain.main(base + common + extra + ["--save_dir", os.path.join(tmp, path)])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches[path] = n = launch_counts()
        steps = int(extra[-1])
        check(len(made) == 1 and len(rows) == steps, f"{path}: {len(rows)} steps, not {steps}")
        calls = [dict(made[0], labels=row[1] if len(row) > 1 else None) for row in rows]
        with open(os.path.join(tmp, path, "train_results.csv")) as f:
            row = f.read().splitlines()[1]
        check(all(math.isfinite(float(v)) for v in row.split(",")[1:]), f"{path}: CSV row {row}")
        kw = calls[0]
        if path == "pretrain_v2_cli":
            check(kw["augment"] == "v2" and (kw["n_aug"], kw["m_aug"]) == (2, 3.0) and kw["bf16"],
                  f"{path}: step arguments {kw}")
            check(n["rsp_augment"] == n["photometric_chain"] == 0, f"{path}: a kernel launched: {n}")
        elif path == "pretrain_fast_cli":
            check(kw["aug_mode"] == "fast" and n["rsp_augment"] == steps and n["photometric_chain"] == 0,
                  f"{path}: launches {n} in {steps} steps")
        else:
            check(kw["aug_mode"] == "exact" and not kw["bf16"] and not kw["joint_encode"]
                  and kw["labels"] is not None, f"{path}: step arguments {kw}")
            check(n["rsp_augment"] == n["photometric_chain"] == 0, f"{path}: a kernel launched: {n}")
        print(f"phase 11: pretrain CLI {' '.join(extra)}: {steps} steps, wall {wall:.2f} s, launches {n}, CSV {row} "
              f"[{card}]", flush=True)
    for mode in ("fast", "masked", "exact"):
        path = f"consistency_{mode}_cli"
        argv = ["--task", "kather", "--train_path", os.path.join(tmp, "kather"), "--finetune_ckpt",
                os.path.join(tmp, "finetune", "best.pth"), "--save_dir", os.path.join(tmp, path), "--batch_size", "8",
                "--mu", "7", "--NAug", "7", "--num_epoch", "1", "--save_freq", "0", "--aug_mode", mode] + common
        reset_launches()
        t0 = time.time()
        with recorded(S, "make_consistency_multi_step") as made, recorded_steps(S, "consistency") as calls, \
                contextlib.redirect_stdout(io.StringIO()):
            consistency.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches[path] = check_launches(path, views=0 if mode == "exact" else len(calls))
        check(len(calls) >= 3 and len(made) == 1 and made[0]["aug_mode"] == mode, f"{path}: {len(calls)} steps")
        with open(os.path.join(tmp, path, "consistency_results.csv")) as f:
            row = f.read().splitlines()[1]
        check(all(math.isfinite(float(v)) for v in row.split(",")[1:]), f"{path}: CSV row {row}")
        print(f"phase 11: consistency CLI --aug_mode {mode}: {len(calls)} steps, wall {wall:.2f} s, launches "
              f"{launches[path]}, CSV {row} [{card}]", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 12: data parallelism.  The worker functions run in processes this
# script starts (``worker_main``); the checks run in the parent.
# ---------------------------------------------------------------------------

DIST_STEPS, DIST_BATCH = 2, 64
# The CLI runs' steps: a chunk of 8 (--multi_step's default) and a partial
# one of 3; phase 16 holds the NCCL world-1 run's checkpoint against its
# plain run at --multi_step 1 on the same argv
P12_STEPS = 11


def p12_argv(tmp: str, slides: str) -> list:
    """The pretrain CLI's argv of phase 12's runs and phase 16's pretrain
    runs (the config of record, ``P12_STEPS`` steps), without --save_dir."""
    return ["--train_image_pth", slides, "--model", "resnet18", "--batch_size", str(DIST_BATCH), "--tile_h", "256",
            "--tile_w", "256", "--tile_stride", "16", "--num_epoch", "1", "--steps_per_epoch", str(P12_STEPS),
            "--validation_size", "64", "--save_freq", "1", "--index_cache_dir", os.path.join(tmp, "p12_index")]


def run_launch(argv: list, timeout: float) -> str:
    """Run ``argv`` in its own session (a launcher and the workers it
    starts), return its output; on a time-out or a failure every process of
    the session is killed and the run fails."""
    import signal

    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{' '.join(argv[:8])} ...: no end within {timeout} s")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    check(proc.returncode == 0, f"{' '.join(argv[:8])} ... exited {proc.returncode}:\n{out[-6000:]}")
    return out


COLLECTIVES = ("all_reduce", "broadcast", "barrier", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single")


def cli_worker(out: str, argv: list) -> None:
    """One process of a phase 12 CLI run: the pretrain CLI on ``argv`` with
    cuDNN deterministic, every launch counter set to 0 before it and read
    after, a CUDA event pair around each step, every ``torch.distributed``
    collective counted, the card's work profiled (each kernel, copy and set
    by name: calls and device ms); writes ``{out}.{RANK}.json``."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    from ssl_cr_histo_tpu_torch.cli import pretrain
    from ssl_cr_histo_tpu_torch.parallel import distributed as D
    from ssl_cr_histo_tpu_torch.parallel import steps as S

    calls = dict.fromkeys(COLLECTIVES, 0)
    real = {name: getattr(dist, name) for name in COLLECTIVES}

    def counted(name):
        def wrapped(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return wrapped

    for name in COLLECTIVES:
        setattr(dist, name, counted(name))
    reset_launches()
    try:
        with (cuda_timed(torch, S.StepGraph, "step") as pairs, profile(activities=[ProfilerActivity.CUDA]) as prof,
              contextlib.redirect_stdout(io.StringIO())):
            pretrain.main(argv)
            torch.cuda.synchronize()
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
    record = {"world": D.process_count(), "backend": dist.get_backend() if dist.is_initialized() else None,
              "launches": launch_counts(),
              "step_ms": [a.elapsed_time(b) for a, b in pairs], "collectives": calls,
              "device": {e.key: [e.count, e.self_device_time_total / 1e3] for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA}}
    with open(f"{out}.{os.environ.get('RANK', '0')}.json", "w") as f:
        json.dump(record, f)


def gloo_steps(torch, inp: dict, dev, dtype) -> dict:
    """``DIST_STEPS`` pretrain steps (resnet18, the fused kernel writing
    float32, the model in ``dtype``: float32, or float64 on the kernel's
    views cast) on this process's rows of each of ``inp['batches']``
    (global batches of ``DIST_BATCH`` triplets), from a seeded state and
    generator: each fused launch's output, the losses, each step's CUDA
    event time, the state, the launches.  In one process, the whole
    batches."""
    from ssl_cr_histo_tpu_torch.ops import rsp_augment_kernel as RK
    from ssl_cr_histo_tpu_torch.parallel import distributed as D
    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train.init import init_triplet_state

    torch.manual_seed(inp["seed"])
    state = init_triplet_state("resnet18", dev)
    state.model.to(dtype)
    state.classifier.to(dtype)
    gen = torch.Generator(device=dev).manual_seed(inp["seed"] + 1)
    outs, losses, pairs = [], [], []
    kernel, augment = RK.rsp_augment_cuda, S.aug_batch.augment_rsp_batch_v1
    RK.rsp_augment_cuda = lambda *a, **k: outs.append(kernel(*a, **k)) or outs[-1]
    S.aug_batch.augment_rsp_batch_v1 = lambda *a, **k: augment(*a, **k).to(dtype)
    reset_launches()
    try:
        for batch in inp["batches"]:
            step = with_events(torch, S.pretrain_step, pairs)
            m = step(state, D.put_sharded(batch, dev), gen, global_batch=len(batch), bf16=False)
            losses.append(float(m["loss"]))
    finally:
        RK.rsp_augment_cuda, S.aug_batch.augment_rsp_batch_v1 = kernel, augment
    torch.cuda.synchronize()
    out = {"outs": [o.cpu() for o in outs], "losses": losses, "step_ms": [a.elapsed_time(b) for a, b in pairs],
           "model": {k: v.cpu() for k, v in state.model.state_dict().items()},
           "classifier": {k: v.cpu() for k, v in state.classifier.state_dict().items()},
           "launches": launch_counts()}
    del state
    torch.cuda.empty_cache()
    return out


def gloo_worker(inp_path: str, out: str) -> None:
    """One of two processes on the one card over gloo (``cuda:0`` for both):
    ``gloo_steps`` on its rows in float32, then in float64; writes
    ``{out}.{RANK}.pt``."""
    import torch

    from ssl_cr_histo_tpu_torch.parallel import distributed as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    D.initialize(dev, backend="gloo")
    check(D.process_count() == 2, f"gloo world of {D.process_count()}")
    inp = torch.load(inp_path, weights_only=False)
    torch.save({str(dt): gloo_steps(torch, inp, dev, dt) for dt in (torch.float32, torch.float64)},
               f"{out}.{D.process_index()}.pt")


def worker_main(argv: list) -> int:
    """``--cli-worker OUT -- ARGS`` or ``--gloo-worker IN OUT``."""
    sys.path.insert(0, ROOT)
    if argv[0] == "--cli-worker":
        check(argv[2] == "--", f"--cli-worker OUT -- ARGS, not {argv}")
        cli_worker(argv[1], argv[3:])
    else:
        gloo_worker(argv[1], argv[2])
    return 0


def phase_distributed(torch, tmp: str, slides: str, card: str) -> dict:
    """Phase 12 (see the module docstring).  Returns each process's
    launches on each path, counted from 0 in that process."""
    import numpy as np

    from ssl_cr_histo_tpu_torch.data import RSPTripletSampler

    launches = {}
    steps = P12_STEPS
    base = p12_argv(tmp, slides)
    me = os.path.abspath(__file__)
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1"]
    runs, t0 = {}, time.time()
    for i, kind in enumerate(("plain", "world1")):
        out = os.path.join(tmp, f"p12_{i}_{kind}")
        argv = [me, "--cli-worker", out, "--"] + base + ["--save_dir", out + "_run"]
        run_launch(([sys.executable] if kind == "plain" else launch) + argv, timeout=300)
        with open(out + ".0.json") as f:
            rec = json.load(f)
        check(rec["world"] == 1 and rec["backend"] == (None if kind == "plain" else "nccl"),
              f"phase 12 {kind} run: world {rec['world']}, backend {rec['backend']}")
        n = rec["launches"]
        check(n["rsp_augment"] == steps and n["photometric_chain"] == 0,
              f"phase 12 {kind} run: launches {n} in {steps} steps")
        runs.setdefault(kind, []).append((out + "_run", rec))
    load = lambda run: torch.load(os.path.join(run, "ckpt_1.pth"), map_location="cpu", weights_only=False)  # noqa: E731
    a, b = load(runs["plain"][0][0]), load(runs["world1"][0][0])
    tensors = lambda c: ([(f"{part}.{k}", v) for part in ("model", "classifier") for k, v in c[part].items()]  # noqa: E731
                         + [(f"slow.{i}", v) for i, v in enumerate(c["slow"])]
                         + [(f"momentum.{i}", s["momentum_buffer"]) for i, s in c["optimizer"]["state"].items()]
                         + [(f"generator.{k}", v) for k, v in c["generators"].items()])
    pairs = list(zip(tensors(a), tensors(b), strict=True))
    unequal = [k for (k, x), (_, y) in pairs if not torch.equal(x, y)]
    check(not unequal and a["step"] == b["step"] == steps,
          f"NCCL world-1 ckpt_1.pth differs from the plain run's: {unequal[:5]} (step {b['step']})")
    launches["pretrain_cli_nccl_world1"] = runs["world1"][0][1]["launches"]
    launches["_nccl_world1_run"] = runs["world1"][0][0]
    for kind, rs in runs.items():
        for _, rec in rs:
            issued = {k: v for k, v in rec["collectives"].items() if v}
            check(not issued, f"phase 12 {kind} run: collectives issued in a world of one: {issued}")
    # the card's work of each run: every kernel by name and count equal to
    # the first plain run's; copies and sets (NCCL's set-up makes some) and
    # the device time beside them
    is_copy = lambda k: k.startswith(("Memcpy", "Memset"))  # noqa: E731
    ref = runs["plain"][0][1]["device"]
    kernels = {k: v[0] for k, v in ref.items() if not is_copy(k)}
    dev_ms, copies = {}, {}
    for kind, rs in runs.items():
        for i, (_, rec) in enumerate(rs):
            got = {k: v[0] for k, v in rec["device"].items() if not is_copy(k)}
            diff = sorted((k, kernels.get(k, 0), got.get(k, 0)) for k in set(kernels) | set(got)
                          if kernels.get(k, 0) != got.get(k, 0))
            check(not diff, f"phase 12 {kind} run {i + 1}: kernels (name, first plain run's calls, this run's) "
                            f"differ: {diff[:5]}")
            dev_ms.setdefault(kind, []).append(sum(v[1] for v in rec["device"].values()))
            copies.setdefault(kind, []).append(sum(v[0] for k, v in rec["device"].items() if is_copy(k)))
    med = {kind: [float(np.median(rec["step_ms"][1:])) for _, rec in rs] for kind, rs in runs.items()}
    spread = {kind: (min(min(rec["step_ms"][1:]) for _, rec in rs), max(max(rec["step_ms"][1:]) for _, rec in rs))
              for kind, rs in runs.items()}
    print(f"phase 12: pretrain CLI, {steps} steps of {DIST_BATCH} triplets of 256^2, bf16, cuDNN deterministic, "
          f"plain then NCCL world 1: ckpt_1.pth of the world-1 run bit-equal to the "
          f"plain run's ({len(pairs)} tensors: weights, slow weights, momentum, generators; step {b['step']}); "
          f"fused launches {[rec['launches']['rsp_augment'] for rs in runs.values() for _, rec in rs]}; collectives "
          f"issued 0 in every run; the card's kernels equal in every run ({sum(kernels.values())} launches of "
          f"{len(kernels)} kernels), copies and sets plain {copies['plain']}, world 1 {copies['world1']}; the card's "
          f"time over each run (profiler) plain {dev_ms['plain'][0]:.3f} ms, world 1 {dev_ms['world1'][0]:.3f} ms; "
          f"median step (steps 2-{steps}, CUDA events; step 2 holds the capture) plain {med['plain'][0]:.3f} ms "
          f"(range {spread['plain'][0]:.3f}-{spread['plain'][1]:.3f}), world 1 {med['world1'][0]:.3f} ms "
          f"(range {spread['world1'][0]:.3f}-{spread['world1'][1]:.3f}); {time.time() - t0:.1f} s [{card}]",
          flush=True)
    check(max(dev_ms["world1"]) <= 1.15 * max(dev_ms["plain"]),
          f"NCCL world-1 runs' device time {dev_ms['world1']} ms against plain {dev_ms['plain']} ms")

    # two processes on the one card over gloo, against this process
    t0 = time.time()
    sampler = RSPTripletSampler(tile=256, stride=16)
    it = sampler.iter_batches(sampler.index_directory(slides, cache_dir=os.path.join(tmp, "p12_index")), DIST_BATCH,
                              seed=12)
    inp = {"seed": 12, "batches": [np.ascontiguousarray(next(it)) for _ in range(DIST_STEPS)]}
    inp_path, out = os.path.join(tmp, "p12_gloo.in"), os.path.join(tmp, "p12_gloo")
    torch.save(inp, inp_path)
    dtypes = (torch.float32, torch.float64)
    want = {str(dt): gloo_steps(torch, inp, torch.device("cuda"), dt) for dt in dtypes}
    run_launch([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2", me,
                "--gloo-worker", inp_path, out], timeout=600)
    half = DIST_BATCH // 2
    ref32, ref64 = want["torch.float32"], want["torch.float64"]
    gaps, sq = {}, {"two": 0.0}
    for r in range(2):
        got_all = torch.load(f"{out}.{r}.pt", weights_only=False)
        for dt in dtypes:
            got, ref, name = got_all[str(dt)], want[str(dt)], str(dt).split(".")[-1]
            check(len(got["outs"]) == DIST_STEPS == got["launches"]["rsp_augment"]
                  and got["launches"]["photometric_chain"] == 0, f"gloo rank {r} {name}: launches {got['launches']}")
            launches[f"pretrain_step_gloo_world2_{name}_rank{r}"] = got["launches"]
            for i, (o, w) in enumerate(zip(got["outs"], ref["outs"], strict=True)):
                check(torch.equal(o, w[r * half:(r + 1) * half]),
                      f"gloo rank {r} {name} step {i}: fused-kernel output differs from its rows of one process's")
            for i, (x, y, z) in enumerate(zip(got["losses"], ref["losses"], ref64["losses"], strict=True)):
                if dt == torch.float64:
                    check(abs(x - y) <= 1e-5 * abs(y), f"gloo rank {r} {name} step {i}: loss {x!r} against {y!r}")
                else:
                    check(abs(x - z) <= 1e-4 * abs(z), f"gloo rank {r} {name} step {i}: loss {x!r} against the "
                                                       f"float64 step's {z!r}")
                    gaps.setdefault((name, "loss64"), []).append(abs(x - z) / abs(z))
                gaps.setdefault((name, "loss"), []).append(abs(x - y) / abs(y))
            for part in ("model", "classifier"):
                for k, w in ref[part].items():
                    if not w.is_floating_point():
                        check(torch.equal(got[part][k], w), f"gloo rank {r} {name}: {k}")
                        continue
                    scale = max(w.abs().max().item(), 1e-30)
                    d = (got[part][k] - w).abs().max().item()
                    gaps.setdefault((name, "params"), []).append((d / scale, f"{part}.{k}"))
                    if dt == torch.float64:
                        check(d <= 1e-5 * scale, f"gloo rank {r} float64: {part}.{k} off by {d:.3e} "
                                                 f"(bound {1e-5 * scale:.3e})")
                    else:
                        sq["two"] += (got[part][k].double() - ref64[part][k]).square().sum().item()
            print(f"phase 12: gloo rank {r} {name}: step times {', '.join(f'{t:.3f}' for t in got['step_ms'])} ms "
                  f"(correctness only: gloo stages every collective through the host) [{card}]", flush=True)
    sq["one"] = 2 * sum((w.double() - ref64[part][k]).square().sum().item() for part in ("model", "classifier")
                        for k, w in ref32[part].items() if w.is_floating_point())
    one64 = [abs(x - z) / abs(z) for x, z in zip(ref32["losses"], ref64["losses"], strict=True)]
    check(max(one64) <= 1e-4, f"gloo: one process's float32 losses {ref32['losses']} against the float64 step's "
                              f"{ref64['losses']}")
    worst = {name: max(gaps[name, "params"]) for name in ("float32", "float64")}
    above = sorted({k for g, k in gaps["float32", "params"] if g > 1e-5})
    ratio = math.sqrt(sq["two"] / sq["one"])
    print(f"phase 12: gloo world of 2 on one card, {DIST_STEPS} steps of {half} + {half} triplets of 256^2 against "
          f"one process: every fused-kernel output bit-equal to its rows of one process's, one fused launch a step on "
          f"each rank; float64 model: losses' largest relative gap {max(gaps['float64', 'loss']):.2e}, parameters' "
          f"largest {worst['float64'][0]:.2e} of their tensor's largest entry ({worst['float64'][1]}; bound 1e-5); "
          f"float32 model: losses {ref32['losses']}, largest relative gap {max(gaps['float32', 'loss']):.2e} (not "
          f"bounded), against the float64 step's losses two processes {max(gaps['float32', 'loss64']):.2e}, one "
          f"{max(one64):.2e} (bound 1e-4), parameters' largest gap {worst['float32'][0]:.2e} ({worst['float32'][1]}), {len(above)} of "
          f"{len(ref32['model']) + len(ref32['classifier'])} tensors above 1e-5; float32's distance from the float64 "
          f"step over all parameters (L2), two processes over one: {ratio:.3f}; one process's float32 step times "
          f"{', '.join(f'{t:.3f}' for t in ref32['step_ms'])} ms; {time.time() - t0:.1f} s [{card}]", flush=True)
    check(ratio <= 2.0, f"gloo float32: the two-process run's parameters are {ratio:.3f}x as far from the float64 "
                        f"step as the one-process run's")
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the full-recipe rehearsal (``ssl_cr_histo_tpu_torch.tools.
# rehearsal``) at the config of record.
# ---------------------------------------------------------------------------

REHEARSAL_STAGES = ("pretrain", "finetune", "consistency", "evaluation", "heatmap", "froc")


@contextlib.contextmanager
def stage_launches(R, recipe: str, launches: dict):
    """The rehearsal's stage drivers (``R.stage_<name>``) with every launch
    counter set to 0 before each stage and read after, into
    ``launches[(recipe, name)]``, for the block."""
    real = {name: getattr(R, f"stage_{name}") for name in REHEARSAL_STAGES}

    def counted(name, fn):
        def run(*a, **kw):
            reset_launches()
            out = fn(*a, **kw)
            launches[(recipe, name)] = launch_counts()
            return out
        return run

    for name, fn in real.items():
        setattr(R, f"stage_{name}", counted(name, fn))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(R, f"stage_{name}", fn)


def banded(R, recipe: str, report: dict) -> str:
    """Each banded metric of ``report`` beside its band."""
    reused = "reused" in report["stages"].get("pretrain", {})
    return "; ".join(f"{stage}.{key} {'reused' if reused and stage == 'pretrain' else R.band_value(report, stage, key)} "
                     f"in [{lo}, {hi}]" for (stage, key), (lo, hi) in R.BANDS[recipe].items())


def phase_rehearsal(torch, tmp: str, reports: str, card: str) -> dict:
    """Phase 13: the three recipes of ``ssl_cr_histo_tpu_torch.tools.
    rehearsal`` at the config of record (256^2, Kather at 224^2, the
    original's epochs), bands enforced, from one shared pretraining: the
    Camelyon16 recipe trains it (25 epochs of at most 24 steps of 64
    triplets), BreastPathQ (``--bpq_data arrays``: the card has no h5py)
    and Kather take its checkpoint through ``--stage1_ckpt``.  Every launch
    counter is set to 0 before each stage and read after: the fused kernel
    launches once a pretrain step (the steps its checkpoint counts) and
    never in another stage, the strong views kernel once a consistency step
    and never in another stage, the chain kernel never.  Each recipe's report
    goes to ``reports``, its CLIs' prints to ``<recipe>.log`` beside it.
    Returns each stage's launches."""
    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.tools import rehearsal as R

    os.makedirs(reports, exist_ok=True)
    work = os.path.join(tmp, "rehearsal")
    launches, by_path, stage1 = {}, {}, ""
    for recipe in ("camelyon16", "breastpathq", "kather"):
        extra = {"camelyon16": [], "breastpathq": ["--stage1_ckpt", stage1, "--bpq_data", "arrays"],
                 "kather": ["--stage1_ckpt", stage1]}[recipe]
        out, log = os.path.join(reports, f"{recipe}.json"), os.path.join(reports, f"{recipe}.log")
        t0 = time.time()
        with open(log, "w") as f, contextlib.redirect_stdout(f), stage_launches(R, recipe, launches), \
                recorded_steps(S, "pretrain") as steps, recorded_steps(S, "consistency") as cr_steps:
            try:
                report = R.main(["--recipe", recipe, "--device", "cuda", "--workdir", work, "--out", out, *extra])
            except SystemExit as exc:
                report = None
                failure = str(exc)
        torch.cuda.synchronize()
        wall = time.time() - t0
        if report is None:
            with open(log) as f:
                print("".join(f.readlines()[-30:]), flush=True)
            if os.path.exists(out):  # the partial report
                with open(out) as f:
                    print(f"phase 13: {recipe} report: {json.dumps(json.load(f)['stages'])}"[:6000], flush=True)
            fail(f"phase 13: the {recipe} rehearsal failed: {failure}")
        st = report["stages"]
        check(report["band_violations"] == [], f"phase 13: {recipe}: {report['band_violations']}")
        with open(log) as f:
            layouts = trunk_layouts(f.read(), f"phase 13: {recipe}")
        if recipe == "camelyon16":
            stage1 = st["pretrain"]["checkpoint"]
            n = launches[(recipe, "pretrain")]
            check(len(steps) == st["pretrain"]["steps"] > 0 and n["rsp_augment"] >= len(steps)
                  and n["photometric_chain"] == 0,
                  f"phase 13: the pretraining took {len(steps)} steps (its report: {st['pretrain']['steps']}) "
                  f"with launches {n}")
            by_path["rehearsal_pretrain"] = n
        else:
            check(not steps and st["pretrain"] == {"reused": stage1}, f"phase 13: {recipe} pretrained again")
        check(len(cr_steps) > 0, f"phase 13: {recipe}: the consistency stage took no step")
        for (r, name), n in launches.items():
            if r == recipe and (recipe, name) != ("camelyon16", "pretrain"):
                want = {"photometric_chain": 0, "rsp_augment": 0,
                        "strong_views": len(cr_steps) if name == "consistency" else 0}
                check(n == want, f"phase 13: the {recipe} {name} stage launched {n}, want {want}")
                by_path[f"rehearsal_{recipe}_{name}"] = n
        rates = ["stage seconds: " + ", ".join(f"{k} {v['seconds']}" for k, v in st.items() if "seconds" in v)]
        if "aug_patches_per_sec_incl_io" in st["pretrain"]:
            rates.append(f"pretrain {st['pretrain']['aug_patches_per_sec_incl_io']} augmented patches/s incl. "
                         f"I/O, {len(steps)} steps, launches {launches[(recipe, 'pretrain')]}")
        if "heatmap" in st:
            rates.append(f"heatmap {st['heatmap']['patches_per_sec_incl_io']} patches/s incl. I/O "
                         f"({st['heatmap']['patches']} patches)")
        print(f"phase 13: {recipe} rehearsal in {wall:.1f} s; {'; '.join(rates)}; the epoch lines' trunk "
              f"forwards: {len(layouts)} all channels-last [{card}]", flush=True)
        print(f"phase 13: {recipe} bands: {banded(R, recipe, report)}", flush=True)
    return by_path


# ---------------------------------------------------------------------------
# Phase 14: the label-efficiency protocol tool (``ssl_cr_histo_tpu_torch.
# tools.parity_run``) through its dryrun, and the step profiler.
# ---------------------------------------------------------------------------

# Each task at its config-of-record size, and BreastPathQ in memory (the
# card has no h5py); the protocol cut to its smallest and largest labeled
# fractions and a few epochs, so that the phase stays near 3 minutes.
PARITY_TASKS = (("breastpathq", ["--image_size", "256", "--bpq_data", "arrays"]),
                ("camelyon16", ["--image_size", "256"]),
                ("kather", ["--image_size", "224"]))
PARITY_CUTS = ["--fractions", "0.1,1.0", "--finetune_epochs", "2", "--cr_epochs", "1"]


@contextlib.contextmanager
def parity_launches(P, counts: list):
    """``P._setup_dryrun`` (data and the stage-1 pretraining) and each
    ``P.run_fraction`` (the --reference_exact stages) with every launch
    counter set to 0 before and read after, appended to ``counts`` as
    (name, launches), for the block."""
    real = {name: getattr(P, name) for name in ("_setup_dryrun", "run_fraction")}

    def counted(name, fn):
        def run(*a, **kw):
            reset_launches()
            out = fn(*a, **kw)
            tag = "stage1" if name == "_setup_dryrun" else f"fraction_{a[1]:g}"
            counts.append((tag, launch_counts()))
            return out
        return run

    for name, fn in real.items():
        setattr(P, name, counted(name, fn))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(P, name, fn)


def phase_parity_run(torch, tmp: str, reports: str, profile_dir: str, card: str) -> dict:
    """Phase 14: ``parity_run --dryrun`` for the three tasks on the card
    (``PARITY_TASKS``, cut by ``PARITY_CUTS``): each task's table printed,
    every headline metric present and finite; the fused kernel launched
    once a step of the dryrun's stage-1 pretraining and never in a
    --reference_exact stage, the chain kernel never.  Then ``profile_step``
    at the config of record (pretrain, resnet18, 64 triplets of 256^2,
    bf16, fused, one eager step a batch, 3 traced steps): its trace must
    hold the fused kernel 3 times.  The tool's prints go to
    ``reports/parity_<task>.log``, its report beside them.  Returns each
    stage's launches."""
    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.tools import parity_run as P
    from ssl_cr_histo_tpu_torch.tools import profile_step

    os.makedirs(reports, exist_ok=True)
    print(f"phase 14: parity_run --dryrun cut to {' '.join(PARITY_CUTS)} (the protocol: fractions "
          f"0.1,0.25,0.5,1.0, 90 + 90 epochs)", flush=True)
    by_path = {}
    for task, extra in PARITY_TASKS:
        out, log = os.path.join(reports, f"parity_{task}.json"), os.path.join(reports, f"parity_{task}.log")
        counts = []
        t0 = time.time()
        with open(log, "w") as f, contextlib.redirect_stdout(f), parity_launches(P, counts), \
                recorded_steps(S, "pretrain") as steps:
            try:
                report = P.main(["--task", task, "--dryrun", "--pretrained", "dryrun", "--train_path", "x",
                                 "--test_path", "x", *PARITY_CUTS, *extra, "--device", "cuda",
                                 "--workdir", os.path.join(tmp, "parity", task), "--out", out])
            except SystemExit as exc:
                report, failure = None, str(exc)
        torch.cuda.synchronize()
        wall = time.time() - t0
        if report is None:
            with open(log) as f:
                print("".join(f.readlines()[-30:]), flush=True)
            fail(f"phase 14: the {task} dryrun failed: {failure}")
        print(f"phase 14: {task} ({' '.join(extra)}) in {wall:.1f} s; stage seconds "
              + "; ".join(f"{r['fraction']:g}: SSL {r['ssl']['seconds']}, SSL_CR {r['ssl_cr']['seconds']}"
                          for r in report["rows"]) + f" [{card}]\n{report['table']}", flush=True)
        for row in report["rows"]:
            for stage in ("ssl", "ssl_cr"):
                bad = {m: row[stage].get(m) for m in P.HEADLINE[task]
                       if not (isinstance(row[stage].get(m), float) and math.isfinite(row[stage][m]))}
                check(not bad, f"phase 14: {task} fraction {row['fraction']:g} {stage}: missing or non-finite {bad}")
        check([tag for tag, _ in counts] == ["stage1", "fraction_0.1", "fraction_1"],
              f"phase 14: {task}: stages {[tag for tag, _ in counts]}")
        for tag, n in counts:
            want = {"photometric_chain": 0, "rsp_augment": len(steps) if tag == "stage1" else 0, "strong_views": 0}
            check(n == want and (tag != "stage1" or len(steps) > 0),
                  f"phase 14: {task} {tag}: launches {n} against {want} ({len(steps)} pretrain steps)")
            by_path[f"parity_{task}_{tag}"] = n

    logdir = os.path.join(profile_dir or tmp, "profile_step_trace")
    argv = ["--stage", "pretrain", "--model", "resnet18", "--batch_size", "64", "--image_size", "256",
            "--aug_mode", "fused", "--multi_step", "1", "--steps", "3", "--device", "cuda", "--logdir", logdir]
    print("phase 14: profile_step " + " ".join(argv), flush=True)
    reset_launches()
    prof = profile_step.main(argv)
    with open(prof["trace"]) as f:
        events = json.load(f)["traceEvents"]
    traced = [e for e in events if e.get("cat") == "kernel" and "rsp_augment_kernel" in e.get("name", "")]
    n = launch_counts()
    check(len(traced) == 3 and n == {"photometric_chain": 0, "rsp_augment": 4, "strong_views": 0},
          f"phase 14: profile_step's trace holds {len(traced)} fused kernels in 3 steps; launches {n} in 4 steps")
    by_path["profile_step"] = n
    kernel_us = sum(e["dur"] for e in traced) / len(traced)
    print(f"phase 14: profile_step: {prof['ms_per_step']:.3f} ms/step over 3 traced steps; the trace "
          f"({os.path.basename(prof['trace'])}, {len(events)} events) holds rsp_augment_kernel 3 times, "
          f"{kernel_us:.1f} us each; launches {n} (one warm step + 3) [{card}]", flush=True)
    return by_path


# ---------------------------------------------------------------------------
# Phase 15: the label-efficiency quality gate (``ssl_cr_histo_tpu_torch.
# tools.quality_gate``).
# ---------------------------------------------------------------------------


# The aug-on gate's pretraining is also run at these seeds, besides the JAX
# test's (the CLI's default, 42): its pretext check must hold at a majority
AUG_SWEEP_SEEDS = tuple(range(1, 13))


def phase_quality_gate(torch, tmp: str, reports: str, card: str) -> dict:
    """Phase 15: the gates of ``tools/quality_gate.py`` on the card, with
    cuDNN and PyTorch in their deterministic modes (a rerun on this card
    gives the same accuracies; the ops PyTorch names non-deterministic on
    the path are printed).  The main gate, every threshold of
    ``tests/test_quality_gate.py`` enforced: pretext val acc > 0.30;
    25%-label test acc from scratch > 0.5, pretrained >= 0.85 and >=
    scratch + 0.10; CR >= scratch + 0.10.  The aug-on gate at the JAX
    test's argv (pretext > 0.30 under v2 fused augmentation at 64^2,
    transfer >= 0.80): the transfer check enforced, run even where the
    pretext check misses; the pretext check's verdict at seed 42 printed,
    and the check enforced over seed 42 and ``AUG_SWEEP_SEEDS`` as a
    majority: it decides on one draw of a trajectory that swings across
    0.30 from epoch to epoch (ROADMAP Queue 3 item 4).  Neither pretraining
    kernel may launch (v2 pretraining and the fine-tune stages run PyTorch
    ops); the strong views kernel launches once a consistency step.  The
    CLIs' prints go to ``reports/quality_gate.log``.
    Returns each gate's launches."""
    import shutil
    import warnings

    from ssl_cr_histo_tpu_torch.cli import pretrain
    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.tools import quality_gate as Q

    os.makedirs(reports, exist_ok=True)
    root = Q.make_gate_data(os.path.join(tmp, "quality_gate"))
    by_path, log = {}, os.path.join(reports, "quality_gate.log")

    def counted(name: str, views: int = 0) -> None:
        torch.cuda.synchronize()
        by_path[f"quality_gate_{name}"] = n = launch_counts()
        want = {"photometric_chain": 0, "rsp_augment": 0, "strong_views": views}
        check(n == want, f"phase 15: the {name} gate launched {n}, want {want}")

    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with open(log, "w") as f, warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            reset_launches()
            t0 = time.time()
            try:
                with recorded_steps(S, "consistency") as cr_steps, contextlib.redirect_stdout(f):
                    acc = Q.main_gate(root, "cuda")
            except Q.GateFailed as exc:
                fail(f"phase 15: the main gate failed: {exc} (the CLIs' prints: {log})")
            check(len(cr_steps) > 0, "phase 15: the main gate's consistency stage took no step")
            counted("main", len(cr_steps))
            print(f"phase 15: main gate passed in {time.time() - t0:.1f} s: "
                  + ", ".join(f"{k} {v:.6f}" for k, v in acc.items()) + f" [{card}]", flush=True)

            reset_launches()
            t0 = time.time()
            try:
                with contextlib.redirect_stdout(f):
                    acc = Q.aug_gate(root, "cuda")
                verdict = "passed"
            except Q.GateFailed as exc:
                check(str(exc).startswith("aug-pretext:"),
                      f"phase 15: the aug-on gate failed: {exc} (the CLIs' prints: {log})")
                # the pretext check missed at seed 42: the transfer check is
                # still run, and held, on the same pretraining
                verdict = f"pretext check MISSED ({exc})"
                with contextlib.redirect_stdout(f):
                    acc = {"pretext_val_acc": Q.pretext_val_acc(os.path.join(root, "stage1_aug")),
                           "transfer": Q.aug_transfer(root, "cuda")}
                check(acc["transfer"] >= 0.80,
                      f"phase 15: aug-on gate: aug-pretrained transfer too weak: {acc['transfer']}")
            print(f"phase 15: aug-on gate at the JAX test's argv (seed 42) in {time.time() - t0:.1f} s: "
                  f"{verdict}; " + ", ".join(f"{k} {v:.6f}" for k, v in acc.items()) + f" [{card}]", flush=True)
            sweep = {42: acc["pretext_val_acc"]}
            for seed in AUG_SWEEP_SEEDS:
                d = os.path.join(root, f"stage1_aug_seed{seed}")
                with contextlib.redirect_stdout(f):
                    pretrain.main(Q.aug_pretrain_argv(root, d, "cuda") + ["--seed", str(seed)])
                sweep[seed] = Q.pretext_val_acc(d)
                shutil.rmtree(d)
            counted("aug")
            held = sum(v > 0.30 for v in sweep.values())
            print(f"phase 15: the aug-on pretraining's last-epoch pretext val acc at seeds "
                  + ", ".join(f"{s} {v:.6f}" for s, v in sweep.items())
                  + f": > 0.30 at {held} of {len(sweep)} [{card}]", flush=True)
            check(2 * held > len(sweep),
                  f"phase 15: the aug-on pretext check held at {held} of {len(sweep)} seeds, not a majority")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
        torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split(" does not have a deterministic")[0] for w in caught
                  if "deterministic" in str(w.message)})
    print(f"phase 15: ops PyTorch names non-deterministic on the gates' path: {ops or 'none'}", flush=True)
    return by_path


# ---------------------------------------------------------------------------
# Phase 16: --multi_step K, K train steps a chunk replayed as a CUDA graph.
# ---------------------------------------------------------------------------

MULTI_STEP = 8


def tree_leaves(tree, path: str = ""):
    """(name, leaf) of every tensor and scalar of a checkpoint's tree."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from tree_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def checkpoint_diff(torch, path_a: str, path_b: str) -> tuple:
    """The leaves in which two checkpoint files differ, the meta's record of
    the command line left out, with the largest absolute gap of a float
    tensor among them; and the count of leaves compared."""
    trees = []
    for p in (path_a, path_b):
        t = torch.load(p, map_location="cpu", weights_only=False)
        t.get("meta", {}).pop("args", None)
        trees.append(dict(tree_leaves(t)))
    a, b = trees
    diff, gap = [], 0.0
    for k in sorted(set(a) | set(b)):
        x, y = a.get(k), b.get(k)
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
                diff.append(k)
                if x.shape == y.shape and x.is_floating_point():
                    gap = max(gap, (x.double() - y.double()).abs().max().item())
        elif type(x) is not type(y) or x != y:
            diff.append(k)
    return diff, gap, len(a)


def phase_multi_step(torch, tmp: str, slides: str, nccl_world1_run: str, card: str, profile_dir: str) -> dict:
    """Phase 16: ``--multi_step``, the stage CLIs' default of K = 8 train
    steps a chunk, each step after a run's first a replay of one captured
    CUDA graph.  At the config of record, cuDNN and PyTorch deterministic,
    each path at ``--multi_step 8`` and then ``1``, every launch counter 0
    before each run (the fused kernel once a pretrain step, the strong views
    kernel once a consistency step, no other launch): the pretrain CLI for 11 steps (a chunk of 8 and a
    partial one of 3; the K = 8 run traced: one ``rsp_augment_kernel`` a
    step, replays included, and one graph launch a step after the first),
    Kather's fine-tune and consistency (``--aug_mode`` fused and masked)
    from phases 6-7's data and checkpoints, Camelyon16's fine-tune from
    phase 9's; each pair's ``ckpt_1.pth`` must be bit-equal (weights, BN
    statistics, optimizer state, schedule, Lookahead, step, generators,
    meta), Adam's paths too: both run Adam in its capturable form on the
    card (``train.optim.make_capturable``), so a replay runs the eager
    step's kernels on the same tensors.  Then phase 12's NCCL world-1
    pretrain CLI run (``torch.distributed.run --nproc_per_node 1``, the
    same argv at the default of 8) ``nccl_world1_run``, bit-equal to the
    plain run at 1.  Returns each run's launches."""
    from torch.profiler import ProfilerActivity, profile

    from ssl_cr_histo_tpu_torch.cli import consistency, finetune, pretrain
    from ssl_cr_histo_tpu_torch.parallel import steps as S

    t_phase = time.time()
    pre = p12_argv(tmp, slides)
    kather = ["--task", "kather", "--train_path", os.path.join(tmp, "kather"), "--model", "resnet18",
              "--num_epoch", "1", "--save_freq", "1"]
    cr = kather + ["--finetune_ckpt", os.path.join(tmp, "finetune", "best.pth"), "--batch_size", "8", "--mu", "7",
                   "--NAug", "7"]
    c16 = {k: os.path.join(tmp, k) for k in ("tumor", "normal", "tumor_valid", "normal_valid", "json")}
    paths = {
        "pretrain": (pretrain, "pretrain", pre, P12_STEPS),
        "kather_finetune": (finetune, "finetune", kather + ["--model_path", os.path.join(tmp, "run", "ckpt_1.pth"),
                                                            "--batch_size", "64"], 4),
        "kather_consistency_fused": (consistency, "consistency", cr + ["--aug_mode", "fused"], 3),
        "kather_consistency_masked": (consistency, "consistency", cr + ["--aug_mode", "masked"], 3),
        "camelyon16_finetune": (finetune, "finetune", [
            "--task", "camelyon16", "--train_path", f"{c16['tumor']},{c16['normal']}", "--json_path", c16["json"],
            "--val_path", f"{c16['tumor_valid']},{c16['normal_valid']}", "--model_path",
            os.path.join(tmp, "run", "ckpt_1.pth"), "--model", "resnet18", "--num_epoch", "1", "--save_freq", "1"], 4),
    }
    launches, runs = {}, {}
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for path, (cli, stage, argv, steps) in paths.items():
            for k in (MULTI_STEP, 1):
                run = os.path.join(tmp, f"p16_{path}_{k}")
                reset_launches()
                t0 = time.time()
                traced = path == "pretrain" and k > 1
                acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if traced else []
                with recorded_steps(S, stage) as rows, profile(activities=acts) if traced else \
                        contextlib.nullcontext() as prof, contextlib.redirect_stdout(io.StringIO()):
                    cli.main(argv + ["--save_dir", run, "--multi_step", str(k)])
                    torch.cuda.synchronize()
                wall = time.time() - t0
                n = launches[f"{path}_multi_step_{k}"] = launch_counts()
                want = {"photometric_chain": 0, "rsp_augment": steps if stage == "pretrain" else 0,
                        "strong_views": steps if stage == "consistency" else 0}
                check(len(rows) == steps and n == want,
                      f"phase 16: {path} at --multi_step {k}: {len(rows)} steps, launches {n}")
                runs[path, k] = (run, wall)
                if traced:
                    names = {}
                    for e in prof.key_averages():
                        names[e.key] = names.get(e.key, 0) + e.count
                    fused = sum(v for key, v in names.items() if "rsp_augment_kernel" in key)
                    graphs = names.get("cudaGraphLaunch", 0)
                    check(fused == steps and graphs == steps - 1,
                          f"phase 16: the traced pretrain run holds rsp_augment_kernel {fused} times and "
                          f"{graphs} graph launches in {steps} steps")
                    print(f"phase 16: pretrain CLI at --multi_step {k}, {steps} steps (chunks of 8 and 3), traced: "
                          f"rsp_augment_kernel {fused} times, cudaGraphLaunch {graphs} times (every step after the "
                          f"first), fused launches counted {n['rsp_augment']} [{card}]", flush=True)
                    if profile_dir:
                        os.makedirs(profile_dir, exist_ok=True)
                        table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
                        with open(os.path.join(profile_dir, "multi_step_pretrain_profile.txt"), "w") as f:
                            f.write(f"{card}\n{table}\n")
            diff, gap, count = checkpoint_diff(torch, os.path.join(runs[path, MULTI_STEP][0], "ckpt_1.pth"),
                                               os.path.join(runs[path, 1][0], "ckpt_1.pth"))
            check(not diff, f"phase 16: {path}: ckpt_1.pth at --multi_step {MULTI_STEP} differs from --multi_step 1's "
                            f"in {len(diff)} of {count} leaves ({diff[:6]}), largest gap {gap:.3e}")
            print(f"phase 16: {path} CLI, {steps} steps, at --multi_step {MULTI_STEP} ({runs[path, MULTI_STEP][1]:.1f} s "
                  f"of wall) and 1 ({runs[path, 1][1]:.1f} s): ckpt_1.pth bit-equal in all {count} leaves [{card}]",
                  flush=True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
        torch.use_deterministic_algorithms(False)

    # phase 12's NCCL world-1 pretrain CLI run, at the default --multi_step 8,
    # against the plain run at 1
    diff, gap, count = checkpoint_diff(torch, os.path.join(nccl_world1_run, "ckpt_1.pth"),
                                       os.path.join(runs["pretrain", 1][0], "ckpt_1.pth"))
    check(not diff, f"phase 16: phase 12's NCCL world-1 run's ckpt_1.pth at --multi_step {MULTI_STEP} differs from "
                    f"the plain run's at 1 in {diff[:6]}, largest gap {gap:.3e}")
    print(f"phase 16: phase 12's NCCL world-1 pretrain CLI run at --multi_step {MULTI_STEP}: ckpt_1.pth bit-equal to "
          f"the plain run's at 1 in all {count} leaves [{card}]", flush=True)
    print(f"phase 16: {time.time() - t_phase:.1f} s [{card}]", flush=True)
    return launches


def _msgpack_header(n: int, fix: int, fix_max: int, wide: tuple) -> bytes:
    """A msgpack length header: ``fix | n`` below ``fix_max``, else the 8-,
    16- or 32-bit form whose first byte ``wide`` gives (None: no such form)."""
    if n < fix_max:
        return bytes([fix | n])
    for code, fmt, limit in zip(wide, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"a msgpack object of length {n}")


def msgpack_pack(obj) -> bytes:
    """``obj`` in the encoding of ``flax.serialization.msgpack_serialize``
    (flax 0.12.3 ``serialization.py:249-315``; no leaf here reaches its
    1 GiB chunking): str-keyed dicts (their keys sorted, as JAX's tree
    flattening leaves them), lists, None, bools, ints, floats, str,
    bytes, numpy arrays (ext type 1, whose payload is msgpack of (shape,
    dtype name, C-order bytes)) and numpy scalars (ext type 3).  The card's
    machine has neither flax nor ``msgpack``, so phase 18 writes the JAX
    package's checkpoints with this; the port only reads them
    (``ssl_cr_histo_tpu_torch/utils/flax_msgpack.py``)."""
    import numpy as np

    if obj is None or isinstance(obj, bool):
        return bytes([{None: 0xC0, False: 0xC2, True: 0xC3}[obj]])
    if isinstance(obj, (np.ndarray, np.generic)):
        a = np.asarray(obj)
        payload = msgpack_pack([list(a.shape), a.dtype.name, a.tobytes()])
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(len(payload))
        head = bytes([fixext]) if fixext else _msgpack_header(len(payload), 0, 0, (0xC7, 0xC8, 0xC9))
        return head + bytes([1 if isinstance(obj, np.ndarray) else 3]) + payload
    if isinstance(obj, int):
        if -32 <= obj < 128:
            return struct.pack(">b", obj)
        forms = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if obj >= 0 else \
            ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
        for code, fmt in forms:
            with contextlib.suppress(struct.error):
                return bytes([code]) + struct.pack(fmt, obj)
        raise ValueError(f"the integer {obj} is wider than msgpack's 64 bits")
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        data = obj.encode()
        return _msgpack_header(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + data
    if isinstance(obj, bytes):
        return _msgpack_header(len(obj), 0, 0, (0xC4, 0xC5, 0xC6)) + obj
    if isinstance(obj, (list, tuple)):
        return _msgpack_header(len(obj), 0x90, 16, (None, 0xDC, 0xDD)) + b"".join(map(msgpack_pack, obj))
    if isinstance(obj, dict):
        return _msgpack_header(len(obj), 0x80, 16, (None, 0xDE, 0xDF)) + b"".join(
            msgpack_pack(k) + msgpack_pack(v) for k, v in sorted(obj.items()))
    raise TypeError(f"msgpack_pack: a {type(obj).__name__}")


def jax_tree(model_sd: dict, head_sd: dict) -> tuple:
    """The inverse of ``train.checkpoint.from_jax_params``: a TripletNet
    state_dict and a head's (a Classifier's ``classifier.{0,2}``, a
    FinetuneHead's ``classifier.0``) -> the JAX package's ``params``
    ({'model': {'backbone', 'fc'}, 'head'}) and ``batch_stats``
    ({'backbone'}) as numpy trees: conv kernels OIHW -> HWIO, Dense kernels
    transposed, BatchNorm weight / bias / running_mean / running_var ->
    scale / bias / mean / var, ``num_batches_tracked`` dropped (flax keeps
    none)."""
    params, stats = {"model": {"backbone": {}, "fc": {}}}, {"backbone": {}}

    def put(tree, path, value):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = value

    def dense(tree, layer, leaf, v):
        put(tree, [layer, "kernel" if leaf == "weight" else "bias"], v.T if leaf == "weight" else v)

    for name, t in model_sd.items():
        v, parts = t.detach().cpu().numpy(), name.split(".")
        if parts[0] == "fc":  # the pair MLP's fc.0 and fc.2
            dense(params["model"]["fc"], {"0": "fc1", "2": "fc2"}[parts[1]], parts[2], v)
            continue
        mods, leaf = parts[1:-1], parts[-1]
        if leaf == "num_batches_tracked":
            continue
        if mods[0].startswith("layer"):  # layer1.0.conv1 -> layer1_0/conv1
            mods = [f"{mods[0]}_{mods[1]}"] + mods[2:]
        if "downsample" in mods:
            i = mods.index("downsample")
            mods[i: i + 2] = [{"0": "downsample_conv", "1": "downsample_bn"}[mods[i + 1]]]
        if leaf in ("running_mean", "running_var"):
            put(stats["backbone"], mods + [leaf[len("running_"):]], v)
        elif leaf == "weight" and v.ndim == 4:
            put(params["model"]["backbone"], mods + ["kernel"], v.transpose(2, 3, 1, 0))
        else:
            put(params["model"]["backbone"], mods + ["scale" if leaf == "weight" else "bias"], v)
    layers = {"0": "fc"} if {k.split(".")[1] for k in head_sd} == {"0"} else {"0": "fc1", "2": "fc2"}
    for name, t in head_sd.items():
        _, i, leaf = name.split(".")
        dense(params.setdefault("head", {}), layers[i], leaf, t.detach().cpu().numpy())
    return params, stats


def write_jax_checkpoint(path: str, model_sd: dict, head_sd: dict, optimizer: str, epoch: int, step: int) -> None:
    """A checkpoint directory as the JAX package's ``save_checkpoint``
    writes it (``ssl_cr_histo_tpu/train/checkpoint.py:32-55``):
    ``checkpoint.msgpack``, its ``TrainState`` as a state dict (params and
    batch_stats from ``jax_tree``; the optimizer's state at its real size,
    zeros: SGD-Nesterov's trace and Lookahead's slow weights (``sgd``), or
    Adam's moments without Lookahead), and ``meta.json``."""
    import numpy as np

    params, stats = jax_tree(model_sd, head_sd)
    zeros = lambda t: {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v) for k, v in t.items()}  # noqa: E731
    if optimizer == "sgd":  # optax's chain as the JAX package builds it, as a state dict
        opt = {"0": {}, "1": {"0": {"trace": zeros(params)}, "1": {}}}
        slow, la_count = jax_tree(model_sd, head_sd)[0], np.zeros((), np.int32)
    else:
        opt = {"0": {"count": np.asarray(step, np.int32), "mu": zeros(params), "nu": zeros(params)}, "1": {}}
        slow = la_count = None
    state = {"params": params, "batch_stats": stats, "opt_state": opt, "step": np.asarray(step, np.int32),
             "slow_params": slow, "la_count": la_count}
    os.makedirs(path)
    with open(os.path.join(path, "checkpoint.msgpack"), "wb") as f:
        f.write(msgpack_pack(state))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"epoch": epoch, "step": step}, f, indent=2)


def phase_jax_checkpoint(torch, dev, tmp: str, pretrain_ckpt: str, finetune_ckpt: str, d: dict, card: str,
                         patch: int = 256) -> dict:
    """Phase 18: checkpoints the JAX package trained, carried to the port
    without JAX.  Phase 5's pretrain ``ckpt_1.pth`` (SGD-Nesterov,
    Lookahead, a Classifier head) and phase 9's Camelyon16 fine-tune
    ``best.pth`` (Adam, a 2-way FinetuneHead) are written as the JAX
    package's checkpoint directories (``write_jax_checkpoint``), and
    ``python3 -m ssl_cr_histo_tpu_torch.cli.convert_checkpoint`` carries
    each back, a process each: every tensor bit-equal to the source's but
    ``num_batches_tracked`` (0, as the JAX tool writes it), the epoch kept.
    Then the heatmap CLI over the tumor slide with ``--finetune_ckpt`` the
    fine-tune directory and the ``.pth`` (maps bit-equal, or within 1e-6
    with the reason printed), and the Camelyon16 fine-tune CLI for its 4
    steps with ``--model_path`` the pretrain directory, each with every
    launch counter at 0 before and read after (neither kernel may launch).
    Last, the conversion of a resnet50 directory (a fresh port state with
    Adam's moments) as a process and in this one (read, to the reference
    layout, ``torch.save``).  ``d``: phase 9's data (``write_camelyon``).
    Returns each CLI path's launches."""
    import numpy as np

    from ssl_cr_histo_tpu_torch.cli import finetune
    from ssl_cr_histo_tpu_torch.cli import heatmap as heatmap_cli
    from ssl_cr_histo_tpu_torch.cli.common import make_optimizer
    from ssl_cr_histo_tpu_torch.train.checkpoint import jax_to_reference, read_jax_checkpoint
    from ssl_cr_histo_tpu_torch.train.init import init_finetune_state

    t_phase = time.time()
    cpu = dev.type == "cpu"
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    common = ["--model", "resnet18", "--device", dev.type] + (["--image_size", str(patch)] if cpu else [])
    launches = {}

    def carry(src: dict, optimizer: str, label: str) -> str:
        """``src`` written as a JAX directory, converted back by the CLI in a
        process of its own and held to ``src``; returns the directory."""
        jax_dir = os.path.join(tmp, f"jax_{label}")
        epoch = src.get("meta", {}).get("epoch", 0)
        write_jax_checkpoint(jax_dir, src["model"], src["classifier"], optimizer, epoch, src.get("step", 0))
        out = jax_dir + ".pt"
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-m", "ssl_cr_histo_tpu_torch.cli.convert_checkpoint", "--input",
                               jax_dir, "--output", out], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                              capture_output=True, text=True, timeout=600)
        wall = time.time() - t0
        check(proc.returncode == 0, f"phase 18: convert_checkpoint {label} exited {proc.returncode}: "
                                    f"{proc.stderr[-3000:]}")
        got = torch.load(out, map_location="cpu", weights_only=False)
        check(got["epoch"] == epoch, f"phase 18: {label}: epoch {got['epoch']}, want {epoch}")
        for part in ("model", "classifier"):
            check(set(got[part]) == set(src[part]), f"phase 18: {label}: the {part} keys differ: "
                                                    f"{sorted(set(got[part]) ^ set(src[part]))}")
            for k, want in src[part].items():
                g = got[part][k]
                same = (g.dtype == torch.int64 and g.dim() == 0 and int(g) == 0) if k.endswith(
                    "num_batches_tracked") else (g.dtype == want.dtype and torch.equal(g, want.cpu()))
                check(same, f"phase 18: {label}: {part}[{k}] is not the source's")
        size = os.path.getsize(os.path.join(jax_dir, "checkpoint.msgpack"))
        print(f"phase 18: convert_checkpoint {label} ({size} bytes of checkpoint.msgpack): "
              f"{len(got['model']) + len(got['classifier'])} tensors bit-equal "
              f"to the source .pth's (num_batches_tracked 0), epoch {epoch}; {wall:.3f} s wall as a process "
              f"({proc.stdout.strip()}) [{card}]", flush=True)
        return jax_dir

    load = lambda p: torch.load(p, map_location="cpu", weights_only=False)  # noqa: E731
    jax_pretrain = carry(load(pretrain_ckpt), "sgd", "pretrain_resnet18")
    jax_finetune = carry(load(finetune_ckpt), "adam", "finetune_resnet18")

    # the heatmap CLI over the tumor slide from the JAX directory and from the .pth
    one = {k: os.path.join(tmp, f"p18_{k}") for k in ("wsi", "mask")}
    for k, name in (("wsi", "tumor_001.npy"), ("mask", "tumor_001_tissue.npy")):
        os.makedirs(one[k])
        os.symlink(os.path.join(d[k], name), os.path.join(one[k], name))
    maps, walls = {}, {}
    for route, ckpt in (("jax_dir", jax_finetune), ("pth", finetune_ckpt)):
        argv = ["--test_image_pth", one["wsi"], "--test_mask_pth", one["mask"], "--probs_map_path",
                os.path.join(tmp, f"p18_maps_{route}"), "--finetune_ckpt", ckpt, "--batch_size", "256"] + common
        reset_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            maps[route] = heatmap_cli.main(argv)["tumor_001"]
        sync()
        walls[route] = time.time() - t0
        launches[f"jax_checkpoint_heatmap_{route}"] = check_launches(f"heatmap from the {route}")
    diff = float(np.abs(maps["jax_dir"] - maps["pth"]).max())
    why = "" if diff == 0 else (f" (the same weights and patches: cuDNN chose another algorithm in one of the "
                                f"two runs; cudnn.deterministic {torch.backends.cudnn.deterministic})")
    print(f"phase 18: heatmap CLI over tumor_001 ({maps['pth'].size} cells) with --finetune_ckpt the JAX directory "
          f"/ the .pth: {walls['jax_dir']:.3f} / {walls['pth']:.3f} s wall; maps' max abs diff {diff:.3e}{why} "
          f"[{card}]", flush=True)
    check(diff <= 1e-6, f"phase 18: the map from the JAX directory differs from the .pth's by {diff}")

    # the fine-tune CLI from the pretrain JAX directory
    run = os.path.join(tmp, "p18_finetune")
    argv = ["--task", "camelyon16", "--train_path", f"{d['tumor']},{d['normal']}", "--json_path", d["json"],
            "--val_path", f"{d['tumor_valid']},{d['normal_valid']}", "--model_path", jax_pretrain,
            "--save_dir", run, "--num_epoch", "1", "--save_freq", "1"] + common
    print("phase 18: fine-tune CLI " + " ".join(argv), flush=True)
    reset_launches()
    t0 = time.time()
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        finetune.main(argv)
    sync()
    wall = time.time() - t0
    launches["jax_checkpoint_finetune"] = check_launches("fine-tune from a JAX directory")
    check(f"loaded pretrained backbone from {jax_pretrain}" in tee.buf.getvalue(),
          "phase 18: the fine-tune CLI did not load the JAX directory")
    with open(os.path.join(run, "fine_tuned_results.csv")) as f:
        row = f.read().splitlines()[1]
    ckpt = load(os.path.join(run, "final.pth"))
    check(all(math.isfinite(float(v)) for v in row.split(",")) and ckpt["step"] == 4,
          f"phase 18: fine-tune from the JAX directory: CSV {row}, step {ckpt['step']}")
    print(f"phase 18: fine-tune CLI from the JAX directory: 4 steps in {wall:.2f} s wall, CSV (epoch, train_loss, "
          f"val_err) {row}, kernel launches {launches['jax_checkpoint_finetune']} [{card}]", flush=True)

    # resnet50: a fresh port state as a JAX directory with Adam's moments
    torch.manual_seed(0)
    state = init_finetune_state("resnet50", 2, torch.device("cpu"), lambda ps: make_optimizer("adam", ps, 1e-5))
    src = {"model": state.model.state_dict(), "classifier": state.head.state_dict(), "meta": {"epoch": 0}}
    jax_r50 = carry(src, "adam", "resnet50")
    t0 = time.time()
    tree, meta = read_jax_checkpoint(jax_r50)
    t1 = time.time()
    ref = jax_to_reference(tree, meta)
    t2 = time.time()
    torch.save(ref, os.path.join(tmp, "resnet50_in_process.pt"))
    t3 = time.time()
    print(f"phase 18: resnet50 in this process: read {t1 - t0:.3f} s, to the reference layout {t2 - t1:.3f} s, "
          f"torch.save {t3 - t2:.3f} s [{card}]", flush=True)
    print(f"phase 18: {time.time() - t_phase:.1f} s [{card}]", flush=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description="smoke test of the PyTorch port on one NVIDIA GPU")
    ap.add_argument("--profile", default="",
                    help="also profile the steps; write the tables, and phase 14's trace, to this directory")
    ap.add_argument("--reports", default="",
                    help="write phases 13-15's reports and logs to this directory (default: a temporary one)")
    if sys.argv[1:2] in (["--cli-worker"], ["--gloo-worker"]):
        return worker_main(sys.argv[1:])
    opts = ap.parse_args()
    start = time.time()
    if not os.path.isdir(os.path.join(ROOT, "ssl_cr_histo_tpu_torch")):
        fail("run chip_smoke.py from the root of a checkout (ssl_cr_histo_tpu_torch/ missing)")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    # phase 1: the card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build the kernels, one nvcc each, started together
    from ssl_cr_histo_tpu_torch.csrc import build

    t0 = time.time()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(build.build, KERNELS))
    for name in KERNELS:
        build.load_library(name)
    print(f"phase 2: built {', '.join(KERNELS)} in {time.time() - t0:.2f} s", flush=True)
    for name in KERNELS:
        log = build.build_log(name)
        print(log.rstrip(), flush=True)
        regs = sorted({int(v) for v in re.findall(r"Used (\d+) registers", log)})
        smem = sorted({int(v) for v in re.findall(r"(\d+) bytes smem", log)})
        spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores", log))
        print(f"phase 2: {name}: registers a thread {regs}, static shared memory {smem} bytes, spill stores "
              f"{spills} bytes", flush=True)
        check(spills == 0, f"{name}: ptxas reports {spills} bytes of spill stores")

    # phases 3-4: each kernel against its plain version
    from ssl_cr_histo_tpu_torch.ops import fused
    from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK
    from ssl_cr_histo_tpu_torch.ops import rsp_augment_kernel as RK

    print("phase 3: photometric chain kernel vs plain chain", flush=True)
    worst = {"photometric_chain": phase_kernel_vs_plain(PK, torch, dev)}
    print("phase 4: fused augmentation kernel vs plain version", flush=True)
    worst["rsp_augment"] = phase_fused_vs_plain(RK, PK, fused, torch, dev)
    print("phase 4: strong views kernel vs plain version", flush=True)
    worst["strong_views"], views_timing = phase_views_vs_plain(torch, dev, card)

    # phase 5: the main path through the CLI
    from ssl_cr_histo_tpu_torch.cli import pretrain
    from ssl_cr_histo_tpu_torch.data import RSPTripletSampler
    from ssl_cr_histo_tpu_torch.models import Classifier, TripletNet, feature_dim
    from ssl_cr_histo_tpu_torch.parallel import steps as S

    phase_step_card_vs_cpu(torch)
    steps = 8
    with tempfile.TemporaryDirectory() as tmp:
        slides = write_slides(tmp)
        run = os.path.join(tmp, "run")
        base = ["--train_image_pth", slides, "--model", "resnet18",
                "--batch_size", "64", "--tile_h", "256", "--tile_w", "256", "--tile_stride", "16",
                "--num_epoch", "1", "--steps_per_epoch", str(steps), "--validation_size", "64",
                "--save_freq", "1", "--index_cache_dir", ""]
        argv = base + ["--save_dir", run]
        print("phase 5: pretrain CLI " + " ".join(argv), flush=True)
        reset_launches()
        tee = Tee(sys.stdout)
        t0 = time.time()
        with cuda_timed(torch, S.StepGraph, "step") as pairs, contextlib.redirect_stdout(tee):
            pretrain.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = launch_counts()
        epoch = re.search(r"Epoch time: ([0-9.]+) s", tee.buf.getvalue())
        check(epoch is not None and len(pairs) == steps, f"the CLI printed no epoch time or took {len(pairs)} steps")
        layouts = trunk_layouts(tee.buf.getvalue(), "phase 5")
        print(f"phase 5: CLI wall {wall:.2f} s, launches {launches}; the epoch's wall {float(epoch.group(1)):.2f} s "
              f"(the CLI's own print) against {events_s(pairs):.3f} s of stream time between the CUDA events "
              f"around each of its {steps} steps; trunk forwards {layouts} [{card}]", flush=True)
        check(launches["rsp_augment"] >= steps,
              f"fused kernel launched {launches['rsp_augment']} times in {steps} train steps")
        check(launches["photometric_chain"] == 0,
              f"chain kernel launched {launches['photometric_chain']} times on the main path")

        with open(os.path.join(run, "train_results.csv")) as f:
            rows = [r.strip() for r in f.read().splitlines()[1:] if r.strip()]
        check(len(rows) == 1, f"expected one CSV row, got {rows}")
        vals = [float(v) for v in rows[0].split(",")[1:]]
        check(all(math.isfinite(v) for v in vals), f"non-finite metrics in CSV: {rows[0]}")
        check(0.0 < vals[0] < 10.0, f"train loss {vals[0]} out of range")
        print(f"phase 5: CSV {rows[0]}", flush=True)
        for name in ("ckpt_1.pth", "best.pth"):
            check(os.path.exists(os.path.join(run, name)), f"{name} not written")
        ckpt = torch.load(os.path.join(run, "ckpt_1.pth"), map_location="cpu", weights_only=False)
        check("model.conv1.weight" in ckpt["model"] and "classifier.2.weight" in ckpt["classifier"],
              "checkpoint lacks the reference keys")
        check(all(torch.isfinite(v).all() for v in ckpt["model"].values() if v.is_floating_point()),
              "non-finite weights in the checkpoint")

        # the trained checkpoint's float32 eval forward: card vs CPU
        nets = {}
        for d in ("cpu", "cuda"):
            m, c = TripletNet("resnet18"), Classifier(feature_dim("resnet18"), 6)
            m.load_state_dict(ckpt["model"])
            c.load_state_dict(ckpt["classifier"])
            nets[d] = (m.to(d).eval(), c.to(d).eval())
        x = torch.rand(2, 3, 3, 256, 256, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            outs = {d: nets[d][1](nets[d][0].forward_joint(x.to(d))).cpu() for d in nets}
        ferr = (outs["cuda"] - outs["cpu"]).abs().max().item()
        check(ferr <= 1e-3, f"card vs CPU float32 forward differ by {ferr}")
        print(f"phase 5: checkpoint forward, card vs CPU float32 logits: max abs err {ferr:.2e}",
              flush=True)
        phase_pretrain_feeds(torch, pretrain, S, base, tmp, steps, card)
        # one real batch of triplets for the timing phase
        sampler = RSPTripletSampler(tile=256, stride=16)
        tiles_np = next(sampler.iter_batches(sampler.index_directory(slides, cache_dir=None),
                                             64, seed=0))

        # phase 6: fine-tuning from the pretrain CLI's checkpoint (the stage handoff)
        phase_finetune(torch, dev, tmp, os.path.join(run, "ckpt_1.pth"), card, opts.profile)
        # phase 7: consistency training from phase 6's checkpoints (stage 2 -> 3)
        cr_launches = phase_consistency(torch, dev, tmp, card, opts.profile)

        # phase 8: timing
        tiles = torch.from_numpy(np.ascontiguousarray(tiles_np)).to(dev)
        timing = phase_timing(torch, dev, tiles, card)
        if opts.profile:
            phase_profile(torch, dev, tiles, opts.profile, card)
        del tiles

        # phase 9: Camelyon16 from the pretrain checkpoint to a heatmap and its FROC
        camelyon = phase_camelyon(torch, dev, tmp, os.path.join(run, "ckpt_1.pth"), card, opts.profile)

        # phase 10: the stage CLIs' remaining modes (resume, the pretrain flags, evaluation)
        t0 = time.time()
        by_path = {"pretrain_cli": launches, **cr_launches,
                   **phase_remaining_modes(torch, dev, tmp, slides, card, opts.profile)}
        print(f"phase 10: {time.time() - t0:.1f} s [{card}]", flush=True)

        # phase 11: the augmentation modes and the last stage-CLI flags
        t0 = time.time()
        tiles = torch.from_numpy(np.ascontiguousarray(tiles_np)).to(dev)
        by_path.update(phase_modes(torch, dev, tmp, slides, tiles, card, opts.profile))
        del tiles
        print(f"phase 11: {time.time() - t0:.1f} s [{card}]", flush=True)

        # phase 12: data parallelism across processes
        t0 = time.time()
        by_path.update(phase_distributed(torch, tmp, slides, card))
        print(f"phase 12: {time.time() - t0:.1f} s [{card}]", flush=True)

        # phase 13: the full-recipe rehearsal at the config of record
        reports = opts.reports or os.path.join(tmp, "reports")
        t0 = time.time()
        by_path.update(phase_rehearsal(torch, tmp, reports, card))
        print(f"phase 13: {time.time() - t0:.1f} s [{card}]", flush=True)

        # phase 14: the label-efficiency protocol's dryrun and the step profiler
        t0 = time.time()
        by_path.update(phase_parity_run(torch, tmp, reports, opts.profile, card))
        print(f"phase 14: {time.time() - t0:.1f} s [{card}]", flush=True)

        # phase 15: the label-efficiency quality gate
        t0 = time.time()
        by_path.update(phase_quality_gate(torch, tmp, reports, card))
        print(f"phase 15: {time.time() - t0:.1f} s [{card}]", flush=True)

        # phase 16: --multi_step, K train steps a chunk as CUDA-graph replays
        by_path.update(phase_multi_step(torch, tmp, slides, by_path.pop("_nccl_world1_run"), card, opts.profile))

        # phase 18: checkpoints the JAX package trained, carried to the port
        by_path.update(phase_jax_checkpoint(torch, dev, tmp, os.path.join(run, "ckpt_1.pth"),
                                            os.path.join(tmp, "c16_finetune", "best.pth"), camelyon, card))

    replaces = {"photometric_chain": "ssl_cr_histo_tpu/ops/pallas_photometric.py:199",
                "rsp_augment": "ssl_cr_histo_tpu/ops/pallas_photometric.py:199",
                "strong_views": "none: XLA ops, ssl_cr_histo_tpu/ops/batch.py::transform_fix_batch"}
    # each kernel's main path: the pretrain CLI (phase 5), the consistency CLI (phase 7)
    main_path = {"photometric_chain": "pretrain_cli", "rsp_augment": "pretrain_cli", "strong_views": "consistency_cli"}
    timing["strong_views"] = views_timing
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"ssl_cr_histo_tpu_torch/csrc/{name}.cu",
        "replaces": replaces[name],
        "launches": by_path[main_path[name]][name],
        "launches_by_path": {path: n[name] for path, n in by_path.items()},
        "max_abs_err": worst[name],
        **timing[name],
        "library_ms": None,
    } for name in KERNELS]
    print(f"chip_smoke: {time.time() - start:.1f} s in all [{card}]", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
