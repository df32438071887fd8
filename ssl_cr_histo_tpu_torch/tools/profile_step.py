"""Capture a ``torch.profiler`` trace of a train step.

The port's counterpart of ``tools/profile_step.py``.  Builds the requested
stage's step at a given config (bf16 autocast, the JAX tool's optimizers and
heads), runs it once to warm (kernel builds, cuDNN's algorithm choice), then
traces ``--steps`` steps into ``--logdir`` (``utils.profiling.trace``; view
with TensorBoard or chrome://tracing) and prints ms/step, timed inside the
trace window up to a synchronize, and the ten operations that took the most
device time (on the CPU: self CPU time).

    python3 -m ssl_cr_histo_tpu_torch.tools.profile_step --stage pretrain --batch_size 64 \\
        --logdir TRACE_DIR [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np


def build_step(args, device):
    """A closure running one step of ``args.stage`` on seeded random uint8
    inputs (the JAX tool's ``default_rng(0)`` data, torch seed 0 weights,
    augmentation draws from a generator seeded 1); it returns the step's
    metrics.  pretrain: TripletNet + 6-way classifier, SGD-Nesterov 0.01,
    v1 augmentation in ``--aug_mode``, joint encode; finetune: 9-way head,
    Adam 1e-4; consistency: 2-way head, SGD-Nesterov 5e-4, a teacher equal
    to the student, ``--mu`` unlabeled images a labeled one, NAug 7."""
    import torch

    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train import optim
    from ssl_cr_histo_tpu_torch.train.init import init_finetune_state, init_teacher, init_triplet_state

    b, size = args.batch_size, args.image_size
    rng = np.random.default_rng(0)
    u8 = lambda *shape: torch.from_numpy((rng.random(shape) * 255).astype(np.uint8)).to(device)
    torch.manual_seed(0)
    gen = torch.Generator(device=device).manual_seed(1)

    if args.stage == "pretrain":
        state = init_triplet_state(args.model, device, lr=0.01)
        tiles = u8(b, 3, size, size, 3)
        return lambda: S.pretrain_step(state, tiles, gen, aug_mode=args.aug_mode, bf16=True)
    if args.stage == "finetune":
        state = init_finetune_state(args.model, 9, device, lambda p: optim.adam(p, 1e-4))
        imgs = u8(b, size, size, 3)
        labels = torch.from_numpy(np.arange(b) % 9).to(device)
        return lambda: S.finetune_step(state, imgs, labels, gen, "classification", bf16=True)
    state = init_finetune_state(args.model, 2, device, lambda p: optim.sgd_nesterov(p, 5e-4))
    teacher = init_teacher(state)
    xl = u8(b, size, size, 3)
    yl = torch.from_numpy(np.arange(b) % 2).to(device)
    xu = u8(b * args.mu, size, size, 3)
    return lambda: S.consistency_step(state, teacher, xl, yl, xu, gen, "classification", n_aug=7,
                                      aug_mode=args.aug_mode, bf16=True)


def top_ops(prof, device, n: int = 10) -> list:
    """The ``n`` operations of the profile with the most self time on
    ``device`` (the card's kernels and copies; on the CPU its ops):
    [(name, calls, ms)]."""
    from torch.autograd import DeviceType

    if device.type == "cuda":
        rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
    else:
        rows = [(e.key, e.count, e.self_cpu_time_total / 1e3) for e in prof.key_averages()]
    return sorted(rows, key=lambda r: -r[2])[:n]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("train-step trace capture (PyTorch / CUDA)")
    p.add_argument("--stage", default="pretrain", choices=["pretrain", "finetune", "consistency"])
    p.add_argument("--logdir", required=True)
    p.add_argument("--model", default="resnet18", choices=["resnet18", "resnet50"])
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--mu", type=int, default=7, help="consistency unlabeled multiplier")
    p.add_argument("--steps", type=int, default=3, help="traced steps")
    p.add_argument("--aug_mode", default="fused")
    p.add_argument("--device", default="cuda", help="torch device; 'cuda' fails when no GPU is present")
    args = p.parse_args(argv)

    import torch

    from ssl_cr_histo_tpu_torch.utils.profiling import trace

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available on this machine")
    sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None
    run = build_step(args, device)

    float(run()["loss"])  # warm: the first step builds kernels and picks cuDNN algorithms
    sync()
    before = set(glob.glob(os.path.join(args.logdir, "*.pt.trace.json")))
    with trace(args.logdir) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            m = run()
        float(m["loss"])
        sync()  # the optimizer's update runs after the loss: wait for all of it
        dt = (time.perf_counter() - t0) / args.steps
    (path,) = set(glob.glob(os.path.join(args.logdir, "*.pt.trace.json"))) - before
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    top = top_ops(prof, device)
    print(f"traced {args.steps} {args.stage} steps ({dt * 1000:.1f} ms/step) -> {path} [{where}]")
    print(f"top {len(top)} operations by self {'device' if device.type == 'cuda' else 'CPU'} time:")
    for name, calls, ms in top:
        print(f"  {ms:10.3f} ms  x{calls:<5d} {name[:100]}")
    return {"stage": args.stage, "ms_per_step": dt * 1000, "trace": path, "top": top}


if __name__ == "__main__":
    main()
