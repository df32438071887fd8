"""Multi-stage benchmark suite -> ``reports/bench_suite.json`` (committed).

The port's counterpart of ``tools/bench_suite.py``.  ``tools.bench`` guards
one number (the pretrain step); this suite measures the four hot paths on
the card, with the JAX suite's metric names and configurations of record:

  1. RSP pretrain step        -- ``bench.measure_pretrain`` itself (256^2,
                                 batch 64, v1 pool on the fused kernel,
                                 joint encode, ``--multi_step 8``, bf16)
  2. SSL_CR consistency step  -- Camelyon16 (16 labeled + mu 7 -> 112
                                 unlabeled of 256^2, NAug 7), under
                                 ``--aug_mode`` fused and fast
  3. supervised fine-tune step -- Kather (batch 64, the 3-view stack, 224^2,
                                 Adam 1e-5)
  4. serving eval forward     -- bf16 eval-mode forward, batches of 256
                                 patches of 256^2 (the heatmap and
                                 evaluation inner loop)

The training steps run K = 8 steps a chunk, the port CLIs' default
(``parallel.steps.StepGraph``: the first step eager, then replays of one
captured CUDA graph; the consistency step's weak and strong views stay
eager each step, as one launch of the strong views kernel,
``ops/strong_views_kernel.py``).  The JAX suite times its consistency step
one jitted step a dispatch, which on the TPU is one launch either way.
Each timing chains its work with no host sync and ends with one scalar
fetch of the last output.

Regression guard: each run loads the committed artifact at ``--out`` first
and fails (exit 1) if any metric dropped more than ``--tolerance`` (default
10%) below it; the violations are written into the new artifact either
way.  Re-baseline deliberately with ``--accept-regression``.

    python3 -m ssl_cr_histo_tpu_torch.tools.bench_suite [--out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ssl_cr_histo_tpu_torch.tools import bench as B

# the pretrain number IS bench's measurement (shared, not re-implemented)
bench_pretrain = B.measure_pretrain


def _u8(rng, shape) -> np.ndarray:
    return rng.integers(0, 256, shape, dtype=np.uint8)


def bench_consistency(aug_mode: str, iters: int = 3, device: str = "cuda", *, b_l: int = 16, mu: int = 7,
                      tile: int = 256, k_steps: int = 8) -> dict:
    """The consistency step at Camelyon16's config of record (``tools/
    bench_suite.py:60-105``): ``b_l`` labeled images (8 a pool) + mu * b_l
    unlabeled a step at ``tile``^2, NAug 7, two classes, SGD-Nesterov 5e-4
    with weight decay 1e-4, the teacher refreshed from the student; K =
    ``k_steps`` steps a chunk (``make_consistency_multi_step``), ``iters``
    timed chunks of the same batch.  Seeds: numpy 1 (the JAX suite's draws,
    in its order), torch 0."""
    import torch

    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train import optim
    from ssl_cr_histo_tpu_torch.train.init import init_finetune_state, init_teacher

    dev = B.resolve(device)
    before = B.launch_counts()
    b_u = b_l * mu
    rng = np.random.default_rng(1)
    x_l = torch.from_numpy(_u8(rng, (b_l, tile, tile, 3))).to(dev)
    y_l = torch.from_numpy(rng.integers(0, 2, (b_l,)).astype(np.int64)).to(dev)
    x_u = torch.from_numpy(_u8(rng, (b_u, tile, tile, 3))).to(dev)
    torch.manual_seed(0)
    state = init_finetune_state("resnet18", 2, dev, lambda p: optim.sgd_nesterov(p, 5e-4, weight_decay=1e-4))
    teacher = S.refresh_teacher(init_teacher(state), state)
    gen = torch.Generator(device=dev).manual_seed(0)
    host_gen = torch.Generator().manual_seed(1)
    step = S.make_consistency_multi_step(state, teacher, gen, k_steps, "classification", n_aug=7,
                                         host_gen=host_gen, aug_mode=aug_mode, bf16=True)
    chunk = tuple(x.expand(k_steps, *x.shape) for x in (x_l, y_l, x_u))
    dt = B.time_chunks(step, chunk, k_steps, iters)
    del state, teacher, step, chunk, x_l, x_u
    B.release(dev)
    return {
        "metric": f"cr_step_samples_per_sec_per_chip_{aug_mode}",
        "value": round((b_l + b_u) / dt, 1),
        "unit": "samples/s/chip",
        "ms_per_step": round(dt * 1000, 2),
        "config": f"camelyon16 CR {b_l}+{b_u} {tile}^2 aug_mode={aug_mode} multi_step={k_steps} bf16",
        "platform": B.platform_of(dev),
        "launches": B.launches_since(before),
    }


def bench_finetune(iters: int = 3, device: str = "cuda", *, b: int = 64, size: int = 224, k_steps: int = 8) -> dict:
    """The fine-tune step at Kather's config of record (``tools/
    bench_suite.py:108-148``): batch ``b``, the 3-view stack on the device,
    ``size``^2, nine classes, Adam 1e-5 (its capturable form on the card);
    K = ``k_steps`` steps a chunk (``make_finetune_multi_step``) over the
    JAX suite's K batches (numpy seed 2), ``iters`` timed chunks."""
    import torch

    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train import optim
    from ssl_cr_histo_tpu_torch.train.init import init_finetune_state

    dev = B.resolve(device)
    before = B.launch_counts()
    rng = np.random.default_rng(2)
    imgs = torch.from_numpy(_u8(rng, (k_steps, b, size, size, 3))).to(dev)
    labels = torch.from_numpy(rng.integers(0, 9, (k_steps, b)).astype(np.int64)).to(dev)
    torch.manual_seed(0)
    state = init_finetune_state("resnet18", 9, dev, lambda p: optim.adam(p, 1e-5))
    gen = torch.Generator(device=dev).manual_seed(0)
    step = S.make_finetune_multi_step(state, gen, k_steps, "classification", bf16=True)
    dt = B.time_chunks(step, (imgs, labels), k_steps, iters)
    del state, step, imgs
    B.release(dev)
    return {
        "metric": "finetune_step_samples_per_sec_per_chip",
        "value": round(b / dt, 1),
        "unit": "samples/s/chip",
        "ms_per_step": round(dt * 1000, 2),
        "config": f"kather FT b={b} 3-view {size}^2 adam multi_step={k_steps} bf16",
        "platform": B.platform_of(dev),
        "launches": B.launches_since(before),
    }


def bench_serving(iters: int = 20, device: str = "cuda", *, b: int = 256, size: int = 256) -> dict:
    """The eval-mode forward (the heatmap and evaluation inner loop;
    ``tools/bench_suite.py:151-188``): ``parallel.steps.forward`` at bf16
    on batches of ``b`` uint8 patches of ``size``^2 (numpy seed 3), a
    2-way head; one warm forward, then ``iters`` forwards queued back to
    back, one scalar fetch of the last output ending the window."""
    import torch

    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train import optim
    from ssl_cr_histo_tpu_torch.train.init import init_finetune_state

    dev = B.resolve(device)
    before = B.launch_counts()
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(_u8(rng, (b, size, size, 3))).to(dev)
    torch.manual_seed(0)
    state = init_finetune_state("resnet18", 2, dev, lambda p: optim.adam(p, 1e-4))
    out = S.forward(state, imgs, bf16=True)
    float(out[0, 0])
    t0 = time.perf_counter()
    for _ in range(iters):
        out = S.forward(state, imgs, bf16=True)
    last = float(out[0, 0])
    dt = (time.perf_counter() - t0) / iters
    if last != last:
        raise FloatingPointError("the forward's output is NaN")
    del state, out, imgs
    B.release(dev)
    return {
        "metric": "serving_eval_forward_patches_per_sec_per_chip",
        "value": round(b / dt, 1),
        "unit": "patches/s/chip",
        "ms_per_step": round(dt * 1000, 2),
        "config": f"eval forward b={b} {size}^2 bf16",
        "platform": B.platform_of(dev),
        "launches": B.launches_since(before),
    }


def check_bands(results, committed, tolerance=0.10):
    """Guard-band a fresh run against the committed artifact: flag every
    metric that dropped by more than ``tolerance`` below its committed
    value (``tools/bench_suite.py:191-217``, the same semantics).  A metric
    the artifact lacks is never flagged; ``committed`` is the prior report
    dict, or None on a first run.  Returns (violations, bands): ``bands``
    records what each metric was held against."""
    prior = {r["metric"]: r["value"] for r in (committed or {}).get("results", [])}
    violations, bands = [], {}
    for r in results:
        base = prior.get(r["metric"])
        if base is None:
            continue
        floor = round(base * (1.0 - tolerance), 1)
        bands[r["metric"]] = {"committed": base, "floor": floor}
        if r["value"] < floor:
            violations.append({
                "metric": r["metric"], "value": r["value"],
                "committed": base, "floor": floor,
                "drop_pct": round(100.0 * (1.0 - r["value"] / base), 1),
            })
    return violations, bands


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("multi-stage bench suite (PyTorch / CUDA)")
    p.add_argument("--out", default=B.SUITE)
    p.add_argument("--tolerance", type=float, default=0.10,
                   help="max allowed fractional drop vs the committed artifact before the run FAILS (default 10%%)")
    p.add_argument("--accept-regression", action="store_true",
                   help="write the artifact and exit 0 even with violations (explicit re-baselining; the "
                        "violation list still lands in the artifact for the record)")
    p.add_argument("--device", default="cuda", help="torch device; 'cuda' fails when no GPU is present")
    args = p.parse_args(argv)

    dev = B.resolve(args.device)
    committed = B.read_json(args.out)
    results = []
    for fn in (bench_pretrain,
               lambda device: bench_consistency("fused", device=device),
               lambda device: bench_consistency("fast", device=device),
               bench_finetune,
               bench_serving):
        r = fn(device=args.device)
        print(json.dumps(r), flush=True)
        results.append(r)

    violations, bands = check_bands(results, committed, args.tolerance)
    report = {
        "platform": B.platform_of(dev),
        "results": results,
        "bands": {"tolerance": args.tolerance, **bands},
        "violations": violations,
        "notes": "chained steps (K = 8 a chunk, CUDA-graph replays) and forwards with one scalar fetch of the "
                 "last output at the end, host clock; bf16.  `bands` holds the previously committed values this "
                 "run was guarded against; a nonempty `violations` fails the run.",
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"-> {args.out}", flush=True)
    if violations:
        print(f"REGRESSION vs committed artifact (tolerance {args.tolerance:.0%}):", flush=True)
        for v in violations:
            print(f"  {v['metric']}: {v['value']} < floor {v['floor']} (committed {v['committed']}, "
                  f"-{v['drop_pct']}%)", flush=True)
        if not args.accept_regression:
            sys.exit(1)
    return report


if __name__ == "__main__":
    main()
