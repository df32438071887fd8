"""Benchmark: end-to-end RSP pretraining step throughput on one card.

The port's counterpart of ``bench.py``.  Measures the whole train step at
the reference config of record (``bench.py:45-104``: 256^2 tiles, batch 64
triplets, v1 augmentation pool, SGD-Nesterov lr 0.01 with weight decay):
the fused augmentation kernel (each triplet in its ordering's order,
composed warp, photometric chain, normalize), one backbone pass over the
B*3 views, the classifier, the loss and the update, K = 8 steps a chunk as
the pretrain CLI runs them by default (``parallel.steps.StepGraph``: the
first step eager, each later one a replay of one captured CUDA graph).

Prints the card's name and power limit, then ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, "vs_committed": N}

``vs_baseline`` divides by the rate of the reference's CPU augmentation
pool, measured on this machine's host by ``tools.reference_baseline``
(``reports/baseline_local.json``); without that file there is no
``vs_baseline``.  ``vs_committed`` divides by the pretrain figure of the
committed suite artifact (``tools.bench_suite``, ``reports/bench_suite.json``).

``measure_pretrain`` is the measurement of record: ``tools.bench_suite`` and
``tools.bench_scaling`` call it rather than re-implement it.

    python3 -m ssl_cr_histo_tpu_torch.tools.bench [--device cuda]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import time

import numpy as np

REPORTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "reports")
BASELINE = os.path.join(REPORTS, "baseline_local.json")
SUITE = os.path.join(REPORTS, "bench_suite.json")


def resolve(device: str):
    """The run's torch device, with TF32 off as the stage CLIs set it
    (``cli.common.resolve_device``); SystemExit when CUDA is asked for and
    missing: a measurement on the card never falls back to the CPU."""
    from ssl_cr_histo_tpu_torch.cli.common import resolve_device

    return resolve_device(argparse.Namespace(device=device))


def platform_of(device) -> str:
    """Where a measurement ran: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` gives them, or 'cpu'."""
    import torch

    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        out = None
    if out is None or out.returncode != 0 or not out.stdout.strip():
        return f"{torch.cuda.get_device_name(device)}, power limit not read (nvidia-smi failed)"
    return out.stdout.strip().splitlines()[device.index or 0]


def launch_counts() -> dict:
    """The kernel wrappers' launch counters, by kernel."""
    from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK
    from ssl_cr_histo_tpu_torch.ops import rsp_augment_kernel as RK
    from ssl_cr_histo_tpu_torch.ops import strong_views_kernel as SV

    return {"rsp_augment": RK.launches, "photometric_chain": PK.launches, "strong_views": SV.launches}


def launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launch_counts().items()}


def release(device) -> None:
    """Free what a measurement left, before the next one."""
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def time_chunks(step, chunk: tuple, k: int, iters: int) -> float:
    """Seconds a step of ``step`` (a ``StepGraph``) over ``iters`` chunks of
    ``k`` steps chained with no host sync, after one warm-up chunk (on the
    card: the eager first step, the capture, the replays); a scalar fetch of
    the last loss ends the warm-up and the timed window.  The graph must
    not be captured again inside the window (no LR milestone falls in it)."""
    out = step.run(chunk, k)
    float(out["loss"][-1])
    graph = step.graph
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step.run(chunk, k)
    last = float(out["loss"][-1])
    dt = (time.perf_counter() - t0) / (iters * k)
    if last != last:
        raise FloatingPointError("the loss is NaN")
    if step.graph is not graph:
        raise RuntimeError(f"the {step.name} step was captured again inside the timed window")
    return dt


def measure_pretrain(iters: int = 3, device: str = "cuda", *, model: str = "resnet18", batch_size: int = 64,
                     tile: int = 256, k_steps: int = 8) -> dict:
    """Pretrain-step throughput at the reference config of record, in the
    pretrain CLI's default execution (``--aug_mode fused`` on the kernel,
    joint encode, bf16, ``--multi_step 8``), on ``device``.

    The JAX tool's inputs (``default_rng(0)`` uint8 tiles, each chunk the
    tiles repeated K times) and model (``model`` with the 6-way classifier,
    SGD-Nesterov 0.01, momentum 0.9, weight decay 1e-4; torch seed 0).
    Returns the JAX tool's keys (``metric``, ``value`` = B*3 / step time,
    ``unit``, ``ms_per_step``, ``config``) and ``platform`` and the kernel
    ``launches`` the call made (on the card: one a step, warm-up included,
    replays credited by ``StepGraph``)."""
    import torch

    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train.init import init_triplet_state

    dev = resolve(device)
    before = launch_counts()
    rng = np.random.default_rng(0)
    tiles = (rng.random((batch_size, 3, tile, tile, 3)) * 255).astype(np.uint8)
    tiles = torch.from_numpy(tiles).to(dev)
    torch.manual_seed(0)
    state = init_triplet_state(model, dev, lr=0.01, weight_decay=1e-4)
    gen = torch.Generator(device=dev).manual_seed(0)
    step = S.make_pretrain_multi_step(state, gen, k_steps, augment="v1", aug_mode="fused", joint_encode=True,
                                      bf16=True)
    dt = time_chunks(step, (tiles.expand(k_steps, *tiles.shape),), k_steps, iters)
    del state, step, tiles
    release(dev)
    return {
        "metric": "rsp_pretrain_aug_patches_per_sec_per_chip",
        "value": round(batch_size * 3 / dt, 1),
        "unit": "patches/s/chip",
        "ms_per_step": round(dt * 1000, 2),
        "config": f"{tile}^2 b={batch_size} {model} v1-fused-kernel joint multi_step={k_steps} bf16 (CLI defaults)",
        "platform": platform_of(dev),
        "launches": launches_since(before),
    }


def read_json(path: str):
    """A JSON file's contents, or None when it does not exist."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("RSP pretrain step benchmark (PyTorch / CUDA)")
    p.add_argument("--device", default="cuda", help="torch device; 'cuda' fails when no GPU is present")
    p.add_argument("--baseline", default=BASELINE, help="the reference augmentation's rate (tools.reference_baseline)")
    p.add_argument("--suite", default=SUITE, help="the committed suite artifact (tools.bench_suite)")
    args = p.parse_args(argv)

    r = measure_pretrain(device=args.device)
    print(r["platform"], flush=True)
    out = {"metric": r["metric"], "value": r["value"], "unit": r["unit"]}
    baseline = read_json(args.baseline)
    if baseline is not None:
        out["vs_baseline"] = round(r["value"] / float(baseline["reference_aug_patches_per_sec"]), 2)
    committed = {e["metric"]: e["value"] for e in (read_json(args.suite) or {}).get("results", [])}
    if committed.get(r["metric"]):
        out["vs_committed"] = round(r["value"] / committed[r["metric"]], 3)
    print(json.dumps(out), flush=True)
    return dict(out, measured=r)


if __name__ == "__main__":
    main()
