"""Capture a ``torch.profiler`` trace of a train step, as the stage CLIs run it.

The port's counterpart of ``tools/profile_step.py``.  Builds the requested
stage's ``parallel.steps.make_*_multi_step`` step at a given config (bf16
autocast, the JAX tool's optimizers and heads, ``--multi_step`` K steps a
dispatch, the CLIs' default 8) fed by the CLIs' ``cli.common.chunked_feed``,
runs its warm steps (the first, eager step builds kernels and picks cuDNN's
algorithms; on the card the second captures the CUDA graph), then traces
``--steps`` steps into ``--logdir`` (``utils.profiling.trace``; view with
TensorBoard or chrome://tracing) and prints ms/step, timed inside the trace
window up to a synchronize, the ten operations that took the most device
time (on the CPU: self CPU time), the port's spans a step (``span_times``:
each ``port.`` span's host time and the card's idle time inside it) and
the feed's and the step's counters, the consistency views kernel's
launches (``ops/strong_views_kernel.py``) and, for a ViT, its attention
calls by SDPA backend (``models/vit.py``) over the traced steps.

    python3 -m ssl_cr_histo_tpu_torch.tools.profile_step --stage consistency --batch_size 16 \\
        --logdir TRACE_DIR [--multi_step 8] [--steps 16] [--device cpu]
"""

from __future__ import annotations

import argparse
import bisect
import glob
import itertools
import json
import os
import time

import numpy as np

# the trace's categories of the card's work: its kernels and copies
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "port."


def build_step(args, device) -> tuple:
    """(the stage's ``StepGraph`` at ``args.multi_step``, one host batch:
    the tuple of arrays the stage's feed yields a step, the trained
    TripletNet), on seeded random
    uint8 inputs (the JAX tool's ``default_rng(0)`` data, torch seed 0
    weights, augmentation draws from generators seeded 1).  pretrain:
    TripletNet + 6-way classifier, SGD-Nesterov 0.01, v1 augmentation in
    ``--aug_mode``, joint encode; finetune: 9-way head, Adam 1e-4;
    consistency: 2-way head, SGD-Nesterov 5e-4, a teacher equal to the
    student, ``--mu`` unlabeled images a labeled one, NAug 7."""
    import torch

    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train import optim
    from ssl_cr_histo_tpu_torch.train.init import init_finetune_state, init_teacher, init_triplet_state

    b, size, k = args.batch_size, args.image_size, args.multi_step
    rng = np.random.default_rng(0)
    u8 = lambda *shape: (rng.random(shape) * 255).astype(np.uint8)
    torch.manual_seed(0)
    gen = torch.Generator(device=device).manual_seed(1)

    if args.stage == "pretrain":
        state = init_triplet_state(args.model, device, lr=0.01)
        return (S.make_pretrain_multi_step(state, gen, k, aug_mode=args.aug_mode, bf16=True),
                (u8(b, 3, size, size, 3),), state.model)
    if args.stage == "finetune":
        state = init_finetune_state(args.model, 9, device, lambda p: optim.adam(p, 1e-4))
        return (S.make_finetune_multi_step(state, gen, k, "classification", bf16=True),
                (u8(b, size, size, 3), np.arange(b) % 9), state.model)
    state = init_finetune_state(args.model, 2, device, lambda p: optim.sgd_nesterov(p, 5e-4))
    teacher = init_teacher(state)
    host_gen = torch.Generator().manual_seed(1)
    step = S.make_consistency_multi_step(state, teacher, gen, k, "classification", n_aug=7, host_gen=host_gen,
                                         aug_mode=args.aug_mode, bf16=True)
    return step, (u8(b, size, size, 3), np.arange(b) % 2, u8(b * args.mu, size, size, 3)), state.model


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def span_times(events: list, steps: int) -> dict:
    """The port's spans in a trace: ``events``, the ``traceEvents`` of a
    ``torch.profiler`` trace file (complete events, times in us).

    Returns ``window_ms``, from the trace's first event to its last;
    ``device_idle_share``, the share of the window in which the card runs
    none of its kernels and copies (``DEVICE_CATS``: the union of their
    intervals), None where the trace holds none; and ``spans``, for each
    host span named ``port.*``: ``calls``, ``host_ms`` (its time a step,
    over ``steps``), ``idle_ms`` (the time a step inside it with the card
    idle) and ``idle_share`` (that idle time over the window), the last
    two None with no card work in the trace."""
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if not timed:
        return {"window_ms": 0.0, "device_idle_share": None, "spans": {}}
    lo = min(e["ts"] for e in timed)
    hi = max(e["ts"] + e["dur"] for e in timed)
    window = hi - lo
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in timed if e.get("cat") in DEVICE_CATS)
    starts = [a for a, _ in busy]

    def busy_in(a, b):
        i, t = max(bisect.bisect_right(starts, a) - 1, 0), 0.0
        while i < len(busy) and busy[i][0] < b:
            t += max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
        return t

    by_name: dict = {}
    for e in timed:
        if e.get("cat") == "cpu_op" and e.get("name", "").startswith(SPAN_PREFIX):
            by_name.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    spans = {}
    for name, intervals in sorted(by_name.items()):
        covered = _union(intervals)
        host = sum(b - a for a, b in covered)
        idle = sum(b - a - busy_in(a, b) for a, b in covered) if busy else None
        spans[name] = {"calls": len(intervals), "host_ms": host / 1e3 / steps,
                       "idle_ms": None if idle is None else idle / 1e3 / steps,
                       "idle_share": None if idle is None else idle / window}
    idle_share = (1 - sum(b - a for a, b in busy) / window) if busy and window else None
    return {"window_ms": window / 1e3, "device_idle_share": idle_share, "spans": spans}


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


def parse_args(argv=None) -> argparse.Namespace:
    from ssl_cr_histo_tpu_torch.cli.common import add_multi_step_arg
    from ssl_cr_histo_tpu_torch.models import MODEL_NAMES

    p = argparse.ArgumentParser("train-step trace capture (PyTorch / CUDA)")
    p.add_argument("--stage", default="pretrain", choices=["pretrain", "finetune", "consistency"])
    p.add_argument("--logdir", required=True)
    p.add_argument("--model", default="resnet18", choices=MODEL_NAMES)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--mu", type=int, default=7, help="consistency unlabeled multiplier")
    p.add_argument("--steps", type=int, default=3, help="traced steps")
    p.add_argument("--aug_mode", default="fused")
    add_multi_step_arg(p)
    p.add_argument("--device", default="cuda", help="torch device; 'cuda' fails when no GPU is present")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch

    from ssl_cr_histo_tpu_torch.cli.common import chunked_feed, counters_line
    from ssl_cr_histo_tpu_torch.models.vit import attention_calls, attention_line
    from ssl_cr_histo_tpu_torch.ops import strong_views_kernel as SV
    from ssl_cr_histo_tpu_torch.utils.profiling import trace

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available on this machine")
    sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None
    step, batch, model = build_step(args, device)
    k = args.multi_step
    feed = chunked_feed(device, k, itertools.repeat(batch))
    try:
        # warm: the first step is eager; on the card the second captures the graph
        chunk, _ = next(feed)
        m = step.run(chunk, 2 if step.graphed else 1)
        float(m["loss"][0])
        sync()
        before = set(glob.glob(os.path.join(args.logdir, "*.pt.trace.json")))
        counts, fed, views, attn = step.counts(), feed.counters.snapshot(), SV.launches, attention_calls(model)
        with trace(args.logdir) as prof:
            t0 = time.perf_counter()
            left = args.steps
            while left:
                chunk, _ = next(feed)
                n = min(k, left)
                m = step.run(chunk, n)
                left -= n
            float(m["loss"][n - 1])
            sync()  # the optimizer's update runs after the loss: wait for all of it
            dt = (time.perf_counter() - t0) / args.steps
        counters = counters_line(feed, step, counts, fed) + attention_line(model, attn)
        views = SV.launches - views
    finally:
        feed.close()
    (path,) = set(glob.glob(os.path.join(args.logdir, "*.pt.trace.json"))) - before
    with open(path) as f:
        spans = span_times(json.load(f)["traceEvents"], args.steps)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    top = top_ops(prof, device)
    print(f"traced {args.steps} {args.stage} steps ({dt * 1000:.1f} ms/step at --multi_step {k}) -> {path} "
          f"[{where}]")
    print(f"top {len(top)} operations by self {'device' if device.type == 'cuda' else 'CPU'} time:")
    for name, calls, ms in top:
        print(f"  {ms:10.3f} ms  x{calls:<5d} {name[:100]}")
    idle = spans["device_idle_share"]
    print(f"port spans a step (host ms; card idle inside, ms and share of the {spans['window_ms']:.1f} ms "
          f"traced; card idle {'n/a' if idle is None else f'{idle:.1%}'} of it):")
    for name, t in spans["spans"].items():
        inside = "n/a" if t["idle_ms"] is None else f"{t['idle_ms']:10.3f} ms {t['idle_share']:7.1%}"
        print(f"  {name:24s} x{t['calls']:<5d} {t['host_ms']:10.3f} ms  idle {inside}")
    print(f"traced steps: {counters}; strong_views kernel {views} launches")
    return {"stage": args.stage, "multi_step": k, "ms_per_step": dt * 1000, "trace": path, "top": top,
            "spans": spans, "counts": {key: v - counts[key] for key, v in step.counts().items()},
            "feed": {key: v - fed[key] for key, v in feed.counters.snapshot().items()},
            "strong_views_launches": views}


if __name__ == "__main__":
    main()
