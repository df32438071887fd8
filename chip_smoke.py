#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the port's CUDA
kernels, checks each against its plain PyTorch version, drives the
pretraining CLI for one short epoch at the config of record, and times the
step and the kernels.

    python3 chip_smoke.py                    # from the root of a checkout, on a GPU machine
    python3 chip_smoke.py --profile DIR      # also write a torch.profiler table of the step

Phases (any failure exits non-zero and prints no result line):
  1. the card (nvidia-smi name and power limit); no CUDA -> exit 1
  2. build both kernels from csrc/ with nvcc, in parallel, and print each
     build's -Xptxas -v report (registers, shared memory, spills); a kernel
     that spills fails the run
  3. the photometric chain kernel vs its plain version, host-noise mode, at
     (192, 3, 256, 256) and at an odd shape (4, 3, 37, 37): max abs err
     <= 1e-4; Philox mode: deterministic, seed-sensitive, equal to the
     plain Philox chain (<= 1e-4), and N(0, sigma) noise by moments
  4. the fused augmentation kernel vs its plain version at the main path's
     (64, 3, 256, 256, 3) and at (2, 3, 37, 37, 3), params drawn, all gates
     on and all gates off, host noise and Philox, with and without a
     triplet ordering: finite, float32 out within 1e-4, bf16 out within one
     bf16 ulp of the plain float32 result (or 1e-4 where an ulp is
     smaller); the warp plan the kernel computes (``plan_out``) equal to
     ``warp_pass_coefficients`` on the card and on the CPU
  5. main path: a small float32 step on the card must agree with the same
     step on the CPU (plain versions); then ``ssl_cr_histo_tpu_torch.cli.
     pretrain.main`` on two synthetic slides at resnet18 / batch 64 / 256^2 /
     bf16 / joint encode, one epoch, with every launch counter set to 0
     just before and read just after: the fused kernel must launch once per
     train step and the chain kernel never; the checkpoint's float32
     forward on the card must agree with the CPU's
  6. timing with CUDA events, in turns (old, fused, fused, old): the bf16
     step with the fused kernel against the step with the unfused composition
     (plain warp + chain kernel + clip + normalize), the fused kernel
     against that composition alone, the plain versions; the fused kernel's
     time (torch.profiler) in both noise modes and by gate, beside its
     wrapper called back to back; the chain kernel in both noise modes
  7. the kernels line, then ``{"ok": true, "device": {...}}`` as the last line

Imports nothing of JAX and nothing of the JAX package.  Tolerance 1e-4
(phases 3-4) on outputs in [0, 1]: the kernels and PyTorch's CUDA ops
differ by a few ulp in log/exp/division (the special-function forms of
csrc/photometric_common.cuh, whose header states their error budget) and in
FMA contraction.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

TOL = 1e-4
ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("photometric_chain", "rsp_augment")
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
                out_dtype=None, order=None):
    """The unfused composition of the augmentation, kept here to time the step
    against: the uint8 triplet permutation (a gather), uint8 -> float32
    planar copy, the plain two-pass warp, the chain kernel, clip, normalize;
    float32 out (autocast casts it for conv1)."""
    import torch
    from ssl_cr_histo_tpu_torch.ops import batch as TB
    from ssl_cr_histo_tpu_torch.ops import fused
    from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK
    from ssl_cr_histo_tpu_torch.ops import rsp_augment_kernel as RK

    if order is not None:
        triplets_u8 = RK.permute_triplets(triplets_u8, order)
    b, t, h, w, _ = triplets_u8.shape
    imgs = TB.to_float(triplets_u8.reshape(b * t, h, w, 3).permute(0, 3, 1, 2)).contiguous()
    if draws is None:
        draws = TB.draw_rsp_v1(gen, b * t, h)
    warped = fused.pretrain_geo_warp_planar(imgs, draws["geo"])
    out = PK.pretrain_photometric(warped, gen, noise=draws["noise"], params=draws["params"])
    return TB.normalize_batch(torch.clamp(out, 0.0, 1.0).reshape(b, t, 3, h, w), mean, std, channel_axis=2)


def in_turns(fns: dict, order: list, iters: dict, warmup: int = 2) -> dict:
    """CUDA-event ms of each named function, run in the given order;
    returns every run's time per name."""
    t = {}
    for name in order:
        t.setdefault(name, []).append(cuda_ms(fns[name], iters[name], warmup))
    return t


def phase_timing(torch, dev, tiles, card) -> dict:
    """Phase 6.  Returns the kernels' timings for the kernels line."""
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
    print(f"phase 6: pretrain step resnet18 b64 256^2 bf16 joint, in turns old/fused/fused/old: "
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
    print(f"phase 6: one bf16 step: fused kernel launches {launched}, calls {calls}", flush=True)
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
    print(f"phase 6: fused kernel ({b}, 3, {s}, {s}, 3) Philox bf16 out: kernel {kernel * 1e3:.1f} us "
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
    print(f"phase 6: fused kernel host-noise mode: kernel {ni_kernel * 1e3:.1f} us (profiler), plain "
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
    print(f"phase 6: fused kernel by gate (us, profiler): {'; '.join(parts)} [{card}]", flush=True)

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
    print(f"phase 6: photometric chain {shape}: kernel {kernel * 1e3:.1f} us (profiler), "
          f"{ms['kernel'] * 1e3:.1f} us (CUDA events), plain {ms['plain'] * 1e3:.1f} us (Philox mode, "
          f"plain includes its noise), bound {c_ms * 1e3:.1f} us by {c_by}, {c_ms / kernel * 100:.1f}% of it; "
          f"host-noise mode: kernel {ni_kernel * 1e3:.1f} us (profiler), {ms['kernel_ni'] * 1e3:.1f} us "
          f"(CUDA events), plain {ms['plain_ni'] * 1e3:.1f} us, bound {ni_ms * 1e3:.1f} us by {ni_by}, "
          f"{ni_ms / ni_kernel * 100:.1f}% of it [{card}]", flush=True)
    warp_ms = cuda_ms(lambda: fused.pretrain_geo_warp_planar(imgs, mats), iters=5)
    print(f"phase 6: plain warp {shape}: {warp_ms * 1e3:.1f} us [{card}]", flush=True)
    out["photometric_chain"] = {"ms": kernel, "plain_ms": ms["plain"], "bound_ms": c_ms, "bound_by": c_by}
    return out


def phase_profile(torch, dev, tiles, out_dir: str, card: str) -> None:
    """torch.profiler over 3 bf16 steps with the fused kernel after 5
    warm-up steps and 3 timed unprofiled ones: device time by kernel into
    ``out_dir/step_profile.txt``, and the device's busy share, its kernel
    time over the unprofiled steps' wall time."""
    from torch.profiler import ProfilerActivity, profile

    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train.init import init_triplet_state

    torch.manual_seed(0)
    state = init_triplet_state("resnet18", dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(5):
        S.pretrain_step(state, tiles, gen, bf16=True)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(3):
        S.pretrain_step(state, tiles, gen, bf16=True)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            S.pretrain_step(state, tiles, gen, bf16=True)
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in device_events(prof)) / 1e3
    gathers = [f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms" for e in device_events(prof)
               if "gather" in e.key.lower()]
    print(f"profile: device kernels named gather in 3 steps: {gathers or 'none'}", flush=True)
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "step_profile.txt"), "w") as f:
        f.write(f"{card}\n3 steps: device {device_ms:.3f} ms (profiled), wall {wall_ms:.3f} ms "
                f"(3 unprofiled steps just before)\n{table}\n")
    print(f"profile: 3 bf16 steps, device time {device_ms:.3f} ms against {wall_ms:.3f} ms of wall for 3 "
          f"unprofiled steps ({device_ms / wall_ms * 100:.1f}% busy); table in {out_dir}/step_profile.txt "
          f"[{card}]", flush=True)
    print(table, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description="smoke test of the PyTorch port on one NVIDIA GPU")
    ap.add_argument("--profile", default="", help="also profile the step; write the table to this directory")
    opts = ap.parse_args()
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

    # phase 2: build both kernels, one nvcc each, started together
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
        spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores", log))
        print(f"phase 2: {name}: registers a thread {regs}, spill stores {spills} bytes", flush=True)
        check(spills == 0, f"{name}: ptxas reports {spills} bytes of spill stores")

    # phases 3-4: each kernel against its plain version
    from ssl_cr_histo_tpu_torch.ops import fused
    from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK
    from ssl_cr_histo_tpu_torch.ops import rsp_augment_kernel as RK

    print("phase 3: photometric chain kernel vs plain chain", flush=True)
    worst = {"photometric_chain": phase_kernel_vs_plain(PK, torch, dev)}
    print("phase 4: fused augmentation kernel vs plain version", flush=True)
    worst["rsp_augment"] = phase_fused_vs_plain(RK, PK, fused, torch, dev)

    # phase 5: the main path through the CLI
    from ssl_cr_histo_tpu_torch.cli import pretrain
    from ssl_cr_histo_tpu_torch.data import RSPTripletSampler
    from ssl_cr_histo_tpu_torch.models import Classifier, TripletNet, feature_dim

    phase_step_card_vs_cpu(torch)
    steps = 8
    with tempfile.TemporaryDirectory() as tmp:
        slides = write_slides(tmp)
        run = os.path.join(tmp, "run")
        argv = ["--train_image_pth", slides, "--save_dir", run, "--model", "resnet18",
                "--batch_size", "64", "--tile_h", "256", "--tile_w", "256", "--tile_stride", "16",
                "--num_epoch", "1", "--steps_per_epoch", str(steps), "--validation_size", "64",
                "--save_freq", "1", "--index_cache_dir", ""]
        print("phase 5: pretrain CLI " + " ".join(argv), flush=True)
        PK.launches = RK.launches = 0
        t0 = time.time()
        pretrain.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {"photometric_chain": PK.launches, "rsp_augment": RK.launches}
        print(f"phase 5: CLI wall {wall:.2f} s, launches {launches}", flush=True)
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
        # one real batch of triplets for the timing phase
        sampler = RSPTripletSampler(tile=256, stride=16)
        tiles_np = next(sampler.iter_batches(sampler.index_directory(slides, cache_dir=None),
                                             64, seed=0))

    # phase 6: timing
    tiles = torch.from_numpy(np.ascontiguousarray(tiles_np)).to(dev)
    timing = phase_timing(torch, dev, tiles, card)
    if opts.profile:
        phase_profile(torch, dev, tiles, opts.profile, card)

    replaces = {"photometric_chain": "ssl_cr_histo_tpu/ops/pallas_photometric.py:199",
                "rsp_augment": "ssl_cr_histo_tpu/ops/pallas_photometric.py:199"}
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"ssl_cr_histo_tpu_torch/csrc/{name}.cu",
        "replaces": replaces[name],
        "launches": launches[name],
        "max_abs_err": worst[name],
        **timing[name],
        "library_ms": None,
    } for name in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
