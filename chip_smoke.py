#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the port's CUDA
kernel, checks it against its plain PyTorch version, drives the pretraining
CLI for one short epoch at the config of record, and times the step.

    python3 chip_smoke.py        # from the root of a checkout, on a GPU machine

Phases (any failure exits non-zero and prints no result line):
  1. the card (nvidia-smi name and power limit); no CUDA -> exit 1
  2. build the kernel from csrc/ with nvcc
  3. kernel vs plain chain, host-noise mode, at the main path's shape
     (192, 3, 256, 256) and at an odd shape (4, 3, 37, 37): max abs err <= 1e-4
  4. kernel Philox mode: deterministic, seed-sensitive, equal to the plain
     Philox chain (<= 1e-4), and N(0, sigma) noise by moments
  5. main path: a small float32 step on the card must agree with the same
     step on the CPU (plain chain); then ``ssl_cr_histo_tpu_torch.cli.pretrain
     .main`` on two synthetic slides at resnet18 / batch 64 / 256^2 / bf16 /
     joint encode, one epoch; the kernel's launch count over that run must
     cover every train step; the checkpoint's float32 forward on the card
     must agree with the CPU's
  6. timing with CUDA events: pretrain step ms and patches/s, kernel vs plain
  7. the kernels line, then ``{"ok": true, "device": {...}}`` as the last line

Imports nothing of JAX.  Tolerance 1e-4 (phases 3-4): outputs lie in [0, 1];
the kernel and PyTorch's CUDA ops differ by a few ulp in logf/expf/division
(no fast math) and in FMA contraction.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

TOL = 1e-4
ROOT = os.path.dirname(os.path.abspath(__file__))


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


def phase_kernel_vs_plain(PK, torch, dev) -> float:
    """Phases 3 and 4.  Returns the largest error seen."""
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

    main_shape, odd_shape = (192, 3, 256, 256), (4, 3, 37, 37)
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


def main() -> int:
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

    # phase 2: build
    from ssl_cr_histo_tpu_torch.csrc import build

    t0 = time.time()
    build.load_library("photometric_chain")
    print(f"phase 2: built photometric_chain in {time.time() - t0:.2f} s", flush=True)
    print(build.build_log("photometric_chain").rstrip(), flush=True)

    # phases 3-4: kernel against its plain version
    from ssl_cr_histo_tpu_torch.ops import photometric_kernel as PK

    print("phases 3-4: kernel vs plain chain", flush=True)
    worst = phase_kernel_vs_plain(PK, torch, dev)

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
        PK.launches = 0
        t0 = time.time()
        pretrain.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = PK.launches
        print(f"phase 5: CLI wall {wall:.2f} s, photometric kernel launches {launches}", flush=True)
        check(launches >= steps, f"kernel launched {launches} times in {steps} train steps")

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
    from ssl_cr_histo_tpu_torch.ops import fused
    from ssl_cr_histo_tpu_torch.parallel import steps as S
    from ssl_cr_histo_tpu_torch.train.init import init_triplet_state

    torch.manual_seed(0)
    state = init_triplet_state("resnet18", dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    tiles = torch.from_numpy(np.ascontiguousarray(tiles_np)).to(dev)
    losses = []
    step_ms = cuda_ms(lambda: losses.append(S.pretrain_step(state, tiles, gen, bf16=True)["loss"]),
                      iters=20, warmup=5)
    check(all(math.isfinite(float(v)) for v in losses), "non-finite loss in the timed steps")
    patches = 64 * 3 / (step_ms / 1000.0)
    print(f"phase 6: pretrain step resnet18 b64 256^2 bf16 joint: {step_ms:.3f} ms/step, "
          f"{patches:.1f} patches/s [{card}]", flush=True)
    del state

    shape = (192, 3, 256, 256)
    imgs = torch.rand(shape, generator=gen, device=dev)
    params = PK.draw_params(gen, shape[0])
    seeds = PK.draw_seeds(gen, shape[0])
    noise = torch.randn(shape, generator=gen, device=dev)
    kernel = lambda: PK.photometric_chain_cuda(imgs, seeds, params)
    plain = lambda: PK.reference_chain(imgs, params, PK.philox_normal(seeds, shape))
    kernel_ni = lambda: PK.photometric_chain_cuda(imgs, seeds, params, noise)
    plain_ni = lambda: PK.reference_chain(imgs, params, noise)
    t = {}
    for name, fn, iters in (("plain", plain, 5), ("kernel", kernel, 50), ("kernel", kernel, 50),
                            ("plain", plain, 5), ("plain_ni", plain_ni, 5),
                            ("kernel_ni", kernel_ni, 50)):
        t.setdefault(name, []).append(cuda_ms(fn, iters))
    ms = {k: min(v) for k, v in t.items()}
    print(f"phase 6: photometric chain {shape}: kernel {ms['kernel'] * 1e3:.1f} us, plain "
          f"{ms['plain'] * 1e3:.1f} us (Philox mode, plain includes its noise); host-noise mode: "
          f"kernel {ms['kernel_ni'] * 1e3:.1f} us, plain {ms['plain_ni'] * 1e3:.1f} us [{card}]",
          flush=True)
    mats = fused.draw_pretrain_geo_matrices(gen, shape[0], shape[2])
    warp_ms = cuda_ms(lambda: fused.pretrain_geo_warp_planar(imgs, mats), iters=5)
    print(f"phase 6: plain warp {shape}: {warp_ms * 1e3:.1f} us [{card}]", flush=True)

    kernels = [{
        "name": "photometric_chain",
        "route": "cuda",
        "source": "ssl_cr_histo_tpu_torch/csrc/photometric_chain.cu",
        "replaces": "ssl_cr_histo_tpu/ops/pallas_photometric.py:199",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
