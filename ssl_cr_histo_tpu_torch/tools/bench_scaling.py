"""Throughput scaling study: the RSP pretrain step against batch size and
backbone.

The port's counterpart of ``tools/bench_scaling.py``.  ``tools.bench`` pins
the config of record (batch 64, resnet18); this tool measures how the step
scales as the batch on one card grows, and for the resnet50 backbone, to
guide batch sizing.  Each config runs ``bench.measure_pretrain`` at K = 4
steps a chunk, one warm-up chunk and 3 timed ones, in a fresh process, so
that one that runs out of memory cannot spoil the rest; a failed config
prints a FAILED row and makes the run exit 1.

Output: one line per config -- backbone, batch, ms/step, patches/s/chip.

    python3 -m ssl_cr_histo_tpu_torch.tools.bench_scaling [--device cuda]
    python3 -m ssl_cr_histo_tpu_torch.tools.bench_scaling --one resnet50 128 [--device cuda] [--tile 256]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from ssl_cr_histo_tpu_torch.tools import bench as B

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIGS = (
    ("resnet18", 64),
    ("resnet18", 128),
    ("resnet18", 256),
    ("resnet50", 64),
    ("resnet50", 128),
)
TIMEOUT_S = 900  # seconds a config's process may take


def measure(model_name: str, batch_size: int, k_steps: int = 4, iters: int = 3, tile: int = 256,
            device: str = "cuda") -> dict:
    """One config's pretrain step (``tools/bench_scaling.py:20-52``):
    ``bench.measure_pretrain`` at ``model_name`` and ``batch_size``
    triplets of ``tile``^2, ``k_steps`` steps a chunk, ``iters`` timed
    chunks.  Returns model, batch, ms_per_step, patches_per_sec, platform
    and launches."""
    r = B.measure_pretrain(iters, device, model=model_name, batch_size=batch_size, tile=tile, k_steps=k_steps)
    return {
        "model": model_name,
        "batch": batch_size,
        "ms_per_step": round(r["ms_per_step"], 1),
        "patches_per_sec": round(r["value"], 0),
        "platform": r["platform"],
        "launches": r["launches"],
    }


def row(r: dict) -> str:
    return f"{r['model']} b={r['batch']}: {r['ms_per_step']} ms/step, {r['patches_per_sec']:.0f} patches/s/chip"


def one(model_name: str, batch: int, device: str = "cuda", tile: int = 256) -> dict:
    """Measure one config in this process: its result as a JSON line, then
    its row as the last line."""
    r = measure(model_name, batch, tile=tile, device=device)
    print(json.dumps(r), flush=True)
    print(row(r), flush=True)
    return r


def main(argv=None) -> list:
    p = argparse.ArgumentParser("pretrain step scaling over batch and backbone (PyTorch / CUDA)")
    p.add_argument("--one", nargs=2, metavar=("MODEL", "BATCH"), help="measure one config in this process")
    p.add_argument("--device", default="cuda", help="torch device; 'cuda' fails when no GPU is present")
    p.add_argument("--tile", type=int, default=256)
    args = p.parse_args(argv)
    if args.one:
        return [one(args.one[0], int(args.one[1]), args.device, args.tile)]

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    results, failed = [], []
    for model_name, batch in CONFIGS:
        cmd = [sys.executable, "-m", "ssl_cr_histo_tpu_torch.tools.bench_scaling", "--one", model_name, str(batch),
               "--device", args.device, "--tile", str(args.tile)]
        try:
            proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
            lines = proc.stdout.strip().splitlines()
            err = (proc.stderr.strip().splitlines() or ["?"])[-1]
            ok = proc.returncode == 0 and len(lines) >= 2
        except subprocess.TimeoutExpired:
            ok, err = False, f"no result in {TIMEOUT_S} s"
        if ok:
            results.append(json.loads(lines[-2]))
            print(lines[-1], flush=True)
        else:
            failed.append((model_name, batch))
            print(f"{model_name} b={batch}: FAILED ({err})", flush=True)
    if failed:
        sys.exit(f"{len(failed)} of {len(CONFIGS)} configs failed: {failed}")
    return results


if __name__ == "__main__":
    main()
