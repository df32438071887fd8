"""Run one cell of the port's benchmark once and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``port_bench/``
and the port, ``ssl_cr_histo_tpu_torch``, on a machine with an NVIDIA card.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file, its mix ``port_bench/mixes/<traffic>.json`` (whose
``stage`` names the driver ``port_bench/stages/<stage>.py``), its limits
``port_bench/limits/<cell>.json`` and each metric's reader
``port_bench/metrics/<name>.py`` (the metric's name with ``.`` and ``-``
as ``_``).  A run: set-up (the program's imports, data, weights, the first
chunk of steps, which builds the kernels and captures the graph), the
measured window of ``--seconds``, with ``--trace 1`` a profiled stretch of
chunks after it, the peak memory, the program's state freed, then the
reference's check of the first steps.  The last lines of standard error
give each compared number beside its limit; the last line of standard
output is the result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

_T_IMPORTED = time.time()
JAX_NAMES = ("jax", "jaxlib", "flax", "ssl_cr_histo_tpu")
# the kernel caches beside the benchmark's own directory (under build/):
# the port's kernel libraries, torch's extensions, Triton's cache
KERNEL_CACHES = ("torch_kernels", "torch_extensions", "triton")


def process_start() -> float:
    """The wall-clock time this process started, from /proc (0.01 s
    ticks), or this module's import where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T_IMPORTED


def metric_module(name: str):
    return importlib.import_module("port_bench.metrics." + name.replace(".", "_").replace("-", "_"))


def resolve(bench: dict, workload: str) -> dict:
    """The cell ``workload`` with its configuration, mix, limits and
    metrics, read from the files its names point to."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(entry["file"]) as f:
        cfg = json.load(f)
    with open(os.path.join("port_bench", "mixes", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    with open(os.path.join("port_bench", "limits", f"{workload}.json")) as f:
        limits = json.load(f)
    mine = lambda ms: [m for m in ms if workload in m.get("workloads", [workload])]
    return {"cell": cell, "cfg": cfg, "traffic": traffic, "limits": limits,
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def query_card(fields: str, device_index: int = 0) -> str:
    """One line of ``nvidia-smi --query-gpu=<fields>`` for the card, or why
    there is none."""
    try:
        smi = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
        return smi[device_index] if smi else "nvidia-smi printed nothing"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def host_lines(device_index: int = 0) -> list:
    """The card's name and power limit, its clocks, temperature and draw as
    the window closes, the host's CPU model and cores.  Read after the
    window, so that no ``nvidia-smi`` runs in set-up."""
    card = query_card("name,power.limit", device_index)
    clocks = query_card("clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu,power.draw", device_index)
    model = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f if line.startswith("model name")), model)
    except OSError:
        pass
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    return [f"card: {card}", f"card as the window closed (SM clock, its max, memory clock, temperature, draw): "
            f"{clocks}", f"host: {model}, {os.cpu_count()} cores, {cores} usable by this process"]


def cache_files(root: str) -> set:
    """(directory, file) of every file under the benchmark's own directory
    ``root`` and the kernel caches beside it."""
    found = set()
    for top in [root] + [os.path.join(os.path.dirname(root), sub) for sub in KERNEL_CACHES]:
        for d, _, files in os.walk(top):
            found.update((os.path.basename(top), os.path.join(d, f)) for f in files)
    return found


def jax_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(JAX_NAMES))


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, root: str, t0: float,
             marks: list = None) -> dict:
    """One run of the resolved cell on ``device``; returns the result
    line's fields and the compared numbers.  ``marks`` are (name, time)
    of set-up's steps before the stage's; the stage adds its own."""
    import torch

    from port_bench import compare

    traffic = spec["traffic"]
    stage_cls = importlib.import_module(f"port_bench.stages.{traffic['stage']}").Stage
    stage = stage_cls(spec["cfg"], traffic, seed, device, root)
    before = cache_files(root)
    stage.marks = [("start", t0)] + list(marks or [])
    stage.setup()
    setup_s = time.time() - t0
    # what set-up built or wrote: something only on a checkout's first run
    built = sorted({top for top, _ in cache_files(root) - before})
    win = stage.window(seconds)
    profile = stage.traced(traffic["trace_chunks"]) if trace else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    stage.release()
    ctx = {"stage": traffic["stage"], "traffic": traffic, "cfg": spec["cfg"], "setup_s": setup_s, "window": win,
           "work_per_step": stage.work_per_step, "flops_per_step": stage.flops_per_step, "trace": profile}
    wanted = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in wanted:
        value = metric_module(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, rows = compare.verdict(stage.check(), spec["limits"])
    return {"correct": correct, "attempted": win["steps"], "failed": win["failed"], "metrics": metrics,
            "peak": peak, "profile": profile, "rows": rows, "window": win, "setup_s": setup_s,
            "built": built, "marks": stage.marks + [("set-up end", t0 + setup_s)]}


def main(argv=None) -> int:
    t0 = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    with open("BENCHMARK.json") as f:
        spec = resolve(json.load(f), args.workload)
    root = os.path.join(os.getcwd(), "build", "port_bench")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(os.getcwd(), "build", sub)

    marks = [("python", _T_IMPORTED)]
    import torch

    marks.append(("torch import", time.time()))
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.empty(1, device=device)
    marks.append(("cuda context", time.time()))
    for line in [f"seed: {args.seed}, seconds: {args.seconds}, trace: {args.trace}",
                 f"cell: {json.dumps(spec['cell'])}", f"config: {json.dumps(spec['cfg'])}",
                 f"mix: {json.dumps(spec['traffic'])}"]:
        print(line, flush=True)
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), device, root, t0, marks)
    for line in host_lines():
        print(line, flush=True)
    steps = out["marks"]
    print("set-up steps (s): " + ", ".join(f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(steps, steps[1:])),
          flush=True)
    print(f"set-up built into the checkout's caches: {', '.join(out['built']) or 'nothing'} "
          f"(first run in this checkout: {bool(out['built'])})", flush=True)
    found = jax_loaded()
    if found:
        print(f"port_bench: JAX modules loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 3
    win = out["window"]
    print(f"window: {win['steps']} steps in {win['wall_s']:.6f} s, feed next() {win['feed_wait_s']:.6f} s "
          f"({win['drained_wait_s']:.6f} s of it after a read-back); "
          f"set-up {out['setup_s']:.6f} s; peak {out['peak']} bytes", flush=True)
    if args.trace:
        prof = out["profile"] or {}
        print(f"traced stretch: busy {prof.get('busy_s')} s of {prof.get('window_s')} s, launch calls a step "
              f"{prof.get('launches_per_step')}, rsp_augment launches {prof.get('rsp_augment_launches')} by its "
              f"counter, {sum(v for k, v in prof.get('kernel_count', {}).items() if 'rsp_augment' in k)} in the trace",
              flush=True)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                   "memory_peak_bytes": int(out["peak"])}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": device_info, "first_in_checkout": bool(out["built"])}
    if args.trace:
        prof = out["profile"] or {}
        device_info.update(busy_s=prof.get("busy_s", 0.0), window_s=prof.get("window_s", 0.0))
        line["breakdown"] = {"device_ops": prof.get("device_ops", []), "idle_gaps": prof.get("idle_gaps", [])}
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit, _ in out["rows"]}
    for name, value, limit, detail in out["rows"]:
        print(f"check {name}: {value!r} limit {limit!r} ({detail})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
