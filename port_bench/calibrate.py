"""The readings that a cell's limits are set from (not part of a run).

    python3 -m port_bench.calibrate --workload <cell> --what program|control|half|bf16ref --seeds 1,2,3

``program``: the program's set-up and first steps on each seed, then the
reference's check, as a run makes them without its window: the lower
readings.  ``control``: the reference in the program's place, under
bfloat16 autocast as the program runs, with every tensor the program keeps
in bfloat16 rounded to float8 (e4m3 forward, e5m2 backward, a scale per
tensor), against the reference: the upper readings.  ``half``: the
reference with half of each step's batch left out (the mean over the
rest), against the reference: a fault the numbers have to catch.
``bf16ref``: the reference under bfloat16 autocast, as the program runs,
against the reference: what bfloat16's rounding alone reads.  One JSON
line a seed, then the largest and smallest of each number.  Runs on the
card (``--device cuda``) or, at small mixes (``--mix``), on the CPU.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time


def readings(stage, what: str) -> dict:
    from port_bench import compare
    from port_bench.reference import nets

    if what == "program":
        stage.setup()
        stage.release()
        return {k: v[0] for k, v in stage.check().items()}
    stage.prepare()
    ref = stage.reference()
    if what == "control":
        other = stage.reference(quant=nets.fp8_train, bf16=True)
    elif what == "bf16ref":
        other = stage.reference(bf16=True)
    elif what == "half":
        other = stage.reference(rows=stage.traffic[stage.batch_key] // 2)
    else:
        raise SystemExit(f"unknown --what {what!r}")
    return {k: v[0] for k, v in compare.training_gaps(other, ref).items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--what", required=True, choices=("program", "control", "half", "bf16ref"))
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--device", default="cuda")
    p.add_argument("--mix", default="", help="JSON of mix parameters to override (small CPU rehearsals)")
    args = p.parse_args(argv)

    import torch

    from port_bench.run import host_lines, resolve

    with open("BENCHMARK.json") as f:
        spec = resolve(json.load(f), args.workload)
    traffic = dict(spec["traffic"], **json.loads(args.mix or "{}"))
    device = torch.device(args.device)
    if device.type == "cuda":
        print("\n".join(host_lines()), flush=True)
    stage_cls = importlib.import_module(f"port_bench.stages.{traffic['stage']}").Stage
    root = os.path.join(os.getcwd(), "build", "port_bench")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        r = readings(stage_cls(spec["cfg"], traffic, seed, device, root), args.what)
        rows.append(r)
        print(json.dumps({"what": args.what, "seed": seed, "seconds": round(time.time() - t, 3), **r}), flush=True)
    for k in rows[0]:
        vals = [r[k] for r in rows]
        print(f"{args.what} {k}: max {max(vals)!r} min {min(vals)!r} over {len(vals)} seeds", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
