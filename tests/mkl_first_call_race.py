"""How often PyTorch's first parallel CPU log comes out inaccurate in a fresh
process, with and without importing the port first.

PyTorch's CPU ``torch.log`` on a contiguous float tensor runs a parallel
loop of 2048-element chunks, each calling MKL's vector math library.  The
library sets itself up on its first call; when several threads make that
first call at once, a chunk can come out off by up to 4e-5 where the log is
exact to 1e-7.  ``ssl_cr_histo_tpu_torch/__init__.py`` makes one such call
on one thread at import.  This script starts fresh processes that take the
log of 16384 values as their first torch call, some after importing the
port, and counts the processes with a chunk over 1e-6 against float64:

    python tests/mkl_first_call_race.py --runs 800 --workers 8

Not a test: the count depends on the host's load (94 of 800 processes without
the import on an 8-core host once), so tests/test_torch_rsp_augment.py
pins the repair with a handful of processes instead.
"""

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = (
    "import json, sys, numpy as np, torch\n"
    "if sys.argv[1] == 'port':\n"
    "    import ssl_cr_histo_tpu_torch\n"
    "x = np.random.default_rng(0).random(16384).astype(np.float32) + 2.0\n"
    "err = np.abs(torch.log(torch.from_numpy(x)).numpy() - np.log(x.astype(np.float64)))\n"
    "print(json.dumps(sorted(set((np.flatnonzero(err > 1e-6) // 2048).tolist()))))\n"
)


def run(mode: str) -> list:
    out = subprocess.run([sys.executable, "-c", CHILD, mode], cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    if out.returncode:
        raise RuntimeError(out.stderr)
    return json.loads(out.stdout)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=400, help="fresh processes per mode")
    ap.add_argument("--workers", type=int, default=8, help="processes at once")
    opts = ap.parse_args()
    for mode in ("torch", "port"):
        with ThreadPoolExecutor(opts.workers) as pool:
            chunks = list(pool.map(run, [mode] * opts.runs))
        bad = [c for c in chunks if c]
        print(f"{mode:5s} first: {len(bad)} of {opts.runs} processes with a chunk off by more than 1e-6 "
              f"(chunks {sorted({i for c in bad for i in c})})", flush=True)


if __name__ == "__main__":
    main()
