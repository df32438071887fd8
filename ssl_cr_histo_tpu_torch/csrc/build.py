"""Compile a kernel source in this directory into a shared library with a
plain C interface and load it with ``ctypes``.

The library is built at first use into ``build/torch_kernels/`` at the root of
the checkout (listed in ``.gitignore``), in a directory keyed by a hash of the
source, of every header of this directory that it includes, and of the
flags, so an edited source or header is rebuilt and an unchanged one is
reused.  No PyTorch headers are included, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time

CSRC = os.path.dirname(os.path.abspath(__file__))
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "torch_kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_loaded: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built on this machine")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str) -> list:
    """``<name>.cu`` and, transitively, every file of this directory it
    includes with ``#include "..."``, in first-seen order."""
    seen, todo = [], [f"{name}.cu"]
    while todo:
        rel = todo.pop(0)
        if rel in seen:
            continue
        seen.append(rel)
        with open(os.path.join(CSRC, rel), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())
                     if os.path.exists(os.path.join(CSRC, m.decode()))]
    return seen


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in sources(name):
        with open(os.path.join(CSRC, rel), "rb") as f:
            h.update(rel.encode() + b"\0" + f.read())
    return os.path.join(BUILD_ROOT, f"{name}-{h.hexdigest()[:16]}", f"lib{name}.so")


def build(name: str) -> str:
    """Compile ``<name>.cu`` unless an up-to-date library exists; return its
    path.  The compiler's report (registers, shared memory, spills) is kept
    in ``build.log`` beside the library."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    out_dir = os.path.dirname(out)
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write(" ".join(cmd) + f"\n# {time.time() - t0:.1f} s\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build(name))
    return _loaded[name]


def build_log(name: str) -> str:
    path = os.path.join(os.path.dirname(library_path(name)), "build.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()

