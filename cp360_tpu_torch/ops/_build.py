"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each source in ``cp360_tpu_torch/csrc/`` compiles on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), for ``sm_90a`` (Hopper).  Libraries go to ``build/cp360_tpu_torch/``
at the root of the checkout, named by a hash of the source and the flags,
and are built at first use: a fresh checkout builds everything on its first
call.  A failed build raises; nothing falls back to the plain versions.

Builds are safe across processes (several ranks of one job load the
kernels at once): each target has a file lock beside it, taken before
nvcc runs and held until the library is in place, nvcc writes to a
temporary name that is renamed into place, and a process that finds the
library built once it holds the lock does not build it again.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cp360_tpu_torch"
SOURCES = ("cube_conv3x3", "equi_to_cube", "cube_pool3x3s2")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.RLock()
_libs: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are "
        "compiled at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile the named kernels that are not built yet: one nvcc per
    source, all started together.  Returns {name: compiler output} for the
    ones built now (ptxas prints registers, shared memory and spills)."""
    with _lock:
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        locks = []
        try:
            for name in sorted(todo):  # one order in every process: no deadlock
                lock = open(library_path(name).with_suffix(".lock"), "w")
                locks.append(lock)
                fcntl.flock(lock, fcntl.LOCK_EX)
            # another process may have built some while this one waited
            return _compile([n for n in todo if not library_path(n).exists()], nvcc)
        finally:
            for lock in locks:
                fcntl.flock(lock, fcntl.LOCK_UN)
                lock.close()


def _compile(todo, nvcc: str) -> dict:
    """One nvcc per source, all started together, each into a temporary
    file renamed into place; raises if any failed."""
    procs = {}
    for name in todo:
        so = library_path(name)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, so)
    logs, failed = {}, []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
