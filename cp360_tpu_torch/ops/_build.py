"""Builds the port's native code and loads it with ctypes.

Each source in ``cp360_tpu_torch/csrc/`` compiles on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds): the CUDA kernels (``SOURCES``) with nvcc for ``sm_90a`` (Hopper),
the host batch ``.npy`` loader (``HOST_SOURCES``) with g++, which needs no
CUDA toolkit.  Libraries go to ``build/cp360_tpu_torch/`` at the root of the
checkout, named by a hash of the source and the flags, and are built at
first use: a fresh checkout builds everything on its first call.  A failed
build raises with the compiler's output; nothing falls back to the plain
versions.  A cached library that does not load is built again once.

Builds are safe across processes (several ranks of one job load the
kernels at once): each target has a file lock beside it, taken before the
compiler runs and held until the library is in place, the compiler writes
to a temporary name that is renamed into place, and a process that finds
the library built once it holds the lock does not build it again.
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
SOURCES = ("cube_conv3x3", "equi_to_cube", "cube_pool3x3s2", "conv_epilogue",
           "cube_dwconv")  # CUDA kernels
HOST_SOURCES = ("npy_loader",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

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


def gxx_path() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found on PATH: the port's batch .npy loader "
                       "(csrc/npy_loader.cpp) is compiled at first use")


def _toolchain(name: str):
    """(source, compiler lookup, flags) of the target ``name``."""
    if name in HOST_SOURCES:
        return CSRC / f"{name}.cpp", gxx_path, GXX_FLAGS
    return CSRC / f"{name}.cu", nvcc_path, NVCC_FLAGS


def library_path(name: str) -> Path:
    src, _, flags = _toolchain(name)
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile the named targets that are not built yet: one compiler per
    source, all started together.  Returns {name: compiler output} for the
    ones built now (ptxas prints registers, shared memory and spills)."""
    with _lock:
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compilers = {n: _toolchain(n)[1]() for n in todo}
        locks = []
        try:
            for name in sorted(todo):  # one order in every process: no deadlock
                lock = open(library_path(name).with_suffix(".lock"), "w")
                locks.append(lock)
                fcntl.flock(lock, fcntl.LOCK_EX)
            # another process may have built some while this one waited
            return _compile([n for n in todo if not library_path(n).exists()], compilers)
        finally:
            for lock in locks:
                fcntl.flock(lock, fcntl.LOCK_UN)
                lock.close()


def _compile(todo, compilers: dict) -> dict:
    """One compiler per source, all started together, each into a
    temporary file renamed into place; raises if any failed."""
    procs = {}
    for name in todo:
        src, _, flags = _toolchain(name)
        so = library_path(name)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [compilers[name], *flags, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, so, src)
    logs, failed = {}, []
    for name, (proc, tmp, so, src) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{Path(compilers[name]).name} failed for {src.name} "
                          f"(exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            path = library_path(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:
                # a cached library that does not load (a truncated file) is
                # built again, once; unlinking leaves a mapped copy intact
                path.unlink(missing_ok=True)
                build((name,))
                lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
