"""Environment diagnostics for the port:
``python -m cp360_tpu_torch.cli.doctor [--skip-device | --require-device]``.

The port's form of ``cp360_tpu/cli/doctor.py``.  The failure modes of a
run on the card are environmental: no CUDA toolkit (the kernels are built
with nvcc at first use), a kernel that does not build, a card that does
not answer, a missing video codec, a collective backend this torch lacks.
Every check that touches the toolkit or the card runs in a bounded
subprocess, so a hung build or device cannot hang the doctor.

Host checks: versions (python, torch, CUDA, cuDNN, numpy, cv2), the config,
the data splits, the video codecs, the flow backends (cv2's and the port's
two torch solvers) and the distributed backends (gloo, joined at world
size 1 in a subprocess; NCCL where this torch has it).  Device checks
(left out by ``--skip-device``): nvcc, the three kernel builds, and the
device probe (a bf16 matmul on the card, one launch of each kernel held
against its plain version, and where torch has NCCL, a world-size-1 NCCL
all-reduce on the card).

Prints one line per check and a JSON summary last; exits 0 when the host
checks pass, and with ``--require-device`` only when the device checks
pass too.  The JAX doctor's TPU probes (compile cache, native loader,
transfer tunnel) have no counterpart here.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_BUILD = """
import sys
sys.path.insert(0, sys.argv[1])
from cp360_tpu_torch.ops import _build
logs = _build.build()
print("DOCTOR_BUILD", ",".join(sorted(logs)) or "cached", ",".join(_build.SOURCES))
"""

_DEVICE_PROBE = """
import os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
if not torch.cuda.is_available():
    sys.exit("no CUDA device available to torch")
t0 = time.time()
x = torch.randn(512, 512, device="cuda").to(torch.bfloat16)
(x @ x).float().sum().item()
t_mm = time.time() - t0
from cp360_tpu_torch.ops import cube_conv, cube_pool, equi_gather
gen = torch.Generator(device="cuda").manual_seed(0)
errs = {}
a = torch.randn(2, 6, 7, 7, 16, generator=gen, device="cuda")
w = torch.randn(3, 3, 16, 24, generator=gen, device="cuda") * 0.1
b = torch.randn(24, generator=gen, device="cuda")
errs["cube_conv3x3"] = (cube_conv.cube_conv3x3(a, w, b)
                        - cube_conv.cube_conv3x3_plain(a.cpu(), w.cpu(), b.cpu()).cuda())
dy = torch.randn(2, 6, 7, 7, 24, generator=gen, device="cuda")
errs["cube_conv3x3_dx"] = (cube_conv.cube_conv3x3_dx(dy, w)
                           - cube_conv.cube_conv3x3_dx_plain(dy.cpu(), w.cpu()).cuda())
frames = torch.randint(0, 256, (1, 64, 128, 3), generator=gen, device="cuda",
                       dtype=torch.uint8)
errs["equi_to_cube"] = (equi_gather.equi_to_cube(frames, 32)
                        - equi_gather.equi_to_cube_plain(frames.cpu(), 32).cuda())
p = torch.randn(1, 6, 16, 16, 8, generator=gen, device="cuda")
errs["cube_pool3x3s2"] = (cube_pool.cube_pad_max_pool_3x3s2(p)
                          - cube_pool.cube_pad_max_pool_3x3s2_plain(p.cpu()).cuda())
bad = {k: float(e.abs().max()) for k, e in errs.items() if float(e.abs().max()) > 1e-3}
if bad:
    sys.exit(f"kernels disagree with their plain versions: {bad}")
nccl = "no nccl in this torch"
import torch.distributed as dist
if dist.is_nccl_available():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    t = torch.ones(4, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    dist.destroy_process_group()
    nccl = "nccl all_reduce ok"
print(f"DOCTOR_PROBE device={torch.cuda.get_device_name(0)} n={torch.cuda.device_count()} "
      f"matmul_s={t_mm:.1f} kernels={len(errs)} ({nccl})")
"""

_GLOO = """
import socket, torch, torch.distributed as dist
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
t = torch.ones(3)
dist.all_reduce(t)
dist.destroy_process_group()
print("DOCTOR_GLOO", int(t.sum()))
"""


def _check(name, fn):
    t0 = time.time()
    try:
        ok, detail = fn()
    except Exception as e:  # a check must never take the doctor down
        ok, detail = False, f"{type(e).__name__}: {e}"
    print(f"{'ok  ' if ok else 'FAIL'} {name:<22} {detail}", flush=True)
    return {"name": name, "ok": bool(ok), "detail": str(detail),
            "seconds": round(time.time() - t0, 1)}


def _bounded(code: str, tag: str, timeout_s: float):
    """(ok, detail) of ``code`` run by this Python in a subprocess bounded
    by ``timeout_s``: ok when it exits 0 and prints a ``tag`` line."""
    try:
        p = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                           text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return False, f"HUNG > {timeout_s:.0f} s"
    line = next((ln for ln in p.stdout.splitlines() if ln.startswith(tag)), None)
    if p.returncode == 0 and line:
        return True, line.removeprefix(tag).strip()
    tail = ((p.stderr or "").strip().splitlines() or ["no output"])[-1]
    return False, f"rc={p.returncode}: {tail[:200]}"


def _versions():
    import numpy
    import torch

    cv2_v = "missing"
    try:
        import cv2

        cv2_v = cv2.__version__
    except ImportError:
        pass
    cudnn = torch.backends.cudnn.version() if torch.backends.cudnn.is_available() else None
    return True, (f"python {sys.version.split()[0]}, torch {torch.__version__}, "
                  f"CUDA {torch.version.cuda}, cuDNN {cudnn}, numpy {numpy.__version__}, "
                  f"cv2 {cv2_v}")


def _config_loads():
    from cp360_tpu_torch.config import Config, load_config

    path = os.environ.get("CP360_CONFIG", "config.yaml")
    if os.path.exists(path):
        cfg = load_config(path)
        return True, f"{path}: seq_len={cfg.seq_len} cube_dim={cfg.cube_dim}"
    Config()
    return True, f"no {path} here; built-in defaults OK"


def _splits():
    from cp360_tpu_torch.data.dataset import builtin_split

    n = {s: len(builtin_split(s)) for s in ("test_25", "train_60")}
    return n == {"test_25": 25, "train_60": 60}, f"{n} (reference-verbatim lists)"


def _video_codecs():
    import tempfile

    import cv2
    import numpy as np

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "probe.mp4")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5, (64, 32))
        if not w.isOpened():
            return False, "no mp4v encoder in this cv2 build"
        w.write(np.zeros((32, 64, 3), np.uint8))
        w.release()
        cap = cv2.VideoCapture(path)
        ok_r, _ = cap.read()
        cap.release()
    return (True, "mp4 write+decode OK") if ok_r else (False, "mp4 writes but does not decode")


def _flow_backends():
    import cv2

    backends = []
    if hasattr(cv2, "optflow") and hasattr(cv2.optflow, "createOptFlow_DeepFlow"):
        backends.append("deepflow")  # the reference's backend where present
    if hasattr(cv2, "calcOpticalFlowFarneback"):
        backends.append("farneback")
    # the port's two torch solvers need no host library
    backends += ["horn_schunck (device)", "variational (device)"]
    ok = any(not b.endswith("(device)") for b in backends)
    return ok, f"flow backends: {', '.join(backends)}"


def _dist_backends(timeout_s: float):
    import torch.distributed as dist

    if not dist.is_gloo_available():
        return False, "this torch has no gloo (the CPU and shared-card collectives)"
    ok, detail = _bounded(_GLOO, "DOCTOR_GLOO", timeout_s)
    nccl = "nccl available" if dist.is_nccl_available() else "no nccl in this torch"
    return ok, f"gloo world-size-1 all_reduce {'ok' if ok else detail}; {nccl}"


def _nvcc():
    from cp360_tpu_torch.ops import _build

    path = _build.nvcc_path()
    out = subprocess.run([path, "--version"], capture_output=True, text=True, timeout=60)
    release = next((ln.strip() for ln in out.stdout.splitlines() if "release" in ln), "")
    return out.returncode == 0, f"{path}: {release}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cp360_tpu_torch.cli.doctor",
                                 description="environment diagnostics")
    ap.add_argument("--require-device", action="store_true",
                    help="exit nonzero unless nvcc, the kernel builds and the device probe pass")
    ap.add_argument("--probe-timeout", type=float, default=240.0,
                    help="seconds before a build or the device probe is declared hung")
    ap.add_argument("--skip-device", action="store_true",
                    help="host-only checks (no toolkit, no card)")
    args = ap.parse_args(argv)
    if args.require_device and args.skip_device:
        ap.error("--require-device and --skip-device are contradictory: "
                 "the device gate would pass without ever probing")

    host = [
        _check("versions", _versions),
        _check("config", _config_loads),
        _check("data splits", _splits),
        _check("video codecs", _video_codecs),
        _check("flow backends", _flow_backends),
        _check("distributed backends", lambda: _dist_backends(args.probe_timeout)),
    ]
    device = []
    if not args.skip_device:
        device.append(_check("nvcc", _nvcc))
        device.append(_check("kernel builds",
                             lambda: _bounded(_BUILD, "DOCTOR_BUILD", args.probe_timeout)))
        device.append(_check("device", lambda: _bounded(_DEVICE_PROBE, "DOCTOR_PROBE",
                                                        args.probe_timeout)))
    host_ok = all(c["ok"] for c in host)
    device_ok = all(c["ok"] for c in device) if device else None
    ok = host_ok and (device_ok if args.require_device else True)
    print(json.dumps({"ok": ok, "host_ok": host_ok, "device_ok": device_ok,
                      "checks": host + device}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
