"""The port's doctor (``cp360_tpu_torch/cli/doctor.py``) on this CPU box:
the port's form of tests/test_doctor.py."""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
HOST_CHECKS = ["versions", "config", "data splits", "video codecs", "flow backends",
               "distributed backends"]


def _run(args, timeout=240):
    return subprocess.run([sys.executable, "-m", "cp360_tpu_torch.cli.doctor", *args],
                          capture_output=True, text=True, timeout=timeout, cwd=REPO)


def _summary(p):
    lines = p.stdout.strip().splitlines()
    assert lines and lines[-1].startswith("{"), p.stdout + p.stderr  # the JSON comes last
    assert sum(ln.startswith("{") for ln in lines) == 1
    return json.loads(lines[-1])


def test_doctor_host_checks_pass():
    p = _run(["--skip-device"])
    s = _summary(p)
    assert p.returncode == 0 and s["ok"] and s["host_ok"], p.stdout + p.stderr
    assert s["device_ok"] is None
    assert [c["name"] for c in s["checks"]] == HOST_CHECKS
    assert all(c["ok"] for c in s["checks"])
    dist = s["checks"][-1]["detail"]
    assert "gloo world-size-1 all_reduce ok" in dist
    assert ("nccl available" if torch.distributed.is_nccl_available()
            else "no nccl in this torch") in dist


def test_doctor_require_device_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _run(["--require-device", "--probe-timeout", "60"])
    s = _summary(p)
    assert p.returncode == 1 and s["host_ok"] and s["device_ok"] is False
    names = [c["name"] for c in s["checks"]]
    assert names == HOST_CHECKS + ["nvcc", "kernel builds", "device"]
    device = s["checks"][-1]
    assert not device["ok"] and "no CUDA device" in device["detail"]
    # without --require-device the doctor reports the device and exits 0
    p2 = _run(["--probe-timeout", "60"])
    s2 = _summary(p2)
    assert p2.returncode == 0 and s2["ok"] and s2["device_ok"] is False


def test_doctor_rejects_contradictory_flags():
    p = _run(["--require-device", "--skip-device"])
    assert p.returncode == 2 and "contradictory" in p.stderr
