"""The traced window's arithmetic: the device counts as busy only while a
kernel runs, copies are read apart, and idle gaps are named by the host
operation over them."""

import pytest

from benchmark import harness

# microseconds: a window of 1 s; kernels over 0.1-0.3 s and 0.25-0.4 s
# (overlapping), a copy over 0.5-0.7 s, a set inside the first kernel
DEVICE = [("k1", 100e3, 200e3, "kernel"), ("k2", 250e3, 150e3, "kernel"),
          ("Memcpy HtoD", 500e3, 200e3, "gpu_memcpy"), ("Memset", 120e3, 10e3, "gpu_memset")]
HOST = [("cudaMemcpyAsync", 450e3, 300e3), ("aten::empty", 800e3, 50e3)]


def _trace():
    return harness.Trace(0.0, 1e6, DEVICE, HOST)


def test_busy_counts_kernels_only():
    t = _trace()
    assert t.window_s == pytest.approx(1.0)
    assert t.busy_s() == pytest.approx(0.3)
    assert t.busy_s(("gpu_memcpy",)) == pytest.approx(0.2)
    assert t.busy_s(harness.DEVICE_CATS) == pytest.approx(0.5)


def test_idle_gaps_between_kernels():
    gaps = _trace().idle_gaps()
    assert gaps[0] == ["host: cudaMemcpyAsync", pytest.approx(0.6)]
    assert gaps[1] == ["host: no traced operation", pytest.approx(0.1)]


@pytest.mark.parametrize("name,want", [("idle_share.train", 70.0), ("idle_share.stream", 70.0),
                                       ("copy_share.train", 20.0)])
def test_shares(name, want):
    run = harness.load_run("r50-train", 1, 1.0, True, "none")
    read = harness.load_metric_reader(name)
    assert read(harness.MetricContext(run, _trace())) == pytest.approx(want)
