"""The readers of the stream entry's decode thread, on a synthetic traced
window and synthetic counters: idle time inside ``stream.decode_wait`` and
not outside it, clipping to the window, 0 where kernels cover the span,
the hit share's arithmetic, and nothing read from a program that records
neither the span nor the counters."""

import types

import pytest

from benchmark import harness
from cp360_tpu_torch.utils import profiling

# microseconds: a window of 1 s; kernels over 0.1-0.3 s and 0.25-0.4 s
# (overlapping), a copy over 0.5-0.7 s (not busy)
DEVICE = [("k1", 100e3, 200e3, "kernel"), ("k2", 250e3, 150e3, "kernel"),
          ("Memcpy HtoD", 500e3, 200e3, "gpu_memcpy")]
WAIT = "decode_wait_idle_share.stream"
HIT = "decode_hit_share.stream"
SPAN = "stream.decode_wait"
T0 = 1000.0  # the tracer's start on the host's perf_counter clock, seconds


def _read(metric, host=(), traced=True):
    cell = next(m for m in harness.benchmark_json()["per_layer"]
                if m["name"] == metric)["workloads"][0]
    run = harness.load_run(cell, 1, 1.0, True, "none")
    run.tracer = types.SimpleNamespace(t0=T0)
    trace = harness.Trace(0.0, 1e6, list(DEVICE), list(host)) if traced else None
    return harness.load_metric_reader(metric)(harness.MetricContext(run, trace))


@pytest.fixture(autouse=True)
def store():
    profiling.clear()
    yield profiling.STORE
    profiling.clear()


@pytest.mark.parametrize("host,share", [
    # 0.35-0.6 s: idle from 0.4 s; 0-0.05 s: idle throughout; the rest is
    # idle in no span of this metric
    ([(SPAN, 350e3, 250e3), (SPAN, 0.0, 50e3), ("stream.decode", 400e3, 600e3),
      ("other.span", 0.0, 1e6)], 25.0),
    # clipped to the window: 0.9-1.0 and 0-0.02 count
    ([(SPAN, 900e3, 400e3), (SPAN, -200e3, 220e3)], 12.0),
    # kernels cover the span
    ([(SPAN, 120e3, 80e3), (SPAN, 260e3, 140e3)], 0.0),
], ids=["inside-only", "clipped", "covered"])
def test_decode_wait_idle_share(host, share):
    assert _read(WAIT, host=host) == pytest.approx(share)


def test_decode_wait_idle_share_reads_nothing_without_the_span_or_the_trace():
    assert _read(WAIT, host=[("stream.decode", 0.0, 1e6)]) is None
    assert _read(WAIT, host=[(SPAN, 0.0, 1e6)], traced=False) is None


def test_decode_hit_share_is_ready_over_taken():
    profiling.STORE.count("stream.decode_taken", 30)
    profiling.STORE.count("stream.decode_taken", 10)
    profiling.STORE.count("stream.decode_ready", 30)
    profiling.STORE.count("stream.decode_ready", 0)
    assert _read(HIT) == pytest.approx(75.0)


def test_decode_hit_share_reads_nothing_from_nothing(monkeypatch):
    assert _read(HIT) is None  # nothing counted
    profiling.STORE.count("stream.decode_taken", 8)
    assert _read(HIT) is None  # no ready counter
    profiling.STORE.count("stream.decode_ready", 8)
    assert _read(HIT) == pytest.approx(100.0)
    assert _read(HIT, traced=False) is None
    for name in ("spans", "counters"):  # a program without the recorder
        monkeypatch.delattr(profiling, name)
    assert _read(HIT) is None
