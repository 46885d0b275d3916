"""The reader of ``h2d_pinned_share.train`` on synthetic counters: pinned
bytes over all bytes copied, and nothing read from a program that counts
no pinned bytes, from a run without a trace or from a program without the
recorder."""

import types

import pytest

from benchmark import harness
from cp360_tpu_torch.utils import profiling

METRIC = "h2d_pinned_share.train"


def _read(traced=True):
    cell = next(m for m in harness.benchmark_json()["per_layer"]
                if m["name"] == METRIC)["workloads"][0]
    run = harness.load_run(cell, 1, 1.0, True, "none")
    run.tracer = types.SimpleNamespace(t0=0.0)
    trace = harness.Trace(0.0, 1e6, [], []) if traced else None
    return harness.load_metric_reader(METRIC)(harness.MetricContext(run, trace))


@pytest.fixture(autouse=True)
def store():
    profiling.clear()
    yield profiling.STORE
    profiling.clear()


@pytest.mark.parametrize("pinned,total,share", [
    ((100, 300), (100, 300), 100.0),  # every batch pinned
    ((100, 0), (100, 300), 25.0),  # the second batch pageable
    ((0, 0), (100, 300), 0.0),  # the mechanism did not engage
], ids=["all", "part", "none"])
def test_pinned_share_is_pinned_over_all_bytes(pinned, total, share):
    for p, t in zip(pinned, total):
        profiling.STORE.count("h2d.bytes", t)
        profiling.STORE.count("h2d.pinned_bytes", p)
    assert _read() == pytest.approx(share)


def test_pinned_share_reads_nothing_from_nothing(monkeypatch):
    assert _read() is None  # nothing counted
    profiling.STORE.count("h2d.bytes", 343)
    assert _read() is None  # a program that counts no pinned bytes
    profiling.STORE.count("h2d.pinned_bytes", 343)
    assert _read() == pytest.approx(100.0)
    assert _read(traced=False) is None
    for name in ("spans", "counters"):  # a program without the recorder
        monkeypatch.delattr(profiling, name)
    assert _read() is None
