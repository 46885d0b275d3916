"""The reader of the stage-1 graphs' counter (``stage1_graph_share.stream``)
on synthetic counters: replayed frames over the stage-1 step's frames, and
nothing read from a program that counts neither, or without a trace."""

import types

import pytest

from benchmark import harness
from cp360_tpu_torch.utils import profiling

METRIC = "stage1_graph_share.stream"


def _read(traced=True):
    entry = next(m for m in harness.benchmark_json()["per_layer"] if m["name"] == METRIC)
    run = harness.load_run(entry["workloads"][0], 1, 1.0, True, "none")
    run.tracer = types.SimpleNamespace(t0=0.0)
    trace = harness.Trace(0.0, 1e6, [("k1", 0.0, 1e5, "kernel")], []) if traced else None
    return harness.load_metric_reader(METRIC)(harness.MetricContext(run, trace))


@pytest.fixture(autouse=True)
def store():
    profiling.clear()
    yield profiling.STORE
    profiling.clear()


def test_the_entry_reads_the_model_step_of_both_stream_cells():
    entry = next(m for m in harness.benchmark_json()["per_layer"] if m["name"] == METRIC)
    assert entry["layer"] == "model step" and entry["moves"] == "stream_frames_per_s"
    assert entry["workloads"] == ["r50-stream", "vgg16-stream"]


def test_the_share_is_replayed_frames_over_stage1_frames():
    profiling.STORE.count("stage1.frames", 48)
    profiling.STORE.count("stage1.frames", 16)
    profiling.STORE.count("stage1.graph_frames", 40)
    profiling.STORE.count("stage1.graph_frames", 8)
    assert _read() == pytest.approx(75.0)


def test_the_share_reads_nothing_from_nothing(monkeypatch):
    assert _read() is None  # nothing counted
    profiling.STORE.count("stage1.frames", 8)
    assert _read() is None  # a program without the graphs
    profiling.STORE.count("stage1.graph_frames", 8)
    assert _read() == pytest.approx(100.0)
    assert _read(traced=False) is None
    for name in ("spans", "counters"):  # a program without the recorder
        monkeypatch.delattr(profiling, name)
    assert _read() is None
