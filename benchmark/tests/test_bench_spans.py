"""The readers of the program's spans and counters, on a synthetic traced
window and synthetic recorded spans: idle time inside a span and not
outside it, clipping to the window, 0 where no idle time overlaps a span,
the busy shares, the copy rate's arithmetic and the split by every span,
and nothing read from a program that records nothing."""

import types

import pytest

from benchmark import harness
from cp360_tpu_torch.utils import profiling

# microseconds: a window of 1 s; kernels over 0.1-0.3 s and 0.25-0.4 s
# (overlapping), a copy over 0.5-0.7 s (not busy)
DEVICE = [("k1", 100e3, 200e3, "kernel"), ("k2", 250e3, 150e3, "kernel"),
          ("Memcpy HtoD", 500e3, 200e3, "gpu_memcpy")]
IDLE = {"decode_idle_share.stream": "stream.decode",
        "remap_wait_idle_share.stream": "stream.remap_wait",
        "stage_idle_share.stream": "stream.stage",
        "loader_idle_share.train": "loader.wait",
        "h2d_idle_share.train": "train.h2d"}
T0 = 1000.0  # the tracer's start on the host's perf_counter clock, seconds


def _ctx(metric, host=(), traced=True):
    cell = next(m for m in harness.benchmark_json()["per_layer"]
                if m["name"] == metric)["workloads"][0]
    run = harness.load_run(cell, 1, 1.0, True, "none")
    run.tracer = types.SimpleNamespace(t0=T0)
    trace = harness.Trace(0.0, 1e6, list(DEVICE), list(host)) if traced else None
    return harness.MetricContext(run, trace)


def _read(metric, **kw):
    return harness.load_metric_reader(metric)(_ctx(metric, **kw))


@pytest.fixture(autouse=True)
def store():
    profiling.clear()
    yield profiling.STORE
    profiling.clear()


def _record(name, a_s, b_s):
    """A span from T0 + a_s to T0 + b_s on the recorder's clock."""
    profiling.STORE.add(profiling.Span(name, 7, round((T0 + a_s) * 1e9),
                                       round((T0 + b_s) * 1e9), False))


@pytest.mark.parametrize("metric", sorted(IDLE))
def test_idle_inside_the_span_only(metric):
    span = IDLE[metric]
    host = [(span, 350e3, 250e3),  # 0.35-0.6 s: idle from 0.4 s, 0.2 s in all
            (span, 0.0, 50e3),  # 0-0.05 s: idle throughout
            ("aten::empty", 400e3, 600e3),  # idle, but in no span of this metric
            ("other.span", 0.0, 1e6)]
    assert _read(metric, host=host) == pytest.approx(25.0)


@pytest.mark.parametrize("metric", sorted(IDLE))
def test_idle_share_clips_to_the_window(metric):
    span = IDLE[metric]
    host = [(span, 900e3, 400e3), (span, -200e3, 220e3)]  # 0.9-1.0 and 0-0.02 count
    assert _read(metric, host=host) == pytest.approx(12.0)


@pytest.mark.parametrize("metric", sorted(IDLE))
def test_idle_share_reads_0_where_kernels_cover_the_span(metric):
    span = IDLE[metric]
    host = [(span, 120e3, 80e3), (span, 260e3, 140e3)]
    assert _read(metric, host=host) == 0.0


@pytest.mark.parametrize("metric", sorted(IDLE))
def test_idle_share_reads_nothing_without_the_span_or_the_trace(metric):
    assert _read(metric, host=[("aten::to", 0.0, 1e6)]) is None
    assert _read(metric, host=[(IDLE[metric], 0.0, 1e6)], traced=False) is None


@pytest.mark.parametrize("metric,span,threads", [("remap_busy_share.stream", "stream.remap", 4),
                                                 ("loader_busy_share.train", "loader.read", 1)])
def test_busy_share_sums_spans_clipped_to_the_window(metric, span, threads):
    _record(span, 0.1, 0.4)  # 0.3 s
    _record(span, 0.2, 0.3)  # another thread's, overlapping: summed, 0.1 s
    _record(span, -0.5, 0.1)  # 0.1 s inside
    _record(span, 0.9, 2.0)  # 0.1 s inside
    _record(span, 1.5, 1.8)  # outside
    _record("other.span", 0.0, 1.0)
    assert _read(metric) == pytest.approx(60.0 / threads)


@pytest.mark.parametrize("metric", ["remap_busy_share.stream", "loader_busy_share.train",
                                    "h2d_gbps.train"])
def test_store_readers_read_nothing_from_nothing(metric, monkeypatch):
    assert _read(metric) is None  # nothing recorded
    _record("stream.remap", 0.1, 0.2)
    _record("loader.read", 0.1, 0.2)
    _record("train.h2d", 0.1, 0.2)
    profiling.STORE.count("h2d.bytes", 1e9)
    assert _read(metric, traced=False) is None
    for name in ("spans", "counters"):  # a program without the recorder
        monkeypatch.delattr(profiling, name)
    assert _read(metric) is None


def test_h2d_gbps_is_bytes_over_the_copies_device_seconds():
    """The counter's bytes over the union of the window's host-to-card
    copies on the card (0.5-0.7 s and 0.6-0.75 s, clipped): the spans'
    host time and the other direction's copies do not count."""
    _record("train.h2d", 0.0, 0.5)
    _record("train.h2d", 0.7, 2.2)
    profiling.STORE.count("h2d.bytes", 3e9)
    profiling.STORE.count("h2d.bytes", 1e9)
    extra = [("Memcpy HtoD (Pageable -> Device)", 600e3, 150e3, "gpu_memcpy"),
             ("Memcpy DtoH (Device -> Pageable)", 800e3, 100e3, "gpu_memcpy"),
             ("Memcpy HtoD (Pageable -> Device)", 950e3, 100e3, "gpu_memcpy")]
    ctx = _ctx("h2d_gbps.train")
    ctx.trace.device.extend(extra)
    assert harness.load_metric_reader("h2d_gbps.train")(ctx) == pytest.approx(4e9 / 0.3 * 1e-9)


def test_h2d_gbps_reads_nothing_without_a_copy():
    profiling.STORE.count("h2d.bytes", 1e9)
    ctx = _ctx("h2d_gbps.train")
    ctx.trace.device[:] = [d for d in ctx.trace.device if d[3] != "gpu_memcpy"]
    assert harness.load_metric_reader("h2d_gbps.train")(ctx) is None


def test_split_by_every_program_span():
    """``lib/spans.py::split``, as ``benchmark/split.py`` prints it: idle
    inside each traced span and outside them all, and the store's spans
    clipped to the window with their gaps on one thread."""
    from benchmark.lib import spans

    trace = harness.Trace(0.0, 1e6, DEVICE, [("a", 350e3, 250e3), ("b", 0.0, 50e3),
                                             ("aten::to", 0.0, 1e6)])
    rec = [profiling.Span("a", 1, 0, 1, True), profiling.Span("b", 1, 0, 1, True)]
    for tid, x, y in [(7, -0.1, 0.2), (7, 0.1, 0.3), (8, 0.5, 0.8), (9, 0.9, 1.2), (9, 1.5, 1.6)]:
        rec.append(profiling.Span("w", tid, round((T0 + x) * 1e9), round((T0 + y) * 1e9), False))
    out = spans.split(trace, rec, T0)
    assert out["idle"] == pytest.approx(70.0)
    assert out["idle_in"] == {"a": pytest.approx(20.0), "b": pytest.approx(5.0)}
    assert out["idle_outside_program_spans"] == pytest.approx(45.0)
    w = out["store"]["w"]
    assert (w["n"], w["threads"]) == (4, 3)  # 1.5-1.6 s lies outside the window
    assert w["ms_max"] == pytest.approx(300.0) and w["ms_sum"] == pytest.approx(1100.0)
    assert w["busy_s"] == pytest.approx(0.2 + 0.2 + 0.3 + 0.1)
    assert w["open_share"] == pytest.approx(70.0)  # 0-0.3, 0.5-0.8, 0.9-1.0
    # between the threads' spans: 0.3-0.5 and 0.8-0.9; the window's edges are no gap
    assert w["gap_ms_max"] == pytest.approx(200.0) and w["gap_s_sum"] == pytest.approx(0.3)
