"""PyTorch port, the span and counter recorder (``utils/profiling.py``) and
the spans of the stream and training paths, on the CPU.

The stream runs on a seeded 12-frame 256x128 mp4v video through resnet18
with a 16-class CAM on 64-pixel faces and a ConvLSTM 16/16, and training on
a ConvLSTM 8/8 fed by ``PrefetchLoader`` over seeded artifacts, as
``tests/test_torch_stream.py`` and ``tests/test_torch_train.py`` run them.
Recording must change nothing the paths compute: maps, losses and weights
are compared bit for bit with recording on and off.
"""

import json
import os
import tempfile
import threading
import time
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cp360_tpu_torch.compat import jax_params
from cp360_tpu_torch.config import Config
from cp360_tpu_torch.data.dataset import PrefetchLoader, WindowDataset
from cp360_tpu_torch.pipelines.stream import REMAP_WORKERS, stream_video_saliency
from cp360_tpu_torch.train import loop
from cp360_tpu_torch.utils import profiling
from cp360_tpu_torch.utils.profiling import annotate, count, maybe_profile

torch.set_num_threads(2)

PORT = Path(__file__).resolve().parents[1] / "cp360_tpu_torch"
STREAM_CFG = dict(equi_h=256, equi_w=128, cube_dim=64, flow_h=32, seq_len=5,
                  compute_dtype="float32", feat_dtype="float16", opt_flow=False,
                  host_cube_remap=True)
FRAMES = 12
CALLER_STREAM = ("stream.decode_wait", "stream.remap_wait", "stream.stage", "stream.stage1",
                 "stage1.backbone", "stream.stage2", "stream.fetch")
CALLER_TRAIN = ("loader.wait", "train.h2d", "train.forward", "train.backward",
                "train.optimizer")
TRAIN_KW = dict(input_size=8, hidden_size=8, flow_h=8, compute_dtype="float32", lr=1e-3)


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


def _profiled(fn):
    """fn() under a CPU torch.profiler; (its result, the exported trace's
    events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return out, json.loads(path.read_text())["traceEvents"]


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


# ---- the recorder ------------------------------------------------------------------


def test_off_enters_no_record_function_and_stores_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with nothing profiling")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with annotate("a"):
        count("c", 3)
    th = threading.Thread(target=lambda: annotate("b").__enter__().__exit__(None, None, None))
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    assert profiling.spans() == [] and profiling.counters() == {}


def test_recording_follows_the_profiled_thread():
    """While the profiler runs, a worker's span and count are stored, the
    first before any caller span; once it has stopped, nothing is, on any
    thread.  Only the caller's span is in the profiler's trace."""
    def worker(name):
        th = threading.Thread(target=lambda: annotate(name).__enter__().__exit__(None, None, None))
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()

    def body():
        worker("worker.first")
        with annotate("caller"):
            count("c", 2)
        worker("worker.on")

    _, events = _profiled(body)
    worker("worker.off")
    with annotate("caller.after"):
        count("c", 5)
    got = _by_name(profiling.spans())
    assert set(got) == {"worker.first", "caller", "worker.on"}
    assert got["caller"][0].traced and got["caller"][0].tid == threading.get_native_id()
    assert got["worker.on"][0].tid != threading.get_native_id()
    assert profiling.counters() == {"c": 2}
    traced = [e for e in events if e.get("cat") == "user_annotation"]
    assert [e["name"] for e in traced] == ["caller"]


def test_store_is_bounded_and_counts_what_it_drops():
    store = profiling.SpanStore(max_spans=2)
    for i in range(5):
        store.add(profiling.Span(f"s{i}", 1, i, i + 1, False))
    assert [s.name for s in store.spans()] == ["s0", "s1"] and store.dropped == 3
    store.clear()
    assert store.spans() == [] and store.dropped == 0


def test_stores_no_lost_update_under_threads():
    """Eight threads add spans and counts at once, with a short switch
    interval: every one is kept."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                with annotate("t"):
                    count("n", 1)

        def body():
            with annotate("caller"):
                pass
            threads = [threading.Thread(target=work) for _ in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)

        _profiled(body)
    finally:
        sys.setswitchinterval(old)
    assert len(_by_name(profiling.spans())["t"]) == 4000
    assert profiling.counters()["n"] == 4000


def test_record_function_only_inside_annotate():
    users = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
                   if "record_function" in p.read_text())
    assert users == ["utils/profiling.py"]


@pytest.mark.parametrize("gap_ms", [2, 20])
def test_maybe_profile_places_worker_spans_after_the_caller_span(tmp_path, gap_ms):
    """A worker span that starts after a caller span ends lands after it
    in the written trace, by the gap measured on the host, within 1 ms."""
    marks = {}

    def worker():
        marks["worker"] = time.perf_counter_ns()
        with annotate("test.worker"):
            time.sleep(0.005)

    with maybe_profile(str(tmp_path / "prof")):
        with annotate("test.caller"):
            time.sleep(0.01)
        marks["caller_end"] = time.perf_counter_ns()
        time.sleep(gap_ms / 1000)
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
    (name,) = os.listdir(tmp_path / "prof")
    events = json.loads((tmp_path / "prof" / name).read_text())["traceEvents"]
    caller = next(e for e in events if e.get("name") == "test.caller")
    worker_ev = next(e for e in events if e.get("name") == "test.worker")
    gap_us = worker_ev["ts"] - (caller["ts"] + caller["dur"])
    want_us = (marks["worker"] - marks["caller_end"]) / 1000
    assert gap_us > 0
    assert abs(gap_us - want_us) <= 1000
    assert profiling.spans() == []
    with annotate("test.after"):
        pass
    assert profiling.spans() == []


# ---- the stream ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def stream_inputs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tracing") / "v.mp4")
    rng = np.random.RandomState(3)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (256, 128))
    base = (rng.rand(128, 256, 3) * 255).astype(np.uint8)
    for t in range(FRAMES):
        vw.write(np.roll(base, 5 * t, axis=1))
    vw.release()
    model = jax_params.backbone_from_params(
        jax_params.init_resnet_params(0, "resnet18", num_classes=16), "resnet18",
        compute_dtype=torch.float32)
    cell = jax_params.clstm_from_params(jax_params.init_clstm_params(1, 16, 16), torch.float32)
    return path, model, cell


def _stream(stream_inputs, **kw):
    path, model, cell = stream_inputs
    return dict(stream_video_saliency(model, cell, path, Config(**STREAM_CFG), stage1_batch=4,
                                      **kw))


@pytest.mark.parametrize("start_output", [0, 6])
def test_stream_records_every_span_where_it_runs(stream_inputs, start_output):
    maps, events = _profiled(lambda: _stream(stream_inputs, start_output=start_output))
    got = _by_name(profiling.spans())
    me = threading.get_native_id()
    assert set(got) == set(CALLER_STREAM) | {"stream.decode", "stream.remap"}
    assert len(got["stream.decode"]) == FRAMES  # every frame read or skipped
    decode_tids = {s.tid for s in got["stream.decode"]}  # the decode thread's, store only
    assert len(decode_tids) == 1 and me not in decode_tids
    assert not any(s.traced for s in got["stream.decode"])
    remap_tids = {s.tid for s in got["stream.remap"]}
    assert me not in remap_tids and len(remap_tids) <= REMAP_WORKERS
    fed = FRAMES - 1 - max(0, start_output - 4)  # the frames that reach a batch
    assert len(got["stream.remap"]) == fed
    for name in CALLER_STREAM:
        assert all(s.tid == me and s.traced for s in got[name]), name
        traced = [e for e in events if e.get("name") == name]
        assert len(traced) == len(got[name]) and \
            all(e["cat"] == "user_annotation" for e in traced), name
    batches = len(got["stream.remap_wait"])
    assert len(got["stream.stage"]) == len(got["stream.stage1"]) == \
        len(got["stage1.backbone"]) == batches
    assert len(got["stream.stage2"]) == len(got["stream.fetch"]) >= 1
    assert maps and min(maps) >= start_output
    counters = profiling.counters()  # no stage1.backbone.device_ms: the CPU has no device time
    assert set(counters) == {"stream.decode_taken", "stream.decode_ready", "stage1.frames"}
    assert counters["stream.decode_taken"] == fed
    assert counters["stage1.frames"] == 4 * batches  # a tail batch is padded to 4
    assert 0 <= counters["stream.decode_ready"] <= fed


def test_stream_maps_bit_identical_with_recording_on_and_off(stream_inputs):
    off = _stream(stream_inputs)
    on, _ = _profiled(lambda: _stream(stream_inputs))
    assert profiling.spans()
    assert sorted(on) == sorted(off)
    for k in off:
        assert on[k].dtype == off[k].dtype and np.array_equal(on[k], off[k]), k


# ---- training ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing_art")
    rng = np.random.RandomState(23)
    vids = ["vid_a", "vid_b"]
    for vid in vids:
        (root / vid / "cube_feat").mkdir(parents=True)
        (root / vid / "motion").mkdir(parents=True)
        for i in range(2, 10):
            np.save(root / vid / "cube_feat" / f"{i:06}.npy",
                    rng.rand(6, 8, 7, 7).astype(np.float16))
            np.save(root / vid / "motion" / f"{i:06}.npy",
                    (rng.randn(8, 16, 2) * 2).astype(np.float32))
    return str(root), vids


def _train(artifacts, steps=3, codec="none"):
    """(losses, final weights, the batches' bytes) of ``steps`` steps fed
    by the loader through ``batch_to_device``."""
    root, vids = artifacts
    cfg = Config(**TRAIN_KW)
    model = loop.trainable_clstm(cfg, jax_params.init_clstm_params(14, 8, 8), "cpu")
    step = loop.make_train_step(cfg, model, loop.make_optimizer(cfg, model))
    loader = PrefetchLoader(WindowDataset(root, None, vids, 5), batch_size=2, seed=3,
                            num_threads=2, transfer_codec=codec)
    losses, nbytes = [], 0
    batches = loader.iter_epoch(0)
    try:
        for _ in range(steps):
            batch = next(batches)
            nbytes += sum(a.nbytes for part in batch
                          for a in (part if isinstance(part, tuple) else (part,)))
            losses.append(step(*(loop.batch_to_device(x, "cpu") for x in batch))["loss"])
    finally:
        batches.close()
    weights = jax_params.clstm_to_params(model)
    return [float(v) for v in losses], weights, nbytes


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_train_records_every_span_where_it_runs(artifacts, codec):
    (losses, _, nbytes), events = _profiled(lambda: _train(artifacts, codec=codec))
    got = _by_name(profiling.spans())
    me = threading.get_native_id()
    assert set(got) == set(CALLER_TRAIN) | {"loader.read"}
    assert got["loader.read"] and all(s.tid != me for s in got["loader.read"])
    assert {s.tid for s in got["loader.read"]} == {got["loader.read"][0].tid}  # one worker
    for name in CALLER_TRAIN:
        assert all(s.tid == me and s.traced for s in got[name]), name
        assert sum(e.get("name") == name and e["cat"] == "user_annotation"
                   for e in events) == len(got[name]), name
    assert len(got["train.h2d"]) == 2 * len(losses)
    for name in ("loader.wait", "train.forward", "train.backward", "train.optimizer"):
        assert len(got[name]) == len(losses), name
    # on the CPU no batch is page-locked: every byte goes the pageable way
    assert profiling.counters() == {"h2d.bytes": nbytes, "h2d.pinned_bytes": 0}


def test_train_bit_identical_with_recording_on_and_off(artifacts):
    off = _train(artifacts)
    on, _ = _profiled(lambda: _train(artifacts))
    assert profiling.spans()
    assert on[0] == off[0]
    for name in off[1]:
        for k in ("w", "b"):
            assert np.array_equal(on[1][name][k], off[1][name][k]), (name, k)
