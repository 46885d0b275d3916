"""The port's VGG16-BN on the stream path against the benchmark's plain
float32 reference (``benchmark/reference/vgg16.py``), on the CPU at small
sizes, and the stage-1 step's span and counters.

- The backbone and its CAM, built through ``models/vgg.py::VGG16``'s
  constructor from ``benchmark/lib/weights_vgg16.py``'s seeded tensors: in
  float32 as the reference computes, and in bf16 within a bound that the
  reference rounded to float8 (the benchmark's precision control) exceeds.
- ``stream_video_saliency`` with a VGG16 and a small ConvLSTM on a tiny
  written clip: every map against the reference's.
- The recorder: nothing without a profiler; ``stage1.frames`` under a CPU
  profiler and no device time on the CPU; device-timed spans resolved from
  their event pairs without waiting, and bounded.
"""

import cv2
import numpy as np
import pytest
import torch

from benchmark.drivers.stream_vgg16 import vgg16
from benchmark.lib import port, weights_vgg16
from benchmark.lib.weights import make_clstm
from benchmark.reference import model as ref
from benchmark.reference import vgg16 as ref_vgg16
from cp360_tpu_torch.models.cam import cam_forward
from cp360_tpu_torch.pipelines.extract import host_equi_to_cube_u8, stage1_batch_faces
from cp360_tpu_torch.pipelines.stream import stream_video_saliency
from cp360_tpu_torch.utils import profiling

torch.set_num_threads(2)
CPU = torch.device("cpu")
CLASSES = 16
# (base width, camconv width, face): configuration D's widths cut by 8 on
# 64 px faces (2x2 after the five pools), and the published 64-512 and the
# 1024-wide camconv on 32 px faces (1x1)
SHAPES = [(8, 32, 64), (64, 1024, 32)]
# bf16 keeps 8 significant bits: through the 14 rounded convs the scores
# read 0.010-0.027 of their range at these shapes and seeds; float8 e4m3
# keeps 4 and reads 0.24-0.88.  The bound sits 2x above the one and 4x
# below the other.
BF16_BOUND = 0.06
# a float32 map against the float32 reference: the same operations in
# another order and grouping (the window's convs, the projection)
F32_MAP_RTOL = 1e-4


def _config(face, dtype="float32", **cfg):
    return {"arch": "vgg16", "num_classes": CLASSES,
            "config": {"cube_dim": face, "compute_dtype": dtype, **cfg}}


def _backbone(width, cam, seed, dtype="float32"):
    return weights_vgg16.make_backbone(cam, CLASSES, seed, CPU, getattr(torch, dtype),
                                       width=width)


def _gap(got, want):
    return float((got - want).abs().max()) / float(want.max() - want.min())


def _scores(shape, seed, dtype):
    """(the port's CAM scores, the reference's, the reference's rounded to
    float8) on 2 frames of random faces."""
    cfg = _config(shape[2], dtype)
    bb = _backbone(shape[0], shape[1], seed, dtype)
    faces = torch.rand((2, 6, shape[2], shape[2], 3), generator=torch.Generator().manual_seed(seed))
    mean, std = torch.tensor(ref.IMAGENET_MEAN), torch.tensor(ref.IMAGENET_STD)
    got, _ = cam_forward(vgg16(cfg, bb), (faces - mean) / std)
    want = ref.cam_scores(bb, ref_vgg16.vgg16_features(bb, faces))
    fp8 = ref.cam_scores(bb, ref_vgg16.vgg16_features(bb, faces, ref.quantize_fp8),
                         ref.quantize_fp8)
    return got, want, fp8


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"w{s[0]}-cam{s[1]}-face{s[2]}")
def test_vgg16_equals_the_reference_in_f32(shape):
    got, want, _ = _scores(shape, 2 ** 31 + 5, "float32")
    assert got.shape == want.shape == (2, 6, shape[2] // 32, shape[2] // 32, CLASSES)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.max() - want.min()))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"w{s[0]}-cam{s[1]}-face{s[2]}")
def test_vgg16_in_bf16_is_within_a_bound_that_fp8_exceeds(shape):
    """The reference takes the same bf16 kernels and biases, widened to
    float32, so the gap is the working precision's alone."""
    got, want, fp8 = _scores(shape, 7, "bfloat16")
    assert _gap(got, want) < BF16_BOUND < _gap(fp8, want)


def _clip(path, n=14, size=(256, 128), seed=3):
    rng = np.random.RandomState(seed)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10.0, size)
    base = (rng.rand(size[1], size[0], 3) * 255).astype(np.uint8)
    for t in range(n):
        vw.write(np.roll(base, 5 * t, axis=1))
    vw.release()
    cap, frames = cv2.VideoCapture(str(path)), []
    while True:
        ok, frame = cap.read()
        if not ok:
            cap.release()
            return str(path), frames
        frames.append(frame)


def test_stream_maps_equal_the_reference(tmp_path):
    """Every map of a 14-frame clip in batches of 4 (a clip's first batch,
    later ones, a padded tail) against the reference's window over the
    same frames.  The reference takes the faces the stream remapped on the
    host (``cv2.remap``'s fixed-point taps; the reference's own sampling
    is held to the port's maps in ``benchmark/tests``) and rounds its
    scores to float16, as the stream keeps its CAM cubes, so the gap is
    float32's alone."""
    cfg = _config(64, equi_h=256, equi_w=128, input_size=CLASSES, hidden_size=CLASSES,
                  seq_len=5)
    w = {"bb": _backbone(8, 32, 2 ** 31 + 9), "cl": make_clstm(CLASSES, CLASSES, 3, CPU,
                                                              torch.float32)}
    path, frames = _clip(tmp_path / "clip.mp4")
    maps = dict(stream_video_saliency(vgg16(cfg, w["bb"]), port.clstm(cfg, w["cl"]), path,
                                      port.program_config(cfg), stage1_batch=4))
    # map m ends at frame m; the reference's 2-frame lag leaves the clip's last frame out
    assert sorted(maps) == list(range(4, len(frames) - 1))
    faces = torch.from_numpy(np.stack([host_equi_to_cube_u8(f, 64) for f in frames]))
    with torch.no_grad():
        scores = ref.cam_scores(w["bb"], ref_vgg16.vgg16_features(w["bb"], faces.float() / 255))
        scores = scores.half().float()
        for m, got in maps.items():
            want = ref.window_saliency(w["cl"], scores[None, m - 4:m + 1])[0]
            np.testing.assert_allclose(got, want.numpy(), rtol=0,
                                       atol=F32_MAP_RTOL * float(want.max() - want.min()))


@pytest.fixture
def store():
    profiling.clear()
    yield profiling.STORE
    profiling.clear()


def _stage1(n=3):
    model = vgg16(_config(64), _backbone(8, 32, 1))
    faces = torch.randint(0, 256, (n, 6, 64, 64, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(1))
    return stage1_batch_faces(model, faces)


def test_stage1_records_nothing_without_a_profiler(store):
    _stage1()
    assert profiling.counters() == {} and profiling.spans() == []


def test_stage1_counts_frames_under_a_cpu_profiler(store):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _stage1(3)
        _stage1(2)
    assert profiling.counters() == {"stage1.frames": 5}  # no device time on the CPU
    spans = [s for s in profiling.spans() if s.name == "stage1.backbone"]
    assert len(spans) == 2 and all(s.traced and s.end_ns > s.start_ns for s in spans)


class FakeEvent:
    """``query``, ``synchronize`` and ``elapsed_time`` of a CUDA timing event
    at ``ms`` on a device clock, complete once ``done``."""

    def __init__(self, ms, done=True):
        self.ms, self.done, self.waited = ms, done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited, self.done = True, True

    def elapsed_time(self, end):
        assert end.done
        return end.ms - self.ms


def test_device_pairs_resolve_without_waiting_until_read():
    store = profiling.SpanStore()
    first, late = FakeEvent(4.0), FakeEvent(9.5, done=False)
    store.add_events("a.device_ms", FakeEvent(1.0), first)
    store.add_events("a.device_ms", FakeEvent(6.0), late)
    store.add_events("b.device_ms", FakeEvent(10.0), FakeEvent(10.25))
    # each add took the completed pairs before the first incomplete one, waiting for none
    assert store._counters == {"a.device_ms": 3.0} and not late.waited
    assert store.counters() == {"a.device_ms": 6.5, "b.device_ms": 0.25}  # reading waits
    assert late.waited and store._pending == []


def test_device_pairs_are_bounded_and_cleared():
    store = profiling.SpanStore(max_pending=2)
    for i in range(4):
        store.add_events("a.device_ms", FakeEvent(i), FakeEvent(i + 1.0, done=False))
    assert len(store._pending) == 2 and store.dropped == 2
    store.clear()
    assert store._pending == [] and store.dropped == 0 and store.counters() == {}


def test_a_cpu_device_records_the_host_span_alone(store):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("x", device=CPU):
            pass
    assert [s.name for s in profiling.spans()] == ["x"] and profiling.counters() == {}
