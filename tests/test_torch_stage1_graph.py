"""PyTorch port, the CUDA graphs of stage 1's backbone and CAM
(``models/cam.py``: ``cam_forward``, ``CamGraphs``).

On the CPU: which inputs a graph serves (CUDA, autograd off, no capture
under way), that CPU inputs run eagerly and capture nothing, the stage-1
counters, and the cache's bookkeeping with a stand-in for the capture
(one entry per shape, dtype and device; the bound, least recently used
out; a copy of the model starting empty; a reassigned weight dropping
every graph; one replay at a time under many threads).

On the card (``cuda`` marker, skipped without one): each backbone family's
replay bit for bit against the eager forward at batches 8 and 1, results
held across the next call, weights and batch-norm statistics changed in
place, two threads on one model, the stem pool's launch count and the
profiler's view of a replay with the conv epilogue in it.
This file imports neither JAX nor the JAX package, so on a machine with the
card alone:

    python -m pytest tests/test_torch_stage1_graph.py --noconftest -q
"""

import copy
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch
from torch import nn

from cp360_tpu_torch.compat import jax_params
from cp360_tpu_torch.models import cam, layers
from cp360_tpu_torch.ops import conv_epilogue, cube_pool
from cp360_tpu_torch.pipelines.extract import stage1_batch_faces
from cp360_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
        counters = profiling.counters()
    return out, counters


def _tiny_resnet():
    params = jax_params.init_resnet_params(0, "resnet18", num_classes=16)
    return jax_params.backbone_from_params(params, "resnet18", compute_dtype=torch.float32)


# ---- which inputs a graph serves ----------------------------------------------------


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_cpu_inputs_run_eagerly_and_capture_nothing(grad):
    model = _tiny_resnet()
    x = torch.randn(2, 6, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.set_grad_enabled(grad):
        got = cam.cam_forward(model, x)
        want = cam.cam_forward_eager(model, x)
    assert "_cam_graphs" not in vars(model)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("is_cuda,grad,capturing,want", [
    (True, False, False, True),
    (False, False, False, False),  # a CPU tensor
    (True, True, False, False),  # autograd on: a graph records no backward
    (True, False, True, False),  # inside a caller's own capture
], ids=["cuda", "cpu", "grad", "capturing"])
def test_replayable_needs_a_cuda_input_without_autograd_outside_a_capture(
        monkeypatch, is_cuda, grad, capturing, want):
    monkeypatch.setattr(cam, "_capturing", lambda device: capturing)
    x = types.SimpleNamespace(is_cuda=is_cuda, device=torch.device("cuda", 0))
    with torch.set_grad_enabled(grad):
        assert cam.replayable(x) is want


def test_stage1_counts_its_frames_and_no_graph_frames_on_the_cpu():
    model = _tiny_resnet()
    faces = torch.randint(0, 256, (3, 6, 32, 32, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        _, counters = _profiled(lambda: stage1_batch_faces(model, faces))
    assert counters["stage1.frames"] == 3
    assert "stage1.graph_frames" not in counters and "stage1.graph_captures" not in counters


# ---- the cache, with a stand-in for the capture -------------------------------------


class _Entry:
    """A stand-in graph: its replay answers ``x * 2 + tag`` (the capture's
    count), and fails if two replays of the model's graphs overlap."""

    def __init__(self, tag, busy):
        self.tag, self.busy = tag, busy

    def replay(self, x):
        if self.busy[0]:
            raise AssertionError("two replays of one model's graphs overlapped")
        self.busy[0] = True
        try:
            return (x * 2 + self.tag,)
        finally:
            self.busy[0] = False


def _capture_log():
    """(a stand-in capture, the keys it captured in order)."""
    log, busy = [], [False]

    def capture(model, x, shared):
        log.append((tuple(x.shape), x.dtype, x.device))
        return _Entry(len(log), busy), (x * 2,)
    return capture, log


class _Model(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("w", torch.ones(3))
        self.inner = nn.Linear(2, 2)


def _x(*shape, dtype=torch.float32, device="cpu"):
    return torch.ones(shape, dtype=dtype, device=device)


def test_one_entry_per_shape_dtype_and_device():
    capture, log = _capture_log()
    graphs, model = cam.CamGraphs(capture), _Model()
    first = graphs.run(model, _x(2, 6, 4, 4, 3))
    again = graphs.run(model, _x(2, 6, 4, 4, 3))
    assert torch.equal(first[0], _x(2, 6, 4, 4, 3) * 2)  # the capture's own answer
    assert torch.equal(again[0], _x(2, 6, 4, 4, 3) * 2 + 1)  # entry 1's replay
    graphs.run(model, _x(1, 6, 4, 4, 3))
    graphs.run(model, _x(2, 6, 4, 4, 3, dtype=torch.float64))
    graphs.run(model, _x(2, 6, 4, 4, 3, device="meta"))
    graphs.run(model, _x(1, 6, 4, 4, 3))
    assert len(log) == len(graphs) == 4
    assert [k[0] for k in log] == [(2, 6, 4, 4, 3), (1, 6, 4, 4, 3), (2, 6, 4, 4, 3),
                                   (2, 6, 4, 4, 3)]
    assert [k[1:] for k in log[2:]] == [(torch.float64, torch.device("cpu")),
                                        (torch.float32, torch.device("meta"))]


def test_the_bound_drops_the_least_recently_used_first():
    capture, log = _capture_log()
    graphs, model = cam.CamGraphs(capture), _Model()
    bound = cam.MAX_GRAPHS
    assert bound == 8
    for n in range(1, bound + 1):
        graphs.run(model, _x(n, 6, 4, 4, 3))
    graphs.run(model, _x(1, 6, 4, 4, 3))  # 1 is now the most recent
    graphs.run(model, _x(bound + 1, 6, 4, 4, 3))  # drops 2
    assert [k[0][0] for k in graphs.keys()] == [*range(3, bound + 1), 1, bound + 1]
    graphs.run(model, _x(2, 6, 4, 4, 3))  # captured again; drops 3
    assert [k[0][0] for k in graphs.keys()] == [*range(4, bound + 1), 1, bound + 1, 2]
    assert [k[0][0] for k in log] == [*range(1, bound + 2), 2]


def test_counters_count_captures_and_the_frames_replays_served():
    capture, _ = _capture_log()
    graphs, model = cam.CamGraphs(capture), _Model()

    def calls():
        for n in (3, 3, 3, 2, 2):
            graphs.run(model, _x(n, 6, 4, 4, 3))
    _, counters = _profiled(calls)
    assert counters["stage1.graph_captures"] == 2
    assert counters["stage1.graph_frames"] == 3 + 3 + 2


def test_a_weight_changed_in_place_keeps_the_graphs_and_a_reassigned_one_drops_them():
    capture, log = _capture_log()
    graphs, model = cam.CamGraphs(capture), _Model()
    graphs.run(model, _x(1, 6, 4, 4, 3))
    graphs.run(model, _x(2, 6, 4, 4, 3))
    model.w.mul_(3.0)
    model.inner.weight.data.zero_()
    graphs.run(model, _x(1, 6, 4, 4, 3))
    assert len(log) == 2
    model.w = torch.zeros(3)  # a registered buffer under a new tensor
    graphs.run(model, _x(1, 6, 4, 4, 3))
    assert len(log) == 3 and len(graphs) == 1
    model.inner.to(torch.float64)  # a parameter keeps its object, with new data
    graphs.run(model, _x(1, 6, 4, 4, 3))
    assert len(log) == 4
    model.inner = nn.Linear(2, 2)  # a submodule anew
    graphs.run(model, _x(1, 6, 4, 4, 3))
    assert len(log) == 5


def test_a_copy_of_the_model_starts_with_no_graph():
    capture, log = _capture_log()
    model = _Model()
    graphs = cam.graphs_of(model)
    assert cam.graphs_of(model) is graphs
    graphs._capture = capture
    graphs.run(model, _x(1, 6, 4, 4, 3))
    twin = copy.deepcopy(model)
    theirs = cam.graphs_of(twin)
    assert theirs is not graphs and len(theirs) == 0 and len(graphs) == 1
    theirs.run(twin, _x(1, 6, 4, 4, 3))
    assert len(log) == 2  # the copy captured its own


def test_many_threads_replay_one_at_a_time_and_get_their_own_answers():
    capture, log = _capture_log()
    graphs, model = cam.CamGraphs(capture), _Model()
    workers = (os.cpu_count() or 4) + 2
    errors, wrong = [], []

    def work(i):
        try:
            for j in range(40):
                n = 1 + (i + j) % 3
                x = torch.full((n, 6, 2, 2, 3), 1000.0 * i)
                # this thread's input, doubled, plus the answering entry's tag (0-3)
                tags = (graphs.run(model, x)[0] - 2000.0 * i).unique()
                if x.shape[0] != n or tags.numel() != 1 or not 0 <= tags.item() <= 3:
                    wrong.append((i, j, tags.tolist()))
        except Exception as e:  # noqa: BLE001 -- reported below with the worker's index
            errors.append((i, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not wrong, (errors[:3], wrong[:3])
    assert len(log) == 3 and len(graphs) == 3  # one capture a shape, under the bound


# ---- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; CUDA graphs run on the card only")
    return torch.device("cuda")


_MODELS = {}


def _model(arch, dtype, form=None):
    """A seeded full-width backbone on the card, built once per test run."""
    key = (arch, dtype, form)
    if key not in _MODELS:
        params = jax_params.init_backbone_params(7, arch)
        _MODELS[key] = jax_params.backbone_from_params(
            params, arch, compute_dtype=dtype, device="cuda", cube_conv_form=form)
    return _MODELS[key]


def _cubes(n, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((n, 6, 224, 224, 3), generator=gen, device="cuda")


def _bits_equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


BACKBONES = [("resnet50", torch.bfloat16, "halo"), ("resnet50", torch.float32, "pad"),
             ("vgg16", torch.bfloat16, None), ("mobilenet_v2", torch.bfloat16, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 1])
@pytest.mark.parametrize("arch,dtype,form", BACKBONES,
                         ids=["resnet50-halo-bf16", "resnet50-pad-f32", "vgg16-bf16",
                              "mobilenet_v2-bf16"])
def test_cuda_replay_equals_eager_bit_for_bit(cuda, arch, dtype, form, n):
    model = _model(arch, dtype, form)
    x, y = _cubes(n, 1), _cubes(n, 2)
    with torch.no_grad():
        want_x, want_y = cam.cam_forward_eager(model, x), cam.cam_forward_eager(model, y)
        first = cam.cam_forward(model, x)  # the capture: the eager run's answer
        replays = [cam.cam_forward(model, x), cam.cam_forward(model, y)]
    torch.cuda.synchronize()
    assert ((n, 6, 224, 224, 3), torch.float32, x.device) in cam.graphs_of(model).keys()
    for got, want in [(first, want_x), (replays[0], want_x), (replays[1], want_y)]:
        for g, w in zip(got, want):
            assert _bits_equal(g, w)


@pytest.mark.cuda
def test_cuda_a_result_held_across_the_next_call_is_unchanged(cuda):
    model = _model("resnet50", torch.bfloat16, "halo")
    with torch.no_grad():
        cam.cam_forward(model, _cubes(1, 3))
        held = cam.cam_forward(model, _cubes(1, 3))
        kept = [t.clone() for t in held]
        later = cam.cam_forward(model, _cubes(1, 4))
    torch.cuda.synchronize()
    for h, k, t in zip(held, kept, later):
        assert _bits_equal(h, k) and not torch.equal(h, t)


@pytest.mark.cuda
def test_cuda_weights_changed_in_place_change_the_next_replay(cuda):
    params = jax_params.init_backbone_params(8, "resnet50")
    model = jax_params.backbone_from_params(params, "resnet50", device="cuda")
    x = _cubes(2, 5)
    with torch.no_grad():
        cam.cam_forward(model, x)
        before = cam.cam_forward(model, x)
        model.bn1.scale.mul_(0.5)
        model.fc_w.mul_(-1.0)
        after = cam.cam_forward(model, x)
        want = cam.cam_forward_eager(model, x)
        # a batch norm's statistics deep in the trunk, read in its conv's epilogue
        model.stages[3][2].bns["bn3"].var.mul_(4.0)
        model.stages[2][0].bns["downsample"].mean.add_(0.5)
        later = cam.cam_forward(model, x)
        want_later = cam.cam_forward_eager(model, x)
    torch.cuda.synchronize()
    assert len(cam.graphs_of(model)) == 1
    assert not torch.equal(before[0], after[0])
    assert not torch.equal(after[1], later[1])
    for got, wants in ((after, want), (later, want_later)):
        for g, w in zip(got, wants):
            assert _bits_equal(g, w)


@pytest.mark.cuda
def test_cuda_two_threads_on_one_model_get_their_own_answers(cuda):
    model = _model("resnet50", torch.bfloat16, "halo")
    inputs = [_cubes(2, 10 + i) for i in range(2)]
    with torch.no_grad():
        wants = [cam.cam_forward_eager(model, x)[0] for x in inputs]
    got, errors = {}, []

    def work(i):
        try:
            with torch.no_grad():
                got[i] = [cam.cam_forward(model, inputs[i])[0] for _ in range(12)]
            torch.cuda.current_stream().synchronize()
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    torch.cuda.synchronize()
    for i in range(2):
        assert all(_bits_equal(s, wants[i]) for s in got[i])


@pytest.mark.cuda
def test_cuda_a_replay_counts_the_stem_pools_launches(cuda):
    """And the conv epilogue's, one a conv: a capture counts its eager run
    alone, each replay what the capture recorded."""
    model = _model("resnet50", torch.bfloat16, "halo")
    convs = sum(isinstance(m, layers.Conv) for m in model.modules())
    x = _cubes(4, 6)
    with torch.no_grad():
        before, epi = cube_pool.launches, conv_epilogue.launches
        cam.cam_forward(model, x)  # the capture's eager run: one launch
        assert cube_pool.launches == before + 1
        assert conv_epilogue.launches == epi + convs
        for k in range(3):
            cam.cam_forward(model, x)
            assert cube_pool.launches == before + 2 + k
            assert conv_epilogue.launches == epi + (2 + k) * convs
        vgg = _model("vgg16", torch.bfloat16)
        cam.cam_forward(vgg, x)
        cam.cam_forward(vgg, x)  # VGG16-BN has no stem pool
    assert cube_pool.launches == before + 4
    vgg_convs = sum(isinstance(m, layers.Conv) for m in vgg.modules())  # 13 and camconv
    assert conv_epilogue.launches == epi + 4 * convs + 2 * vgg_convs


@pytest.mark.cuda
def test_cuda_a_capture_and_a_replay_under_the_profiler(cuda):
    """The benchmark reads a replay's kernels from the profiler's trace: they
    are there, inside the span around the call, and a capture made while
    the profiler runs works."""
    from torch.profiler import ProfilerActivity, profile

    model = _model("resnet50", torch.bfloat16, "halo")
    x = _cubes(3, 7)
    with torch.no_grad():
        want = cam.cam_forward_eager(model, x)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            cam.cam_forward(model, x)  # captured while profiling
            with profiling.annotate("stage1.backbone", device=x.device):
                got = cam.cam_forward(model, x)
            torch.cuda.synchronize()
        counters = profiling.counters()
    for g, w in zip(got, want):
        assert _bits_equal(g, w)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = {e.name for e in kernels}
    assert any("cube_pool3x3s2" in n for n in names), sorted(names)[:20]
    assert any("epilogue" in n for n in names), sorted(names)[:20]
    assert len(kernels) > 2 * 100  # the eager run's and the replay's several hundred each
    assert counters["stage1.graph_captures"] == 1 and counters["stage1.graph_frames"] == 3
    assert counters["stage1.backbone.device_ms"] > 0
    assert np.isfinite(counters["stage1.backbone.device_ms"])
