"""The ConvNeXt-B configuration's files: the reference, the work counts and
the weights load nothing of the program, the counts and the weights match
the published shapes, and the three new readers' arithmetic, with nothing
read from nothing.

The cell's whole run at a tiny size is here too: ConvNeXt's stage 4 is a
32nd of the face, and its depthwise conv's cube pad of 3 needs it at
least 3 wide, so the run takes 96 px faces where ``tests/tiny.py`` gives
64, at widths cut by 8 and the published depths."""

import json
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.lib import convnext_work, flops, weights_convnext
from benchmark.lib.peaks import H100_F32_FLOPS, bound_ms
from cp360_tpu_torch.utils import profiling
from tiny import TINY_CONFIG, TINY_TRAFFIC

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "benchmark/configs/cp360-convnextb.json").read_text())
VGG = json.loads((ROOT / "benchmark/configs/cp360-vgg16bn.json").read_text())
READERS = ("mfu_convnext.stream", "backbone_roofline_convnext.stream", "dwconv_roofline.stream")
PROBE = """
import sys
sys.path.insert(0, {root!r})
import benchmark.reference.convnext, benchmark.lib.convnext_work, benchmark.lib.weights_convnext
tops = {{m.split('.', 1)[0] for m in sys.modules}}
print(sorted(tops & {{'jax', 'jaxlib', 'flax', 'cp360_tpu', 'cp360_tpu_torch'}}))
"""


def test_reference_counts_and_weights_load_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, check=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_configuration_is_cp360_vgg16bns_but_the_backbone():
    assert CONFIG["config"] == VGG["config"] and CONFIG["reduced"] == []
    assert (CONFIG["arch"], CONFIG["depths"], CONFIG["dims"], CONFIG["num_classes"]) == \
        ("convnext_base", [3, 3, 27, 3], [128, 256, 512, 1024], 1000)


def test_convnext_b_multiply_adds_and_parameters_on_a_224_face():
    work = convnext_work.face_work(224, CONFIG["depths"], CONFIG["dims"])
    assert work["trunk"][0] == pytest.approx(15.35e9, rel=0.01)  # the paper's 15.4G
    assert convnext_work.parameters(CONFIG) == pytest.approx(88.6e6, rel=0.001)
    assert work["dw"][0] == 228_652_032  # 49 an output value, 36 convs
    assert work["dw"][1] == pytest.approx(28.00e6, rel=1e-3)  # bytes a face: f32 in, bf16 out


def test_frame_work_counts_the_weights_once_a_call():
    ops, nbytes = convnext_work.frame_work(CONFIG, 8)
    assert ops == pytest.approx(184.85e9, rel=1e-3)
    ops1, nbytes1 = convnext_work.frame_work(CONFIG, 1)
    assert ops1 == ops
    # bf16 kernels and LNs; f32 biases, gamma, depthwise kernels, the stream's LNs, classifier
    weights = 2 * 86_550_016 + 4 * (1_016_448 + 1_024_000)
    assert nbytes1 - nbytes == pytest.approx(weights * (1 - 1 / 8))
    dw_ops, dw_bytes = convnext_work.dw_frame_work(CONFIG, 8)
    assert dw_ops == 6 * 2 * 228_652_032
    assert convnext_work.dw_least_ms(CONFIG, 8, 8) == \
        bound_ms(8 * dw_bytes, 8 * dw_ops, H100_F32_FLOPS)[0]  # bytes-bound: 0.402 ms


def test_weights_make_the_published_parameters():
    bb = weights_convnext.make_backbone(CONFIG["depths"], CONFIG["dims"], 1000, 2 ** 31 + 1,
                                        torch.device("cpu"), torch.bfloat16)
    tensors = [t for t in _leaves(bb)]
    assert sum(t.numel() for t in tensors) == convnext_work.parameters(CONFIG)
    blk = bb["stages"][2][26]
    assert blk["dw_w"].shape == (512, 7, 7) and blk["dw_w"].permute(1, 2, 0).is_contiguous()
    assert blk["w1"].shape == (2048, 512, 1, 1) and blk["w1"].permute(0, 2, 3, 1).is_contiguous()
    assert blk["dw_w"].dtype == torch.bfloat16 and blk["b1"].dtype == torch.float32
    assert 0.1 <= float(blk["gamma"].min()) and float(blk["gamma"].max()) <= 0.5
    assert all(t.data_ptr() % 16 == 0 for t in tensors)  # the kernels' 16-byte vectors


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_weights_are_made_from_the_seed(seed):
    cfg = dict(CONFIG, dims=[8, 16, 32, 64], num_classes=16,
               config=dict(CONFIG["config"], input_size=16, hidden_size=16))
    a, b, c = (weights_convnext.for_config(cfg, s, torch.device("cpu"))
               for s in (seed, seed, seed + 2))
    for key in ("dw_w", "w2", "b1", "gamma"):
        assert torch.equal(a["bb"]["stages"][2][26][key], b["bb"]["stages"][2][26][key])
        assert not torch.equal(a["bb"]["stages"][2][26][key], c["bb"]["stages"][2][26][key])
    assert torch.equal(a["cl"]["gates"]["w"], b["cl"]["gates"]["w"])


T0 = 1000.0


def _read(metric, traced=True, maps=0, window_s=0.0, device=()):
    run = harness.load_run("convnextb-stream", 1, 1.0, True, "none")
    run.tracer = types.SimpleNamespace(t0=T0)
    run.counters["maps"], run.window_s = maps, window_s
    trace = harness.Trace(0.0, 2e6, list(device), []) if traced else None  # a 2 s window
    return harness.load_metric_reader(metric)(harness.MetricContext(run, trace))


@pytest.fixture(autouse=True)
def store():
    profiling.clear()
    yield profiling.STORE
    profiling.clear()


def test_mfu_convnext_is_the_maps_model_work_over_the_peak():
    per_map = (convnext_work.frame_work(CONFIG, 8)[0]
               + flops.clstm_window_flops(1000, 1000, 7, 5))
    assert _read("mfu_convnext.stream", maps=600, window_s=5.0) == \
        pytest.approx(100 * 600 * per_map / (5.0 * 989e12))
    assert _read("mfu_convnext.stream") is None


def test_backbone_and_dwconv_rooflines():
    profiling.STORE.count("stage1.backbone.device_ms", 700.0)
    profiling.STORE.count("stage1.backbone.device_ms", 100.0)
    profiling.STORE.count("stage1.frames", 64)
    assert _read("backbone_roofline_convnext.stream") == \
        pytest.approx(100 * convnext_work.least_ms(CONFIG, 64, 8) / 800.0)
    name = "void (anonymous namespace)::cube_dwconv<true>(uint4 const*)"
    kernels = [(name, 0.0, 1e5, "kernel"), (name, 3e5, 2e5, "kernel"),
               ("sm90_xmma_gemm_bf16", 0.0, 5e5, "kernel")]
    assert _read("dwconv_roofline.stream", device=kernels) == \
        pytest.approx(100 * convnext_work.dw_least_ms(CONFIG, 64, 8) / 300.0)  # 0.3 s of it


@pytest.mark.parametrize("metric", READERS)
def test_readers_read_nothing_from_nothing(metric, monkeypatch):
    assert _read(metric) is None  # nothing counted
    profiling.STORE.count("stage1.frames", 8)
    assert _read(metric) is None  # frames without the backbone's or the kernel's time
    profiling.STORE.count("stage1.backbone.device_ms", 10.0)
    assert _read(metric, traced=False) is None
    for name in ("spans", "counters"):  # a program without the recorder
        monkeypatch.delattr(profiling, name)
    assert _read(metric) is None


def _tiny_run(control="none"):
    run = harness.load_run("convnextb-stream", 2 ** 31 + 11, 1.5, False, control)
    run.config = dict(run.config, dims=[16, 32, 64, 128], num_classes=16)
    run.config["config"] = {**run.config["config"], **TINY_CONFIG, "cube_dim": 96}
    run.traffic.update(TINY_TRAFFIC["stream"])
    run.device = torch.device("cpu")
    return run


@pytest.mark.parametrize("control", ["none", "fp8"])
def test_the_cell_runs_whole_at_a_tiny_size(control):
    """The program passes its check, and the reference rounded to float8
    in its place (the control) does not."""
    line = harness.execute(_tiny_run(control), time.perf_counter())
    assert line is not None and line["attempted"] > 0 and line["failed"] == 0
    assert line["correct"] is (control == "none"), line["checks"]
    assert "setup_s" in line["metrics"]
