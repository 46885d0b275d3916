"""The VGG16-BN configuration's files: the reference and the work counts
load nothing of the program, the counts and the weights match the
published shapes, and the three new readers' arithmetic, with nothing read
from a program that does not time the backbone."""

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.lib import backbone_work, flops, weights_vgg16
from benchmark.lib.peaks import bound_ms
from cp360_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "benchmark/configs/cp360-vgg16bn.json").read_text())
R50 = json.loads((ROOT / "benchmark/configs/cp360-r50.json").read_text())
READERS = ("mfu_vgg16.stream", "backbone_share.stream", "backbone_roofline.stream")
PROBE = """
import sys
sys.path.insert(0, {root!r})
import benchmark.reference.vgg16, benchmark.lib.backbone_work
tops = {{m.split('.', 1)[0] for m in sys.modules}}
print(sorted(tops & {{'jax', 'jaxlib', 'flax', 'cp360_tpu', 'cp360_tpu_torch'}}))
"""


def test_reference_and_counts_load_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, check=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_configuration_is_cp360_r50s_but_the_backbone():
    assert CONFIG["config"] == R50["config"] and CONFIG["reduced"] == []
    assert (CONFIG["arch"], CONFIG["num_classes"], CONFIG["cam_channels"]) == \
        ("vgg16", 1000, 1024)


def test_vgg16_multiply_adds_on_a_224_face():
    (trunk, _), (camconv, _) = backbone_work.vgg16_face(224, 64, 1024, 2)
    assert trunk == 15_346_630_656 and camconv == 231_211_008


def test_frame_work():
    ops, nbytes = backbone_work.frame_work(CONFIG)
    cam = 2 * 49 * 1024 * 1000
    assert ops == 6 * (2 * (15_346_630_656 + 231_211_008) + cam)  # 187.5 GFLOP
    assert nbytes == pytest.approx(623.78e6, rel=1e-4)
    assert bound_ms(8 * nbytes, 8 * ops) == (pytest.approx(1.517, abs=5e-4), "operations")
    r50_ops, _ = backbone_work.frame_work(R50)
    assert r50_ops == flops.backbone_frame_flops("resnet50", 64, 224, 1000)


def test_weights_make_the_published_parameters():
    bb = weights_vgg16.make_backbone(1024, 1000, 2 ** 31 + 1, torch.device("cpu"), torch.bfloat16)
    trunk = sum(f["w"].numel() + f["b"].numel() for f in bb["features"])
    camconv = bb["camconv"]["w"].numel() + bb["camconv"]["b"].numel()
    assert (len(bb["features"]), trunk, camconv, bb["fc_w"].numel() + bb["fc_b"].numel()) == \
        (13, 14_714_688, 4_719_616, 1_025_000)
    assert bb["features"][0]["w"].shape == (64, 3, 3, 3)
    assert bb["features"][0]["w"].permute(0, 2, 3, 1).is_contiguous()  # OHWI in memory


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_weights_are_made_from_the_seed(seed):
    cfg = dict(CONFIG, base_width=8, cam_channels=32, num_classes=16,  # base_width cuts nothing
               config=dict(CONFIG["config"], input_size=16, hidden_size=16))
    a, b, c = (weights_vgg16.for_config(cfg, s, torch.device("cpu")) for s in (seed, seed,
                                                                               seed + 2))
    assert torch.equal(a["bb"]["features"][12]["w"], b["bb"]["features"][12]["w"])
    assert torch.equal(a["bb"]["camconv"]["b"], b["bb"]["camconv"]["b"])
    assert torch.equal(a["cl"]["gates"]["w"], b["cl"]["gates"]["w"])
    assert not torch.equal(a["bb"]["features"][12]["w"], c["bb"]["features"][12]["w"])
    assert a["bb"]["features"][12]["w"].shape == (512, 512, 3, 3)


T0 = 1000.0


def _read(metric, cell="vgg16-stream", traced=True, maps=0, window_s=0.0):
    run = harness.load_run(cell, 1, 1.0, True, "none")
    run.tracer = types.SimpleNamespace(t0=T0)
    run.counters["maps"], run.window_s = maps, window_s
    trace = harness.Trace(0.0, 2e6, [], []) if traced else None  # a 2 s window
    return harness.load_metric_reader(metric)(harness.MetricContext(run, trace))


@pytest.fixture(autouse=True)
def store():
    profiling.clear()
    yield profiling.STORE
    profiling.clear()


def test_mfu_vgg16_is_the_maps_model_work_over_the_peak():
    per_map = backbone_work.frame_work(CONFIG)[0] + flops.clstm_window_flops(1000, 1000, 7, 5)
    assert per_map == pytest.approx(1.2459e12, rel=1e-4)
    assert _read("mfu_vgg16.stream", maps=600, window_s=5.0) == \
        pytest.approx(100 * 600 * per_map / (5.0 * 989e12))
    assert _read("mfu_vgg16.stream") is None


@pytest.mark.parametrize("cell", ["vgg16-stream", "r50-stream"])
def test_backbone_share_and_roofline(cell):
    profiling.STORE.count("stage1.backbone.device_ms", 700.0)
    profiling.STORE.count("stage1.backbone.device_ms", 100.0)
    profiling.STORE.count("stage1.frames", 64)
    assert _read("backbone_share.stream", cell) == pytest.approx(40.0)  # 0.8 s of 2
    config = CONFIG if cell == "vgg16-stream" else R50
    assert _read("backbone_roofline.stream", cell) == \
        pytest.approx(100 * backbone_work.least_ms(config, 64) / 800.0)


@pytest.mark.parametrize("metric", READERS)
def test_readers_read_nothing_from_nothing(metric, monkeypatch):
    assert _read(metric) is None  # nothing counted
    profiling.STORE.count("stage1.frames", 8)
    assert _read(metric) is None  # frames without the backbone's device time
    profiling.STORE.count("stage1.backbone.device_ms", 10.0)
    assert _read(metric, traced=False) is None
    for name in ("spans", "counters"):  # a program without the recorder
        monkeypatch.delattr(profiling, name)
    assert _read(metric) is None
