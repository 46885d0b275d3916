"""The Swin-B configuration's files: the reference, the work counts and the
weights load nothing of the program, the counts and the weights match the
published shapes (and a hand count of one block), and the three new
readers' arithmetic, with nothing read from nothing.

The cell's whole run at a tiny size is here too: Swin's 7x7 windows must
tile every stage grid, so the run takes 224 px faces where
``tests/tiny.py`` gives 64, at widths cut to 32-64-128-256 (a head of 32
channels each) and depths 2-2-2-2."""

import json
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.lib import flops, swin_work, weights_swin
from benchmark.lib.peaks import H100_BF16_FLOPS, bound_ms
from cp360_tpu_torch.utils import profiling
from tiny import TINY_CONFIG, TINY_TRAFFIC

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "benchmark/configs/cp360-swinb.json").read_text())
CONVNEXT = json.loads((ROOT / "benchmark/configs/cp360-convnextb.json").read_text())
READERS = ("mfu_swin.stream", "backbone_roofline_swin.stream", "winattn_roofline.stream")
PROBE = """
import sys
sys.path.insert(0, {root!r})
import benchmark.reference.swin, benchmark.lib.swin_work, benchmark.lib.weights_swin
import benchmark.drivers.stream_swin
tops = {{m.split('.', 1)[0] for m in sys.modules}}
print(sorted(tops & {{'jax', 'jaxlib', 'flax', 'cp360_tpu', 'cp360_tpu_torch'}}))
"""


def test_reference_counts_weights_and_driver_load_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, check=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_configuration_is_cp360_convnextbs_but_the_backbone():
    assert CONFIG["config"] == CONVNEXT["config"] and CONFIG["reduced"] == []
    assert CONFIG["source"] == "https://arxiv.org/abs/2103.14030"
    assert (CONFIG["arch"], CONFIG["embed"], CONFIG["depths"], CONFIG["heads"],
            CONFIG["window"], CONFIG["num_classes"]) == \
        ("swin_base", 128, [2, 2, 18, 2], [4, 8, 16, 32], 7, 1000)


def test_swin_b_multiply_adds_and_parameters_on_a_224_face():
    work = swin_work.face_work(224, 128, CONFIG["depths"], CONFIG["heads"], 7)
    assert work["trunk"][0] == pytest.approx(15.4e9, rel=0.015)  # the paper's 15.4G
    assert swin_work.parameters(CONFIG) == 87_768_224  # the port's module, counted
    # q.k and p.v: 2 * 49^2 * C a window; stage 1 64 + 81 windows, stage 2 16 + 25,
    # stage 3 9 * (4 + 9), stage 4 2 * 1
    want = 2 * 49 ** 2 * (128 * 145 + 256 * 41 + 512 * 9 * 13 + 1024 * 2)
    assert work["attn"][0] == want


def test_one_block_by_hand():
    """Stage 1's second (shifted) block on a 224 face: 56x56 tokens at
    C = 128, 81 windows of 49 slots, bf16."""
    one = swin_work.face_work(224, 128, (2, 0, 0, 0), (4, 8, 16, 32), 7)
    none = swin_work.face_work(224, 128, (1, 0, 0, 0), (4, 8, 16, 32), 7)
    got = tuple(a - b for a, b in zip(one["trunk"], none["trunk"]))
    t, c = 56 * 56, 128
    macs = t * c * 3 * c + 2 * 81 * 49 * 49 * c + t * c * c + 2 * t * c * 4 * c
    acts = (t * (c * 2 + 3 * c * 2)  # qkv: bf16 in, bf16 out
            + 2 * (2 * t * c + 2 * 81 * 49 * c)  # attention: q, o once, k, v gathered
            + t * (c * 2 + c * 4)  # proj onto the f32 stream
            + t * (c * 2 + 4 * c * 2)  # fc1
            + t * (4 * c * 2 + c * 4))  # fc2 onto the f32 stream
    kernels = 12 * c * c
    f32 = 3 * c + 169 * 4 + c + 4 * c + c + 4 * c  # biases, the table, two LayerNorms
    assert got == (macs, acts, kernels, f32)
    attn = tuple(a - b for a, b in zip(one["attn"], none["attn"]))
    assert attn == (2 * 81 * 49 * 49 * c, 2 * (2 * t * c + 2 * 81 * 49 * c), 0,
                    3 * c + 169 * 4)


def test_frame_work_counts_the_weights_once_a_call():
    ops, nbytes = swin_work.frame_work(CONFIG, 8)
    assert ops == pytest.approx(187.35e9, rel=1e-3)
    ops1, nbytes1 = swin_work.frame_work(CONFIG, 1)
    assert ops1 == ops
    # bf16: the kernels and the patch embed's LayerNorm; f32: the biases, the
    # tables, the LayerNorms that read the stream and the classifier
    kernels, f32 = 86_513_920, 229_304 + 1_024_000
    assert kernels + f32 + 1000 == swin_work.parameters(CONFIG)
    assert nbytes1 - nbytes == pytest.approx((2 * kernels + 4 * f32) * (1 - 1 / 8))
    a_ops, a_bytes = swin_work.attn_frame_work(CONFIG, 8)
    assert a_bytes == pytest.approx(181.7e6, rel=1e-3)
    assert swin_work.attn_least_ms(CONFIG, 8, 8) == \
        bound_ms(8 * a_bytes, 8 * a_ops, H100_BF16_FLOPS)[0]  # bytes-bound: 0.434 ms


def test_weights_make_the_published_parameters():
    bb = weights_swin.make_backbone(128, CONFIG["depths"], CONFIG["heads"], 7, 1000,
                                    2 ** 31 + 1, torch.device("cpu"), torch.bfloat16)
    tensors = list(_leaves(bb))
    assert sum(t.numel() for t in tensors) == swin_work.parameters(CONFIG)
    blk = bb["stages"][2][17]
    assert blk["w_qkv"].shape == (1536, 512, 1, 1) and blk["table"].shape == (169, 16)
    assert blk["w1"].permute(0, 2, 3, 1).is_contiguous()
    assert blk["w1"].dtype == torch.bfloat16 and blk["b1"].dtype == torch.float32
    assert float(blk["w1"].float().std()) == pytest.approx(512 ** -0.5, rel=0.02)
    assert bb["merges"][2]["w"].shape == (1024, 2048, 1, 1)
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
    cfg = dict(CONFIG, embed=32, heads=[1, 2, 4, 8], num_classes=16,
               config=dict(CONFIG["config"], input_size=16, hidden_size=16))
    a, b, c = (weights_swin.for_config(cfg, s, torch.device("cpu"))
               for s in (seed, seed, seed + 2))
    for key in ("w_qkv", "table", "b1", "w2"):
        assert torch.equal(a["bb"]["stages"][2][17][key], b["bb"]["stages"][2][17][key])
        assert not torch.equal(a["bb"]["stages"][2][17][key], c["bb"]["stages"][2][17][key])
    assert torch.equal(a["cl"]["gates"]["w"], b["cl"]["gates"]["w"])


T0 = 1000.0


def _read(metric, traced=True, maps=0, window_s=0.0, device=()):
    run = harness.load_run("swinb-stream", 1, 1.0, True, "none")
    run.tracer = types.SimpleNamespace(t0=T0)
    run.counters["maps"], run.window_s = maps, window_s
    trace = harness.Trace(0.0, 2e6, list(device), []) if traced else None  # a 2 s window
    return harness.load_metric_reader(metric)(harness.MetricContext(run, trace))


@pytest.fixture(autouse=True)
def store():
    profiling.clear()
    yield profiling.STORE
    profiling.clear()


def test_mfu_swin_is_the_maps_model_work_over_the_peak():
    per_map = swin_work.frame_work(CONFIG, 8)[0] + flops.clstm_window_flops(1000, 1000, 7, 5)
    assert _read("mfu_swin.stream", maps=600, window_s=5.0) == \
        pytest.approx(100 * 600 * per_map / (5.0 * 989e12))
    assert _read("mfu_swin.stream") is None


def test_backbone_and_window_attention_rooflines():
    profiling.STORE.count("stage1.backbone.device_ms", 700.0)
    profiling.STORE.count("stage1.backbone.device_ms", 100.0)
    profiling.STORE.count("stage1.frames", 64)
    assert _read("backbone_roofline_swin.stream") == \
        pytest.approx(100 * swin_work.least_ms(CONFIG, 64, 8) / 800.0)
    name = "void (anonymous namespace)::cube_window_attn<4>(__nv_bfloat16 const*)"
    kernels = [(name, 0.0, 1e5, "kernel"), (name, 3e5, 2e5, "kernel"),
               ("sm90_xmma_gemm_bf16", 0.0, 5e5, "kernel")]
    assert _read("winattn_roofline.stream", device=kernels) == \
        pytest.approx(100 * swin_work.attn_least_ms(CONFIG, 64, 8) / 300.0)  # 0.3 s of it


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
    run = harness.load_run("swinb-stream", 2 ** 31 + 11, 1.5, False, control)
    run.config = dict(run.config, embed=32, heads=[1, 2, 4, 8], depths=[2, 2, 2, 2],
                      num_classes=16)
    run.config["config"] = {**run.config["config"], **TINY_CONFIG, "cube_dim": 224}
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
