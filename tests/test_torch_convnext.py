"""The port's ConvNeXt (``models/convnext.py``), its cube-padded depthwise
conv (``ops/cube_dwconv.py``) and GELU in the conv epilogue, against the
benchmark's plain float32 reference (``benchmark/reference/convnext.py``).

On the CPU, at small sizes (faces of 96 px, so that the last stage's 3x3
faces hold the depthwise conv's pad of 3):

- the backbone and its CAM, built through ``ConvNeXt``'s constructor from
  ``benchmark/lib/weights_convnext.py``'s seeded tensors, at the published
  widths with depths cut to (1, 1, 3, 1) and at widths cut by 8 at the
  published depths: in float32 as the reference computes, and in bf16
  within a bound that the reference rounded to float8 exceeds;
- ``stream_video_saliency`` with a ConvNeXt and a small ConvLSTM on a tiny
  written clip: every map against the reference's;
- the depthwise conv's plain version against ``pad_faces`` and
  ``F.conv2d(groups=C)`` and against the reference's own cube pad, at pad 3
  on faces of 7 and of 3 (the pad as wide as the face);
- GELU's plain epilogue against ``F.gelu``;
- the residual stream held in f32 and each block's branch in bf16;
- ``backbone_from_params`` building ConvNeXt-B from the port's seeded tree,
  and the JAX families' list left as it was.

On the card (``cuda`` marker, skipped without one): the kernel against its
plain version at every ConvNeXt-B shape in bf16, f32, and f32 faces to
bf16 (the residual stream's form); a CUDA forward
that never pads a face or runs the plain version, with 36 launches a
forward, replays included.  This file imports neither JAX nor the JAX
package, so on a machine with the card alone:

    python -m pytest tests/test_torch_convnext.py --noconftest -q
"""

import cv2
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.lib import port, weights_convnext
from benchmark.lib.weights import make_clstm
from benchmark.reference import convnext as ref_convnext
from benchmark.reference import model as ref
from cp360_tpu_torch.compat import convnext_params, jax_params
from cp360_tpu_torch.models import cam, convnext, layers
from cp360_tpu_torch.models.convnext import ConvNeXt
from cp360_tpu_torch.ops import conv_epilogue as ce
from cp360_tpu_torch.ops import cube_dwconv as dw
from cp360_tpu_torch.pipelines.extract import host_equi_to_cube_u8
from cp360_tpu_torch.pipelines.stream import stream_video_saliency

torch.set_num_threads(2)
CPU = torch.device("cpu")
CLASSES = 16
FACE = 96  # the last stage is FACE / 32 = 3 wide: the pad of 3 fits
PUBLISHED = ((1, 1, 3, 1), (128, 256, 512, 1024))  # ConvNeXt-B's widths, depths cut
NARROW = ((3, 3, 27, 3), (16, 32, 64, 128))  # ConvNeXt-B's depths, widths cut by 8
SHAPES = {"published-widths": PUBLISHED, "published-depths": NARROW}
# f32 against the f32 reference: the same operations, summed in another order
F32_RTOL = 1e-5
# bf16 keeps 8 significant bits: through the LayerNorms and the rounded
# convs the scores read 0.010-0.016 of their largest magnitude at these
# shapes (seeds 7, 8, 2**31 + 5); float8 e4m3 keeps 4 and reads 0.26-0.69.
# The bound sits 2.5x above the one and 6x below the other.
BF16_BOUND = 0.04
F32_MAP_RTOL = 1e-4  # a float32 map against the float32 reference (as for VGG16-BN)


def _backbone(shape, seed, dtype=torch.float32):
    depths, dims = shape
    return weights_convnext.make_backbone(depths, dims, CLASSES, seed, CPU, dtype)


def _model(bb, dtype=torch.float32):
    return ConvNeXt(bb, True, dtype).eval()


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _scores(shape, seed, dtype):
    """(the port's CAM scores, the reference's, the reference's rounded to
    float8) on 2 frames of random faces."""
    bb = _backbone(shape, seed, dtype)
    faces = torch.rand((2, 6, FACE, FACE, 3), generator=torch.Generator().manual_seed(seed))
    mean, std = torch.tensor(ref.IMAGENET_MEAN), torch.tensor(ref.IMAGENET_STD)
    with torch.no_grad():
        got, _ = cam.cam_forward(_model(bb, dtype), (faces - mean) / std)
        want = ref.cam_scores(bb, ref_convnext.convnext_features(bb, faces))
        fp8 = ref.cam_scores(bb, ref_convnext.convnext_features(bb, faces, ref.quantize_fp8),
                             ref.quantize_fp8)
    return got, want, fp8


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_convnext_equals_the_reference_in_f32(shape):
    got, want, _ = _scores(shape, 2 ** 31 + 5, torch.float32)
    assert got.shape == want.shape == (2, 6, FACE // 32, FACE // 32, CLASSES)
    torch.testing.assert_close(got, want, rtol=0, atol=F32_RTOL * float(want.abs().max()))


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_convnext_in_bf16_is_within_a_bound_that_fp8_exceeds(shape):
    """The reference takes the same bf16 kernels, widened to float32, so
    the gap is the working precision's alone."""
    got, want, fp8 = _scores(shape, 7, torch.bfloat16)
    assert _rel(got, want) < BF16_BOUND < _rel(fp8, want)


def test_logits_are_the_published_heads_and_not_the_cams_mean():
    bb = _backbone(NARROW, 3)
    faces = torch.rand((1, 6, FACE, FACE, 3), generator=torch.Generator().manual_seed(3))
    mean, std = torch.tensor(ref.IMAGENET_MEAN), torch.tensor(ref.IMAGENET_STD)
    with torch.no_grad():
        logits, feats = _model(bb)((faces - mean) / std)
        want = ref_convnext.logits(bb, faces).reshape(6, CLASSES)
    torch.testing.assert_close(logits, want, rtol=0, atol=F32_RTOL * float(want.abs().max()))
    cam_mean = feats.mean(dim=(1, 2)) @ bb["fc_w"] + bb["fc_b"]
    assert (cam_mean - logits).abs().max() > 1e-3  # LayerNorm is not linear


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
    """Every map of a 14-frame clip in batches of 4 against the reference's
    window over the same frames.  The reference takes the faces the stream
    remapped on the host and rounds its scores to float16, as the stream
    keeps its CAM cubes, so the gap is float32's alone."""
    cfg = {"arch": "convnext_base", "num_classes": CLASSES,
           "config": {"cube_dim": FACE, "compute_dtype": "float32", "equi_h": 256,
                      "equi_w": 128, "input_size": CLASSES, "hidden_size": CLASSES,
                      "seq_len": 5}}
    bb = _backbone(NARROW, 2 ** 31 + 9)
    cl = make_clstm(CLASSES, CLASSES, 3, CPU, torch.float32)
    path, frames = _clip(tmp_path / "clip.mp4")
    maps = dict(stream_video_saliency(_model(bb), port.clstm(cfg, cl), path,
                                      port.program_config(cfg), stage1_batch=4))
    assert sorted(maps) == list(range(4, len(frames) - 1))
    faces = torch.from_numpy(np.stack([host_equi_to_cube_u8(f, FACE) for f in frames]))
    with torch.no_grad():
        scores = ref.cam_scores(bb, ref_convnext.convnext_features(bb, faces.float() / 255))
        scores = scores.half().float()
        for m, got in maps.items():
            want = ref.window_saliency(cl, scores[None, m - 4:m + 1])[0]
            np.testing.assert_allclose(got, want.numpy(), rtol=0,
                                       atol=F32_MAP_RTOL * float(want.max() - want.min()))


# ---- the depthwise conv ---------------------------------------------------------------


def _dw_inputs(s, c, seed, dtype=torch.float32, n=2):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n * 6, s, s, c), generator=gen).to(dtype)
    w = torch.randn((c, 7, 7), generator=gen).to(dtype)
    return x, w, torch.randn(c, generator=gen)


@pytest.mark.parametrize("cube", [True, False], ids=["cube", "zero"])
@pytest.mark.parametrize("s", [7, 3])
def test_plain_dwconv_is_the_padded_grouped_conv_and_the_references(s, cube):
    x, w, b = _dw_inputs(s, 8, s)
    got = dw.cube_dwconv(x, w, b, cube)  # a CPU tensor: the plain version
    xp = layers.pad_faces(x, 3, cube).permute(0, 3, 1, 2)
    want = (F.conv2d(xp, w[:, None], groups=8).permute(0, 2, 3, 1) + b)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    other = ref_convnext.dwconv(x.reshape(2, 6, s, s, 8), w, b, use_cube_pad=cube)
    torch.testing.assert_close(got, other.reshape(got.shape), rtol=0, atol=1e-5)


def test_plain_dwconv_rounds_once_after_the_bias():
    x, w, b = _dw_inputs(7, 8, 1, torch.bfloat16)
    f32 = dw.plain_cube_dwconv(x.float(), w.float(), b)
    assert torch.equal(dw.plain_cube_dwconv(x, w, b), f32.to(torch.bfloat16))


def test_plain_dwconv_rounds_f32_faces_once_to_bf16():
    """ConvNeXt's form: the f32 residual stream in, the block's bf16 out."""
    x, w, b = _dw_inputs(7, 8, 6)
    got = dw.cube_dwconv(x, w, b, out_dtype=torch.bfloat16)
    assert torch.equal(got, dw.plain_cube_dwconv(x, w, b).to(torch.bfloat16))


def test_the_residual_stream_is_f32_and_each_branch_bf16(monkeypatch):
    """A bf16 model holds the stem's output and every block's sum in f32;
    the depthwise conv reads that stream and writes bf16, and the CAM's
    features are bf16."""
    tree = convnext_params.init_convnext_params(5, depths=(1, 1, 2, 1), dims=(8, 16, 32, 64),
                                                num_classes=CLASSES)
    model = convnext_params.convnext_from_params(tree, compute_dtype=torch.bfloat16)
    seen = []
    real = convnext.cube_dwconv

    def spy(x, *a, **k):
        y = real(x, *a, **k)
        seen.append((x.dtype, y.dtype))
        return y

    monkeypatch.setattr(convnext, "cube_dwconv", spy)
    sums = []
    for stage in model.stages:
        for blk in stage:
            blk.register_forward_hook(lambda m, i, o: sums.append((i[0].dtype, o.dtype)))
    with torch.no_grad():
        _, feats = model(torch.randn(1, 6, FACE, FACE, 3))
    assert seen == [(torch.float32, torch.bfloat16)] * 5
    assert sums == [(torch.float32, torch.float32)] * 5
    assert feats.dtype == torch.bfloat16


def test_dwconv_checks_its_arguments():
    x, w, b = _dw_inputs(7, 8, 2)
    with pytest.raises(ValueError, match="at least 3 pixels"):
        dw.cube_dwconv(x[:, :2, :2], w, b)
    assert dw.cube_dwconv(x[:, :2, :2], w, b, use_cube_pad=False).shape == (12, 2, 2, 8)
    with pytest.raises(ValueError, match="odd square"):
        dw.cube_dwconv(x, w[:, :6, :6], b)
    with pytest.raises(ValueError, match="bias of shape"):
        dw.cube_dwconv(x, w, b[:4])
    with pytest.raises(ValueError, match="square faces"):
        dw.cube_dwconv(x[:5], w, b)


# ---- GELU in the epilogue ------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_gelu_epilogue_is_f_gelu(dtype):
    gen = torch.Generator().manual_seed(5)
    x = (4 * torch.randn(3, 5, 5, 16, generator=gen)).to(dtype)
    pre = torch.randn(16, generator=gen)
    got = ce.conv_epilogue(x, conv_bias=pre, act="gelu")
    want = F.gelu(x.float() + pre).to(dtype)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22  # one ulp, relative
    torch.testing.assert_close(got.float(), want.float(), rtol=ulp, atol=1e-6)


# ---- the constructors ----------------------------------------------------------------


def test_backbone_from_params_builds_convnext_b():
    tree = jax_params.init_backbone_params(1, "convnext_base")
    model = jax_params.backbone_from_params(tree, "convnext_base", True, torch.bfloat16)
    assert isinstance(model, ConvNeXt) and model.arch == "convnext_base"
    assert (model.depths, model.dims) == convnext.ARCHS["convnext_base"]
    assert sum(t.numel() for t in model.buffers()) == 88_591_464
    assert model.stages[2][0].dw_w.shape == (512, 7, 7)
    assert model.stages[2][0].dw_w.permute(1, 2, 0).is_contiguous()  # [7, 7, C] memory
    assert model.stages[2][0].pw1.w.permute(0, 2, 3, 1).is_contiguous()  # OHWI memory
    assert "convnext_base" not in jax_params.BACKBONES  # the JAX package's families alone


def test_the_port_tree_and_the_benchmark_layout_build_the_same_model():
    tree = convnext_params.init_convnext_params(4, depths=(1, 1, 1, 1), dims=(8, 16, 32, 64),
                                                num_classes=CLASSES)
    model = convnext_params.convnext_from_params(tree, compute_dtype=torch.float32)
    assert model.arch == "convnext"
    blk = tree["stages"][1][0]
    np.testing.assert_array_equal(model.stages[1][0].dw_w.numpy(),
                                  blk["dw"]["w"][:, :, 0, :].transpose(2, 0, 1))
    np.testing.assert_array_equal(model.stages[1][0].pw2.w[:, :, 0, 0].numpy(),
                                  blk["pw2"]["w"][0, 0].T)
    faces = torch.rand((1, 6, FACE, FACE, 3), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = cam.cam_forward(model, faces)[0]
        bb = {"stem": {"w": model.stem.w, "b": model.stem.b, "ln_w": model.stem_norm.w,
                       "ln_b": model.stem_norm.b},
              "downsample": [{"w": d.w, "b": d.b, "ln_w": n.w, "ln_b": n.b}
                             for d, n in zip(model.downs, model.down_norms)],
              "stages": [[{"dw_w": b.dw_w, "dw_b": b.dw_b, "ln_w": b.norm.w, "ln_b": b.norm.b,
                           "w1": b.pw1.w, "b1": b.pw1.b, "w2": b.pw2.w, "b2": b.pw2.b,
                           "gamma": b.gamma} for b in stage] for stage in model.stages],
              "head": {"ln_w": model.head_norm.w, "ln_b": model.head_norm.b},
              "fc_w": model.cam_w, "fc_b": model.cam_b}
        assert torch.equal(cam.cam_forward(ConvNeXt(bb, True, torch.float32), faces)[0], got)


# ---- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the cube_dwconv kernel runs on the card only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,c", [(56, 128), (28, 256), (14, 512), (7, 1024)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_dwconv_equals_its_plain_version(cuda, dtype, s, c):
    """Both sum the 49 products in f32 and round once after the bias; only
    the order of the sums differs.  So a bf16 output is within one bf16 ulp
    (2^-7 of its value) of the plain one, an f32 output within f32
    reassociation error (1e-5 of its value); and either within 1e-4 of the
    largest output near zero, where a sum's cancellation leaves that
    reassociation error larger than the value."""
    gen = torch.Generator(device="cuda").manual_seed(s)
    x = torch.randn((12, s, s, c), generator=gen, device="cuda").to(dtype)
    w = (0.1 * torch.randn((7, 7, c), generator=gen, device="cuda")).to(dtype).permute(2, 0, 1)
    b = torch.randn(c, generator=gen, device="cuda")
    with torch.no_grad():
        before = dw.launches
        got = dw.cube_dwconv(x, w, b)
        want = dw.plain_cube_dwconv(x, w, b)
        zero = dw.cube_dwconv(x, w, b, use_cube_pad=False)
        want_zero = dw.plain_cube_dwconv(x, w, b, use_cube_pad=False)
    torch.cuda.synchronize()
    assert dw.launches == before + 2 and got.dtype == dtype
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    for g, v in ((got, want), (zero, want_zero)):
        torch.testing.assert_close(g.float(), v.float(), rtol=rtol,
                                   atol=1e-4 * float(v.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("s,c", [(56, 128), (28, 256), (14, 512), (7, 1024)])
def test_cuda_dwconv_from_f32_faces_to_bf16_equals_its_plain_version(cuda, s, c):
    """ConvNeXt's form on the main path: f32 faces and kernel, bf16 out,
    within one bf16 ulp of the plain version, as the bf16 form."""
    gen = torch.Generator(device="cuda").manual_seed(s + 1)
    x = torch.randn((12, s, s, c), generator=gen, device="cuda")
    w = (0.1 * torch.randn((7, 7, c), generator=gen, device="cuda")).permute(2, 0, 1)
    b = torch.randn(c, generator=gen, device="cuda")
    with torch.no_grad():
        before = dw.launches
        got = dw.cube_dwconv(x, w, b, out_dtype=torch.bfloat16)
        want = dw.plain_cube_dwconv(x, w, b, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert dw.launches == before + 1 and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-4 * float(want.float().abs().max()))


@pytest.mark.cuda
def test_cuda_dwconv_refuses_what_its_vectors_cannot_take(cuda):
    x = torch.randn((6, 7, 7, 12), device="cuda")  # 48 bytes of channels: fine in f32
    w = torch.randn((12, 7, 7), device="cuda")
    assert dw.cube_dwconv(x, w).shape == x.shape
    with pytest.raises(ValueError, match="multiple of 16"):
        dw.cube_dwconv(x[..., :10].contiguous(), w[:10])
    with pytest.raises(ValueError, match="7x7"):
        dw.cube_dwconv(x, w[:, 1:6, 1:6])
    with pytest.raises(TypeError, match="dtype"):
        dw.cube_dwconv(x, w.bfloat16())
    with pytest.raises(TypeError, match="dtype"):
        dw.cube_dwconv(x.bfloat16(), w.bfloat16(), out_dtype=torch.float32)


@pytest.mark.cuda
def test_cuda_forward_runs_the_kernel_and_never_pads(cuda, monkeypatch):
    """ConvNeXt-B's 36 depthwise convs are 36 launches a forward, eager,
    captured or replayed, and none pads a face or runs the plain version."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA forward padded a face or ran the plain depthwise conv")

    tree = convnext_params.init_convnext_params(2, num_classes=CLASSES)
    model = convnext_params.convnext_from_params(tree, device="cuda")
    for mod, name in ((layers, "pad_faces"), (dw, "plain_cube_dwconv")):
        monkeypatch.setattr(mod, name, refuse)
    x = torch.randn((2, 6, 224, 224, 3), device="cuda")
    counts = []
    with torch.no_grad():
        for run in (cam.cam_forward_eager, cam.cam_forward, cam.cam_forward, cam.cam_forward):
            before = dw.launches
            scores, _ = run(model, x)
            counts.append(dw.launches - before)
    torch.cuda.synchronize()
    assert counts == [36, 36, 36, 36] and len(cam.graphs_of(model)) == 1
    assert bool(torch.isfinite(scores).all())
