"""The port's Swin Transformer (``models/swin.py``) and its window attention
on cube faces (``ops/cube_window_attn.py``), against the benchmark's plain
float32 reference (``benchmark/reference/swin.py``).

On the CPU, on 224 px faces (every stage grid a multiple of the 7x7 window)
at widths cut to 32-64-128-256 (heads 1-2-4-8, 32 channels a head) and
depths 2-2-2-2, the window kept:

- the backbone and its CAM, built through ``SwinTransformer``'s constructor
  from ``benchmark/lib/weights_swin.py``'s seeded tensors: in float32 as
  the reference computes, cube-padded and as the published roll and mask;
  in bf16 within a bound that the reference rounded to float8 exceeds, and
  that two broken references exceed too: without the relative-position
  bias, and with the shifted layers' out-of-face slots masked as planar
  Swin masks its wrapped ones;
- in the first shifted layer, the tokens whose window lies inside the face
  equal planar Swin's, and the tokens at the face's edges do not;
- the shifted windows' map against the reference's, the window attention's
  plain form against a gather, matmuls and a softmax written out here, and
  the logits as the CAM's mean plus the bias;
- ``stream_video_saliency`` and the stream CLI (``--arch swin_base``, and
  ``convnext_base``) on a tiny clip.

On the card (``cuda`` marker, skipped without one): the kernel against its
plain form at Swin-B's four stage shapes, shifted and regular, and in the
rolled form; a forward whose replays of the stage-1 graph equal the eager
forward bit for bit, with the kernel's launches and windows counted through
them.  This file imports neither JAX nor the JAX package, so on a machine
with the card alone:

    python -m pytest tests/test_torch_swin.py --noconftest -q
"""

import cv2
import numpy as np
import pytest
import torch

from benchmark.lib import port, weights_swin
from benchmark.lib.weights import make_clstm
from benchmark.reference import model as ref
from benchmark.reference import swin as ref_swin
from cp360_tpu_torch.cli import stream_saliency
from cp360_tpu_torch.compat import convnext_params, jax_params, swin_params
from cp360_tpu_torch.models import cam, swin
from cp360_tpu_torch.models.swin import SwinTransformer
from cp360_tpu_torch.ops import cube_window_attn as wa
from cp360_tpu_torch.ops.cube_pad import build_cube_pad_index_map
from cp360_tpu_torch.pipelines.extract import host_equi_to_cube_u8
from cp360_tpu_torch.pipelines.stream import stream_video_saliency

torch.set_num_threads(2)
CPU = torch.device("cpu")
CLASSES = 16
FACE = 224
CUT = (32, (2, 2, 2, 2), (1, 2, 4, 8))  # embed, depths, heads: widths and depths cut
# f32 against the f32 reference: the same operations, summed in another order
F32_RTOL = 1e-5
# bf16 keeps 8 significant bits: the scores read 0.0128 of their largest
# magnitude at the cut shapes (seed 5); float8 e4m3 keeps 4 and reads 0.22,
# the reference without its relative-position bias 0.29 and with planar
# Swin's masked edges 0.36.  The bound sits 4x above the one and 4x below
# the others.
BF16_BOUND = 0.05
# a float32 map against the float32 reference, both from CAM cubes rounded
# to float16 as the stream keeps them: a score within f32 reassociation
# error of a float16 rounding boundary lands one float16 ulp (2^-11) away,
# which the map's min/max normalisation scales up; 1.19e-4 to 1.30e-4 of
# the map's range over three seeds at the cut shapes
F32_MAP_RTOL = 5e-4
MEAN, STD = torch.tensor(ref.IMAGENET_MEAN), torch.tensor(ref.IMAGENET_STD)


def _backbone(seed, dtype=torch.float32, shape=CUT):
    embed, depths, heads = shape
    return weights_swin.make_backbone(embed, depths, heads, 7, CLASSES, seed, CPU, dtype)


def _faces(seed, n=1):
    return torch.rand((n, 6, FACE, FACE, 3), generator=torch.Generator().manual_seed(seed))


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _ref_scores(bb, faces, quant=None, **kw):
    return ref.cam_scores(bb, ref_swin.swin_features(bb, faces, quant, **kw), quant)


@pytest.mark.parametrize("cube", [True, False], ids=["cube", "roll-and-mask"])
def test_swin_equals_the_reference_in_f32(cube):
    bb, faces = _backbone(2 ** 31 + 5), _faces(2)
    with torch.no_grad():
        got, _ = cam.cam_forward(SwinTransformer(bb, cube, torch.float32).eval(),
                                 (faces - MEAN) / STD)
        want = _ref_scores(bb, faces, use_cube_pad=cube)
    assert got.shape == want.shape == (1, 6, 7, 7, CLASSES)
    torch.testing.assert_close(got, want, rtol=0, atol=F32_RTOL * float(want.abs().max()))


@pytest.fixture(scope="module")
def bf16_gaps():
    """The bf16 port's gap from the f32 reference, and the gaps of the
    float8 control and of the two broken references."""
    bb, faces = _backbone(5, torch.bfloat16), _faces(1)
    no_bias = dict(bb, stages=[[dict(p, table=torch.zeros_like(p["table"])) for p in stage]
                               for stage in bb["stages"]])
    with torch.no_grad():
        got, _ = cam.cam_forward(SwinTransformer(bb, True, torch.bfloat16).eval(),
                                 (faces - MEAN) / STD)
        want = _ref_scores(bb, faces)
        return {"bf16": _rel(got, want),
                "fp8": _rel(_ref_scores(bb, faces, ref.quantize_fp8), want),
                "no-bias": _rel(_ref_scores(no_bias, faces), want),
                "masked-edges": _rel(_ref_scores(bb, faces, mask_edges=True), want)}


def test_swin_in_bf16_is_within_a_bound_that_fp8_exceeds(bf16_gaps):
    """The reference takes the same bf16 kernels, widened to float32, so
    the gap is the working precision's alone."""
    assert bf16_gaps["bf16"] < BF16_BOUND < bf16_gaps["fp8"]


@pytest.mark.parametrize("mutant", ["no-bias", "masked-edges"])
def test_broken_references_fall_outside_the_bound(bf16_gaps, mutant):
    assert bf16_gaps[mutant] > BF16_BOUND


def test_masked_edges_are_planar_swin():
    """Masking a cube-padded window's out-of-face slots gives each own-face
    token the keys and relative positions of the published rolled and
    masked window."""
    bb, faces = _backbone(6), _faces(6)
    with torch.no_grad():
        masked = ref_swin.swin_features(bb, faces, mask_edges=True)
        planar = ref_swin.swin_features(bb, faces, use_cube_pad=False)
    torch.testing.assert_close(masked, planar, rtol=0, atol=1e-5 * float(planar.abs().max()))


def test_first_shifted_layer_equals_planar_swin_inside_the_face_only():
    """Stage 1's second block on the same input, cube-padded and rolled:
    equal where the token's shifted window lies inside the face (rows and
    columns 3..51 of 56), different at every edge row and column."""
    bb = _backbone(7)
    x = torch.randn((6, 56, 56, 32), generator=torch.Generator().manual_seed(7))
    blk = swin.Block(bb["stages"][0][1], torch.float32)
    with torch.no_grad():
        cube, planar = blk(x, True, True, torch.float32), blk(x, True, False, torch.float32)
    inside = slice(3, 52)
    torch.testing.assert_close(cube[:, inside, inside], planar[:, inside, inside],
                               rtol=0, atol=1e-5)
    gap = (cube - planar).abs().amax(dim=(0, 3))  # [56, 56]
    edge = torch.ones(56, dtype=torch.bool)
    edge[inside] = False
    assert bool((gap[edge, :].amax(dim=1) > 1e-3).all())
    assert bool((gap[:, edge].amax(dim=0) > 1e-3).all())


def test_roll_and_mask_block_is_the_published_transcription():
    """``use_cube_pad`` False: the port's shifted block against the
    reference's roll, partition, mask, reverse and roll back."""
    bb = _backbone(8)
    x = torch.randn((1, 6, 28, 28, 64), generator=torch.Generator().manual_seed(8))
    p = bb["stages"][1][1]
    with torch.no_grad():
        got = swin.Block(p, torch.float32)(x.reshape(6, 28, 28, 64), True, False, torch.float32)
        want = ref_swin.swin_block(p, x, True, use_cube_pad=False)
    torch.testing.assert_close(got, want.reshape(got.shape), rtol=0, atol=1e-5)


def test_cam_mean_plus_the_bias_is_the_logits():
    bb, faces = _backbone(3), _faces(3)
    with torch.no_grad():
        logits, feats = SwinTransformer(bb, True, torch.float32).eval()((faces - MEAN) / STD)
        want = ref_swin.logits(bb, faces).reshape(6, CLASSES)
    atol = F32_RTOL * float(want.abs().max())
    torch.testing.assert_close(logits, want, rtol=0, atol=atol)
    torch.testing.assert_close(feats.mean(dim=(1, 2)) @ bb["fc_w"] + bb["fc_b"], logits,
                               rtol=0, atol=atol)


# ---- the window attention ----------------------------------------------------------


@pytest.mark.parametrize("s", [56, 28, 14, 7])
def test_shifted_windows_are_the_cube_pad_of_4_and_3(s):
    """The reference's map, composed from its equal-pad maps and the
    published corner rule, is the port's; each face token is the own slot
    of exactly one window; faces of S have (S/7 + 1)^2 windows."""
    want = build_cube_pad_index_map(s, s, (4, 3, 4, 3))
    np.testing.assert_array_equal(ref_swin.shift_pad_map(s), want)
    src, meta = wa.window_maps(s, 7, True)
    assert src.shape == (6 * (s // 7 + 1) ** 2, 49)
    own = src[(meta & 1).astype(bool)]
    np.testing.assert_array_equal(np.sort(own), np.arange(6 * s * s))
    assert (meta >> 1).max() == 0
    # the first window of face 0 is its padded top-left corner
    np.testing.assert_array_equal(src[0].reshape(7, 7), want[0, :7, :7])


def _attn_inputs(s, c, heads, seed, dtype=torch.float32, n=1):
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((n * 6, s, s, 3 * c), generator=gen).to(dtype)
    bias = 0.5 * torch.randn(3 * c, generator=gen)
    table = torch.randn((169, heads), generator=gen)
    return qkv, bias, table


def _written_out(qkv, bias, table, heads, shift, cube):
    """Window attention written out: the faces cube-padded (or rolled) as
    tokens, 7x7 windows cut by reshapes, q k^T / sqrt(d) plus the table
    gathered pair by pair (plus the rolled form's mask), softmax, times v,
    the own-face part kept."""
    n6, s, _, c3 = qkv.shape
    c, d = c3 // 3, c3 // 3 // heads
    t, g = (qkv.float() + bias).reshape(n6 // 6, 6, s, s, c3), s
    if shift and cube:
        idx = torch.from_numpy(ref_swin.shift_pad_map(s).reshape(-1))
        t, g = t.reshape(n6 // 6, 6 * s * s, c3)[:, idx], s + 7
    elif shift:
        t = torch.roll(t, shifts=(-3, -3), dims=(2, 3))
    t = t.reshape(n6, g // 7, 7, g // 7, 7, 3, heads, d).permute(5, 0, 1, 3, 6, 2, 4, 7)
    q, k, v = t.reshape(3, n6, (g // 7) ** 2, heads, 49, d)
    pos = [(i // 7, i % 7) for i in range(49)]
    bias_hij = torch.empty((heads, 49, 49))
    for i, (ri, ci) in enumerate(pos):
        for j, (rj, cj) in enumerate(pos):
            bias_hij[:, i, j] = table[(ri - rj + 6) * 13 + (ci - cj + 6)]
    scores = q @ k.transpose(-1, -2) / d ** 0.5 + bias_hij
    if shift and not cube:
        scores = scores + ref_swin._roll_mask(s, 7, CPU)[None, :, None]
    o = scores.softmax(-1) @ v  # [n6, nw, heads, 49, d]
    o = o.permute(0, 1, 3, 2, 4).reshape(n6, g // 7, g // 7, 7, 7, c)
    o = o.permute(0, 1, 3, 2, 4, 5).reshape(n6, g, g, c)
    if shift and cube:
        return o[:, 4:4 + s, 4:4 + s]
    return torch.roll(o, shifts=(3, 3), dims=(1, 2)) if shift else o


@pytest.mark.parametrize("shift,cube", [(False, True), (True, True), (True, False)],
                         ids=["regular", "shifted", "rolled"])
def test_plain_window_attn_is_gather_matmul_softmax(shift, cube):
    qkv, bias, table = _attn_inputs(14, 64, 2, 11)
    got = wa.cube_window_attn(qkv, bias, table, 2, 7, shift, cube)  # a CPU tensor: plain
    want = _written_out(qkv, bias, table, 2, shift, cube)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_plain_window_attn_rounds_where_the_kernel_does():
    """In bf16 q, k, v and the softmax's numerators are rounded once; the
    result is the f32 computation on those rounded values, rounded once."""
    qkv, bias, table = _attn_inputs(14, 64, 2, 12, torch.bfloat16)
    got = wa.plain_window_attn(qkv, bias, table, 2, 7, True)
    f32 = wa.plain_window_attn((qkv.float() + bias).to(torch.bfloat16).float(), None, table,
                               2, 7, True)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), f32, rtol=2.0 ** -7, atol=2e-2)


def test_window_attn_checks_its_arguments():
    qkv, bias, table = _attn_inputs(14, 64, 2, 13)
    with pytest.raises(ValueError, match="square faces"):
        wa.cube_window_attn(qkv[:5], bias, table, 2, 7, False)
    with pytest.raises(ValueError, match="heads for"):
        wa.cube_window_attn(qkv, bias, table, 3, 7, False)
    with pytest.raises(ValueError, match="relative-position table"):
        wa.cube_window_attn(qkv, bias, table[:100], 2, 7, False)
    with pytest.raises(ValueError, match="do not tile"):
        wa.cube_window_attn(qkv[:, :12, :12].contiguous(), bias, table, 2, 7, False)


def test_stage_grids_refuse_faces_the_window_does_not_tile():
    assert swin.stage_grids(224) == [(56, True), (28, True), (14, True), (7, False)]
    assert swin.stage_grids(448)[3] == (14, True)
    for face in (96, 192, 256, 230):
        with pytest.raises(ValueError, match=f"of {face} px faces"):
            swin.stage_grids(face)


# ---- the constructors and the entry points -------------------------------------------


def test_backbone_from_params_builds_swin_b():
    tree = jax_params.init_backbone_params(1, "swin_base")
    model = jax_params.backbone_from_params(tree, "swin_base", True, torch.bfloat16)
    assert isinstance(model, SwinTransformer) and model.arch == "swin_base"
    assert (model.embed, model.depths, model.heads) == swin.ARCHS["swin_base"]
    assert sum(t.numel() for t in model.buffers()) == 87_768_224
    blk = model.stages[2][17]
    assert blk.table.shape == (169, 16) and blk.qkv.w.shape == (1536, 512, 1, 1)
    assert blk.fc1.w.permute(0, 2, 3, 1).is_contiguous()  # OHWI memory
    assert "swin_base" not in jax_params.BACKBONES  # the JAX package's families alone
    assert all(jax_params.is_backbone(a) for a in ("swin_base", "convnext_base", "resnet50"))
    assert not jax_params.is_backbone("swin_huge")


def test_the_port_tree_and_the_benchmark_layout_build_the_same_model():
    tree = swin_params.init_swin_params(4, depths=(1, 2, 1, 2), embed=32, num_classes=CLASSES)
    model = swin_params.swin_from_params(tree, compute_dtype=torch.float32)
    assert model.arch == "swin" and model.heads == (1, 2, 4, 8)
    blk = tree["stages"][1][1]
    np.testing.assert_array_equal(model.stages[1][1].qkv.w[:, :, 0, 0].numpy(),
                                  blk["qkv"]["w"].T)
    np.testing.assert_array_equal(model.stages[1][1].table.numpy(), blk["rel_bias"])
    faces = _faces(4)
    with torch.no_grad():
        got = cam.cam_forward(model, faces)[0]
        bb = {"stem": {"w": model.stem.w, "b": model.stem.b, "ln_w": model.stem_norm.w,
                       "ln_b": model.stem_norm.b},
              "merges": [{"ln_w": m.norm.w, "ln_b": m.norm.b, "w": m.reduction.w}
                         for m in model.merges],
              "stages": [[{"ln1_w": b.norm1.w, "ln1_b": b.norm1.b, "w_qkv": b.qkv.w,
                           "b_qkv": b.qkv.b, "table": b.table, "w_proj": b.proj.w,
                           "b_proj": b.proj.b, "ln2_w": b.norm2.w, "ln2_b": b.norm2.b,
                           "w1": b.fc1.w, "b1": b.fc1.b, "w2": b.fc2.w, "b2": b.fc2.b}
                          for b in stage] for stage in model.stages],
              "head": {"ln_w": model.head_norm.w, "ln_b": model.head_norm.b},
              "fc_w": model.cam_w, "fc_b": model.cam_b}
        assert torch.equal(cam.cam_forward(SwinTransformer(bb, True, torch.float32), faces)[0],
                           got)


def test_the_residual_stream_is_f32_and_each_branch_bf16(monkeypatch):
    tree = swin_params.init_swin_params(5, depths=(2, 2, 2, 2), embed=32,
                                        num_classes=CLASSES)
    model = swin_params.swin_from_params(tree, compute_dtype=torch.bfloat16)
    seen, sums = [], []
    real = swin.cube_window_attn

    def spy(qkv, *a, **k):
        y = real(qkv, *a, **k)
        seen.append((qkv.dtype, y.dtype))
        return y

    monkeypatch.setattr(swin, "cube_window_attn", spy)
    for stage in model.stages:
        for blk in stage:
            blk.register_forward_hook(lambda m, i, o: sums.append((i[0].dtype, o.dtype)))
    with torch.no_grad():
        _, feats = model(torch.randn(1, 6, FACE, FACE, 3))
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 8
    assert sums == [(torch.float32, torch.float32)] * 8
    assert feats.dtype == torch.bfloat16


def _clip(path, n=12, size=(256, 128), seed=3):
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
    """Every map of a 12-frame clip in batches of 4 against the reference's
    window over the same frames, as ConvNeXt's test holds its stream: the
    reference takes the faces the stream remapped on the host and rounds its
    scores to float16, as the stream keeps its CAM cubes."""
    cfg = {"arch": "swin_base", "num_classes": CLASSES,
           "config": {"cube_dim": FACE, "compute_dtype": "float32", "equi_h": 256,
                      "equi_w": 128, "input_size": CLASSES, "hidden_size": CLASSES,
                      "seq_len": 5}}
    bb = _backbone(2 ** 31 + 9)
    cl = make_clstm(CLASSES, CLASSES, 3, CPU, torch.float32)
    path, frames = _clip(tmp_path / "clip.mp4")
    maps = dict(stream_video_saliency(SwinTransformer(bb, True, torch.float32).eval(),
                                      port.clstm(cfg, cl), path, port.program_config(cfg),
                                      stage1_batch=4))
    assert sorted(maps) == list(range(4, len(frames) - 1))
    faces = torch.from_numpy(np.stack([host_equi_to_cube_u8(f, FACE) for f in frames]))
    with torch.no_grad():
        scores = _ref_scores(bb, faces.float() / 255).half().float()
        for m, got in maps.items():
            want = ref.window_saliency(cl, scores[None, m - 4:m + 1])[0]
            np.testing.assert_allclose(got, want.numpy(), rtol=0,
                                       atol=F32_MAP_RTOL * float(want.max() - want.min()))


@pytest.mark.parametrize("arch,face", [("swin_base", 224), ("convnext_base", 96)])
def test_stream_cli_takes_the_ports_own_families(arch, face, tmp_path):
    """``--arch`` admits the port's own families: a cut tree of each streams
    a tiny clip on the CPU to one finite map."""
    if arch == "swin_base":
        tree = swin_params.init_swin_params(1, depths=(2, 2, 2, 2), embed=32,
                                            num_classes=CLASSES)
    else:
        tree = convnext_params.init_convnext_params(1, depths=(1, 1, 1, 1),
                                                    dims=(16, 32, 64, 128), num_classes=CLASSES)
    jax_params.save_npz(str(tmp_path / "bb.npz"), tree)
    jax_params.save_npz(str(tmp_path / "cl.npz"), jax_params.init_clstm_params(2, CLASSES,
                                                                               CLASSES))
    (tmp_path / "config.yaml").write_text(
        f"equi_h: 256\nequi_w: 128\ncube_dim: {face}\nseq_len: 5\ncompute_dtype: float32\n"
        "opt_flow: false\n")
    video, _ = _clip(tmp_path / "v.mp4", n=6)
    out = tmp_path / "sal"
    assert stream_saliency.main(
        ["--video", video, "--backbone", str(tmp_path / "bb.npz"), "--clstm",
         str(tmp_path / "cl.npz"), "--out", str(out), "--arch", arch, "--max-frames", "6",
         "--stage1-batch", "4", "--config", str(tmp_path / "config.yaml"),
         "--device", "cpu"]) == 1
    got = np.load(out / "00004.npy")
    assert got.shape == (face // 32 * 2, face // 32 * 4) and np.isfinite(got).all()
    with pytest.raises(ValueError, match="unknown --arch 'swin_huge'"):
        stream_saliency.main(["--video", video, "--backbone", "b.npz", "--clstm", "c.npz",
                              "--out", str(out), "--arch", "swin_huge", "--device", "cpu"])


# ---- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the cube_window_attn kernel runs on the card only")
    return torch.device("cuda")


STAGES = [(56, 128, 4), (28, 256, 8), (14, 512, 16), (7, 1024, 32)]  # Swin-B on 224 faces


@pytest.mark.cuda
@pytest.mark.parametrize("s,c,heads", STAGES, ids=[f"{s}x{s}x{ch}" for s, ch, _ in STAGES])
@pytest.mark.parametrize("shift,cube", [(False, True), (True, True), (True, False)],
                         ids=["regular", "shifted", "rolled"])
def test_cuda_window_attn_equals_its_plain_form(cuda, s, c, heads, shift, cube):
    """Both round q, k, v and the softmax's numerators to bf16 and sum in
    f32; they differ in the order of the sums and in exp2f against exp, so
    the outputs agree within one bf16 ulp of each value plus 1e-2 of the
    largest (an output is a weighted mean of v: where it cancels to near
    zero the relative error of its terms shows)."""
    if shift and s == 7:
        pytest.skip("a grid of one window is not shifted (the published rule)")
    gen = torch.Generator(device="cuda").manual_seed(s + int(shift) + 2 * int(cube))
    qkv = torch.randn((48, s, s, 3 * c), generator=gen, device="cuda").to(torch.bfloat16)
    bias = 0.5 * torch.randn(3 * c, generator=gen, device="cuda")
    table = torch.randn((169, heads), generator=gen, device="cuda")
    with torch.no_grad():
        before, wins = wa.launches, wa.windows
        got = wa.cube_window_attn(qkv, bias, table, heads, 7, shift, cube)
        want = wa.plain_window_attn(qkv, bias, table, heads, 7, shift, cube)
    torch.cuda.synchronize()
    assert wa.launches == before + 1
    assert wa.windows == wins + 48 * wa.windows_per_face(s, 7, shift, cube)
    assert got.dtype == torch.bfloat16 and got.shape == (48, s, s, c)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-2 * float(want.float().abs().max()))


@pytest.mark.cuda
def test_cuda_window_attn_refuses_what_it_cannot_take(cuda):
    qkv = torch.randn((6, 14, 14, 192), device="cuda")
    table = torch.randn((169, 2), device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        wa.cube_window_attn(qkv, None, table, 2, 7, True)
    with pytest.raises(ValueError, match="heads of 32"):
        wa.cube_window_attn(qkv.bfloat16(), None, torch.randn((169, 4), device="cuda"), 4, 7,
                            True)


@pytest.mark.cuda
def test_cuda_forward_replays_the_eager_forward_bit_for_bit(cuda, monkeypatch):
    """Swin-B's 24 window attentions are 24 launches a forward, eager,
    captured or replayed, never the plain form, and a replay's CAM and
    features equal the eager forward's bit for bit."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA forward ran the plain window attention")

    tree = swin_params.init_swin_params(2, num_classes=CLASSES)
    model = swin_params.swin_from_params(tree, device="cuda")
    monkeypatch.setattr(wa, "plain_window_attn", refuse)
    x = torch.randn((2, 6, 224, 224, 3), device="cuda")
    per_face = sum(d * (wa.windows_per_face(g, 7, False) + wa.windows_per_face(g, 7, sh))
                   for (g, sh), d in zip(swin.stage_grids(224), (1, 1, 9, 1)))
    counts, outs = [], []
    with torch.no_grad():
        for run in (cam.cam_forward_eager, cam.cam_forward, cam.cam_forward, cam.cam_forward):
            before, wins = wa.launches, wa.windows
            outs.append(run(model, x))
            counts.append((wa.launches - before, wa.windows - wins))
    torch.cuda.synchronize()
    assert counts == [(24, 12 * per_face)] * 4 and len(cam.graphs_of(model)) == 1
    for scores, feats in outs[1:]:
        assert torch.equal(scores, outs[0][0]) and torch.equal(feats, outs[0][1])
    assert bool(torch.isfinite(outs[0][0]).all())
