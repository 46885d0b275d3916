"""PyTorch port, the offline video pipeline's modules against the JAX
package on the CPU: metrics, the int8 codec, window inference over an
artifact directory (``infer_video``), evaluation and aggregation, the
extraction loop, the overlay, and the refusals.

Sizes are cut for the CPU (ConvLSTM 8/8 on [6, 7, 7, 8] cubes, seq_len 5,
f32; extraction on 64-pixel faces with a 16-class CAM); the code paths are
the full-width ones.  Inputs come from seeded numpy.  Tolerances: metrics
equal to 1e-12 (same numpy arithmetic, same RNG stream); codec scales and
q equal, dequantized values within 1 f32 ulp; window predictions within
1e-5; extracted artifacts byte-equal between the two entry points of the
port; stage-1 CAMs within 1e-4 of their largest value against the JAX
package (He-initialized weights grow activations, so the bound scales).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp360_tpu.metrics import saliency as jax_metrics
from cp360_tpu.ops import quantize as jax_quantize
from cp360_tpu.pipelines import extract as jax_extract
from cp360_tpu.pipelines import temporal as jax_temporal
from cp360_tpu_torch.compat import jax_params
from cp360_tpu_torch.config import Config
from cp360_tpu_torch.metrics import saliency as metrics
from cp360_tpu_torch.ops import quantize
from cp360_tpu_torch.pipelines import extract, temporal

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(__file__), "golden")
METRICS = np.load(os.path.join(GOLD, "metrics.npz"))
SEQ = 5
C = 8


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---- metrics -----------------------------------------------------------------


@pytest.mark.parametrize("have_cv2", [True, False])
@pytest.mark.parametrize("i", [0, 1, 2])
def test_metrics_equal_jax(monkeypatch, have_cv2, i):
    """The four metrics on the metric golden's maps, after the same
    np.random.seed, in both resize branches (cv2 and numpy)."""
    monkeypatch.setattr(metrics, "_HAVE_CV2", have_cv2)
    monkeypatch.setattr(jax_metrics, "_HAVE_CV2", have_cv2)
    sal, gt = METRICS[f"sal{i}"], METRICS[f"gt{i}"]
    got, want = [], []
    for mod, out in ((metrics, got), (jax_metrics, want)):
        np.random.seed(123 + i)
        out += [mod.auc_judd(sal.copy(), gt.copy()), mod.auc_borji(sal.copy(), gt.copy()),
                mod.corr_coeff(sal, gt), mod.similarity(sal, gt)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # and the golden's own numbers (reference eval_saliency.py)
    assert got[0] == pytest.approx(float(METRICS[f"auc_judd{i}"]), abs=1e-10)


def test_metric_resize_branches_agree():
    m = np.random.RandomState(0).rand(14, 28).astype(np.float32)
    want = metrics.resize_eval(m)
    got = metrics._resize_bilinear_np(m, 120, 240)
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---- the int8 codec ------------------------------------------------------------


@pytest.mark.parametrize("scale_dtype", ["float32", "float16"])
def test_codec_equals_jax(scale_dtype):
    rng = np.random.RandomState(3)
    x = (rng.gamma(0.5, 2.0, (3, 6, 7, 7, 40)) * (rng.rand(40) > 0.2)).astype(np.float32)
    x[0, 1, :, :, 5] = 0.0  # a constant-zero channel
    tdt, ndt = getattr(torch, scale_dtype), getattr(np, scale_dtype)
    q, s = quantize.quantize_cam(torch.from_numpy(x), tdt)
    jq, js = jax_quantize.quantize_cam(jnp.asarray(x), getattr(jnp, scale_dtype))
    assert q.dtype == torch.int8 and s.dtype == tdt
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    nq, ns = quantize.quantize_cam_np(x, ndt)
    np.testing.assert_array_equal(nq, q.numpy())
    np.testing.assert_array_equal(ns, s.numpy())
    deq = quantize.dequantize_cam(q, s).numpy()
    jdeq = np.asarray(jax_quantize.dequantize_cam(jq, js))
    ulp = np.spacing(np.abs(jdeq).astype(np.float32))
    assert np.all(np.abs(deq - jdeq) <= ulp)
    np.testing.assert_array_equal(quantize.dequantize_cam_np(nq, ns), deq)
    assert np.all(deq[0, 1, :, :, 5] == 0.0)


# ---- window inference over an artifact directory --------------------------------


def _write_artifacts(root, n_frames=13, seed=4):
    """One video's cube_feat dir ([6, C, 7, 7] f16, numbered from 000002)
    and GT maps (120x240, a few Gaussian blobs) for every window end."""
    rng = np.random.RandomState(seed)
    feat = root / "vid" / "cube_feat"
    feat.mkdir(parents=True)
    for i in range(2, 2 + n_frames):
        np.save(feat / f"{i:06}.npy", rng.gamma(0.5, 2.0, (6, C, 7, 7)).astype(np.float16))
    (feat / "000099.npy.tmp").write_bytes(b"torn")  # a crashed writer's leftover
    gt = root / "gt"
    gt.mkdir()
    yy, xx = np.mgrid[0:120, 0:240]
    for idx in range(n_frames - SEQ):
        m = np.zeros((120, 240), np.float32)
        for _ in range(3):
            cy, cx = rng.randint(10, 110), rng.randint(10, 230)
            m += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 40.0).astype(np.float32)
        np.save(gt / f"{idx + SEQ - 1:05}.npy", m)
    return str(feat), str(gt)


@pytest.fixture(scope="module")
def clstm_tree():
    return jax_params.init_clstm_params(5, C, C)


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    return _write_artifacts(tmp_path_factory.mktemp("video"))


def test_window_infer_from_frames_equals_jax(clstm_tree):
    rng = np.random.RandomState(6)
    frames = rng.gamma(0.5, 2.0, (9, 6, 7, 7, C)).astype(np.float32)
    positions = np.array([0, 3, 4, 2], np.int64)
    cell = jax_params.clstm_from_params(clstm_tree, torch.float32)
    with torch.no_grad():
        got = temporal.window_infer_from_frames(
            cell, torch.from_numpy(frames), torch.from_numpy(positions), SEQ)
        q, s = quantize.quantize_cam_np(frames, np.float16)
        got_q = temporal.window_infer_from_frames_q(
            cell, torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(positions), SEQ)
    want = jax_temporal.window_infer_from_frames(
        _jax(clstm_tree), jnp.asarray(frames), jnp.asarray(positions, jnp.int32),
        seq_len=SEQ, compute_dtype=jnp.float32)
    want_q = jax_temporal.window_infer_from_frames_q(
        _jax(clstm_tree), jnp.asarray(q), jnp.asarray(s), jnp.asarray(positions, jnp.int32),
        seq_len=SEQ, compute_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), atol=1e-5, rtol=0)


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_infer_video_and_metrics_equal_jax(clstm_tree, video, codec):
    """13 frames -> 8 windows in batches of 3 (an uneven tail batch)."""
    feat_dir, gt_dir = video
    assert temporal.video_windows(feat_dir) == jax_temporal.video_windows(feat_dir)
    cell = jax_params.clstm_from_params(clstm_tree, torch.float32)
    got = temporal.infer_video(cell, feat_dir, SEQ, batch_windows=3, transfer_codec=codec)
    want = jax_temporal.infer_video(_jax(clstm_tree), feat_dir, SEQ, batch_windows=3,
                                    compute_dtype=jnp.float32, transfer_codec=codec)
    assert sorted(got) == sorted(want) == list(range(8))
    for k in want:
        assert got[k].shape == (14, 28) and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0)

    # evaluation replays the same np.random stream: identical metrics on
    # identical predictions, and within the predictions' own error on ours
    np.random.seed(7)
    res = temporal.evaluate_video(want, gt_dir, SEQ)
    np.random.seed(7)
    jres = jax_temporal.evaluate_video(want, gt_dir, SEQ)
    for key in ("AUC", "AUCB", "CC", "SIM"):
        assert res[key].shape == (8,)
        np.testing.assert_allclose(res[key], jres[key], rtol=0, atol=1e-12)
    per_video = {"a": res, "b": {k: v[:5] for k, v in res.items()}}
    counts = {"a": 13, "b": 9}
    agg, jagg = temporal.aggregate(per_video, counts), jax_temporal.aggregate(per_video, counts)
    assert agg == pytest.approx(jagg, abs=1e-12)
    np.random.seed(7)
    ours = temporal.evaluate_video(got, gt_dir, SEQ)
    np.testing.assert_allclose(ours["CC"], res["CC"], atol=1e-4)


def test_infer_video_short_video_has_no_windows(clstm_tree, tmp_path):
    feat = tmp_path / "cube_feat"
    feat.mkdir()
    for i in range(2, 2 + SEQ):  # seq_len frames -> 0 windows (reference bound)
        np.save(feat / f"{i:06}.npy", np.ones((6, C, 7, 7), np.float16))
    cell = jax_params.clstm_from_params(clstm_tree, torch.float32)
    assert temporal.infer_video(cell, str(feat), SEQ) == {}


def test_infer_video_rejects_unknown_codec(clstm_tree, video):
    cell = jax_params.clstm_from_params(clstm_tree, torch.float32)
    with pytest.raises(ValueError):
        temporal.infer_video(cell, video[0], SEQ, transfer_codec="auto")


# ---- extraction ------------------------------------------------------------------


ROWS, COLS, CD = 32, 64, 64  # frames are 32x64; 64-pixel faces -> 2x2 CAM maps


@pytest.fixture(scope="module")
def resnet_tree():
    return jax_params.init_resnet_params(8, "resnet50", num_classes=16)


def _small_cfg(**kw):
    base = dict(equi_h=COLS, equi_w=ROWS, cube_dim=CD, extract_batch=4, opt_flow=False,
                compute_dtype="float32", feat_dtype="float16", host_cube_remap=False)
    base.update(kw)
    return Config(**base)


def _bgr_frames(n, seed=9, shape=(ROWS, COLS)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (*shape, 3)).astype(np.uint8) for _ in range(n)]


@pytest.mark.parametrize("remap", [False, True])
def test_extract_frames_writes_stage1_batch_outputs(resnet_tree, tmp_path, remap):
    """7 frames -> artifacts 000002..000007 holding frames 0..5 (the
    reference's lag), in batches of 4 (the tail padded), each equal to the
    JAX package's stage-1 step on that frame; then a resumed run writes
    nothing."""
    cfg = _small_cfg(host_cube_remap=remap)
    model = jax_params.resnet_from_params(resnet_tree, compute_dtype=torch.float32)
    frames = _bgr_frames(7)
    out = tmp_path / "vid"
    n = extract.extract_frames(model, cfg, iter(frames), str(out), output_img=True)
    assert n == 6
    names = sorted(os.listdir(out / "cube_feat"))
    assert names == [f"{i:06}.npy" for i in range(2, 8)]
    assert sorted(os.listdir(out / "img")) == [f"{i:06}.jpg" for i in range(2, 8)]
    stack = np.stack(frames[:6])
    if remap:
        faces = np.stack([jax_extract.host_equi_to_cube_u8(f, CD) for f in stack])
        jscores, _ = jax_extract.stage1_batch_faces(
            _jax(resnet_tree), jnp.asarray(faces), compute_dtype=jnp.float32,
            out_dtype=jnp.float32)
    else:
        jscores, _ = jax_extract.stage1_batch(
            _jax(resnet_tree), jnp.asarray(stack), cube_dim=CD, compute_dtype=jnp.float32)
    jscores = np.asarray(jscores).transpose(0, 1, 4, 2, 3)
    for k in range(6):
        got = np.load(out / "cube_feat" / names[k])
        assert got.shape == (6, 16, 2, 2) and got.dtype == np.float16
        err = np.abs(got.astype(np.float32) - jscores[k]).max()
        # f16 storage (2^-11 relative) on top of the 1e-4 CAM parity
        assert err <= 2e-3 * np.abs(jscores[k]).max(), err

    before = {p: p.stat().st_mtime_ns for p in out.rglob("*") if p.is_file()}
    assert extract.extract_frames(model, cfg, iter(frames), str(out)) == 6
    after = {p: p.stat().st_mtime_ns for p in out.rglob("*") if p.is_file()}
    assert after == before


def test_extract_int8_codec_tracks_the_float_artifacts(resnet_tree, tmp_path):
    """host_cube_remap + transfer_codec int8: the written artifact is the
    dequantized cube, within one quantization step (amax/127 per face and
    channel) of the codec-free one, and the device step's q and scales
    equal the JAX package's codec on the same scores."""
    model = jax_params.resnet_from_params(resnet_tree, compute_dtype=torch.float32)
    frames = _bgr_frames(3, seed=10)
    outs = {}
    for codec in ("none", "int8"):
        cfg = _small_cfg(host_cube_remap=True, transfer_codec=codec, feat_dtype="float32")
        extract.extract_frames(model, cfg, iter(frames), str(tmp_path / codec),
                               output_img=False)
        outs[codec] = np.load(tmp_path / codec / "cube_feat" / "000002.npy")
    step = np.abs(outs["none"]).max(axis=(2, 3), keepdims=True) / 127.0
    assert np.all(np.abs(outs["int8"] - outs["none"]) <= 0.5 * step * 1.001 + 1e-7)

    faces = torch.from_numpy(np.stack([extract.host_equi_to_cube_u8(frames[0], CD)]))
    with torch.no_grad():
        q, s, _ = extract.stage1_batch_faces(model, faces, codec="int8")
        scores, _ = extract.stage1_batch_faces(model, faces, out_dtype=torch.float32)
    jq, js = jax_quantize.quantize_cam(jnp.asarray(scores.numpy()), jnp.float16)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_extract_frames_equals_extract_video(resnet_tree, tmp_path):
    """The decoded frames of a golden mp4 through extract_frames write the
    same bytes as extract_video on the mp4 (max_frames cuts it short)."""
    cv2 = pytest.importorskip("cv2")
    mp4 = os.path.join(GOLD, "e2e", "va1AmV24VSs_2.mp4")
    cap = cv2.VideoCapture(mp4)
    frames = []
    while len(frames) < 6:
        ok, frame = cap.read()
        assert ok
        frames.append(frame)
    cap.release()
    cfg = _small_cfg(equi_h=frames[0].shape[1] // 4, equi_w=frames[0].shape[0] // 4)
    model = jax_params.resnet_from_params(resnet_tree, compute_dtype=torch.float32)
    a = extract.extract_video(model, cfg, mp4, str(tmp_path / "video"), output_img=True,
                              max_frames=6)
    b = extract.extract_frames(model, cfg, frames, str(tmp_path / "frames"), output_img=True)
    assert a == b == 5
    for sub in ("cube_feat", "img"):
        names = sorted(os.listdir(tmp_path / "video" / sub))
        assert names == sorted(os.listdir(tmp_path / "frames" / sub)) and len(names) == 5
        for name in names:
            assert ((tmp_path / "video" / sub / name).read_bytes()
                    == (tmp_path / "frames" / sub / name).read_bytes())


def test_extract_video_missing_file_raises(resnet_tree, tmp_path):
    pytest.importorskip("cv2")
    model = jax_params.resnet_from_params(resnet_tree, compute_dtype=torch.float32)
    with pytest.raises(FileNotFoundError):
        extract.extract_video(model, _small_cfg(), str(tmp_path / "none.mp4"), str(tmp_path))


@pytest.mark.parametrize("shape", [(ROWS, COLS), (48, 80)])
def test_resize_frame_is_pil_lanczos(shape):
    """At the working size the frame passes without PIL; the bytes are
    what PIL's LANCZOS resize (a plain copy at equal size) gives."""
    from PIL import Image

    frame = _bgr_frames(1, seed=11, shape=shape)[0]
    got = extract._resize_frame(frame, _small_cfg())
    want, _ = jax_extract._resize_frame_pil(frame, (COLS, ROWS))
    assert got.shape == (ROWS, COLS, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    img = Image.fromarray(frame).resize((COLS, ROWS), resample=Image.LANCZOS)
    np.testing.assert_array_equal(got, np.asarray(img))


def test_overlay_equals_jax():
    from cp360_tpu.imaging import overlay as jax_overlay
    from cp360_tpu_torch.imaging import overlay

    img = _bgr_frames(1, seed=12)[0]
    heat = np.random.RandomState(13).rand(14, 28).astype(np.float32)
    np.testing.assert_array_equal(overlay.jet_colormap(heat), jax_overlay.jet_colormap(heat))
    np.testing.assert_array_equal(np.asarray(overlay.overlay(img, heat)),
                                  np.asarray(jax_overlay.overlay(img, heat)))


def test_atomic_writes_leave_no_temp(tmp_path):
    from cp360_tpu_torch.utils.atomic import atomic_save, atomic_savez

    atomic_save(str(tmp_path / "a.npy"), np.arange(3))
    atomic_savez(str(tmp_path / "b.npz"), x=np.ones(2))
    assert sorted(os.listdir(tmp_path)) == ["a.npy", "b.npz"]
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), np.arange(3))


# ---- refusals ---------------------------------------------------------------------


# optical flow and yuv420 run now: what still refuses is a value the
# extraction does not know
@pytest.mark.parametrize("kw,exc", [
    (dict(opt_flow=True, flow_backend="lucas_kanade"), ValueError),  # with output_motion
    (dict(host_cube_remap=True, upload_format="yuv422"), ValueError),
    (dict(transfer_codec="auto"), ValueError),
    (dict(opt_flow=True, flow_link_dtype="bfloat16"), ValueError),
])
def test_extract_refusals(resnet_tree, tmp_path, kw, exc):
    model = jax_params.resnet_from_params(resnet_tree, compute_dtype=torch.float32)
    with pytest.raises(exc, match="flow backend|upload_format|transfer_codec|flow_link_dtype"):
        extract.extract_frames(model, _small_cfg(**kw), iter(_bgr_frames(2)),
                               str(tmp_path), output_motion=True)


# unported options raise by the name of the ROADMAP.md item that ports them
@pytest.mark.parametrize("cli,argv,exc", [
    ("extract_features", ["-om", "--set", "flow_backend=lucas_kanade", "--device", "cpu"],
     ValueError),
    ("extract_features", ["--set", "opt_flow=false", "--set", "host_cube_remap=true",
                          "--set", "upload_format=yuv422", "--device", "cpu"],
     ValueError),
    ("extract_features", ["--set", "transfer_codec=auto", "--device", "cpu"], ValueError),
    ("extract_features", ["--data-parallel", "2", "--device", "cpu"], NotImplementedError),
    ("extract_features", ["--supervise", "--device", "cpu"], NotImplementedError),
    ("extract_features", ["--mode", "vgg16", "--device", "cpu"], NotImplementedError),
    ("test_temporal", ["--model", "x.npz", "--dir", "d", "--data-parallel", "2",
                       "--device", "cpu"], NotImplementedError),
    ("test_temporal", ["--model", "x.npz", "--dir", "d", "--supervise",
                       "--device", "cpu"], NotImplementedError),
    ("test_temporal", ["--model", "x.npz", "--dir", "d", "--set",
                       "transfer_codec=auto", "--device", "cpu"], ValueError),
])
def test_cli_refusals(tmp_path, monkeypatch, cli, argv, exc):
    import importlib

    monkeypatch.chdir(tmp_path)  # no ./config.yaml: built-in defaults
    mod = importlib.import_module(f"cp360_tpu_torch.cli.{cli}")
    items = '"trainer options" and "parallel"|"resnet18/34/101/152" and "vgg16-bn'
    with pytest.raises(exc, match=f"ROADMAP.md, ({items})|flow backend|upload_format|"
                                  "transfer_codec"):
        mod.main(argv)


@pytest.mark.parametrize("cli,argv", [
    ("extract_features", ["--set", "opt_flow=false"]),
    ("test_temporal", ["--model", "x.npz", "--dir", "d"]),
    ("eval_saliency", ["--input", "p", "--gt", "g"]),
])
def test_clis_default_to_the_card(tmp_path, monkeypatch, cli, argv):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"cp360_tpu_torch.cli.{cli}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)


def test_eval_saliency_cli_equals_jax(tmp_path, capsys):
    """Stage-2 maps and stage-1 cubes scored by both CLIs with one seed."""
    from cp360_tpu.cli import eval_saliency as jax_eval
    from cp360_tpu_torch.cli import eval_saliency
    from cp360_tpu_torch.data.dataset import builtin_split

    rng = np.random.RandomState(14)
    vids = builtin_split("test_25")[:2]
    yy, xx = np.mgrid[0:120, 0:240]
    for v in vids:
        (tmp_path / "pred" / v).mkdir(parents=True)
        (tmp_path / "cam" / v / "cube_feat").mkdir(parents=True)
        (tmp_path / "gt" / f"{v}.mp4").mkdir(parents=True)
        for i in range(4):
            np.save(tmp_path / "pred" / v / f"{i:05}.npy", rng.rand(14, 28).astype(np.float32))
            np.save(tmp_path / "cam" / v / "cube_feat" / f"{i + 2:06}.npy",
                    rng.rand(6, 5, 7, 7).astype(np.float16))
            cy, cx = rng.randint(10, 110), rng.randint(10, 230)
            np.save(tmp_path / "gt" / f"{v}.mp4" / f"{i:05}.npy",
                    np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 40.0).astype(np.float32))
    for src in ("pred", "cam"):
        argv = ["--input", str(tmp_path / src), "--gt", str(tmp_path / "gt"), "--seed", "3"]
        got = eval_saliency.main(argv + ["--json", str(tmp_path / "a.json"), "--device", "cpu"])
        jax_eval.main(argv + ["--json", str(tmp_path / "b.json")])
        import json

        a = json.loads((tmp_path / "a.json").read_text())
        b = json.loads((tmp_path / "b.json").read_text())
        assert a["videos"] == b["videos"] == 2 and got == a["aggregate"]
        for k, v in b["aggregate"].items():
            assert a["aggregate"][k] == pytest.approx(v, abs=1e-9 if src == "pred" else 1e-6)
