"""PyTorch port, the streaming entry point (video -> saliency, no artifacts)
against the JAX package and against the port's own offline path, on the CPU.

A seeded 12-frame 256x128 mp4v video, resnet18 with a 16-class CAM on
64-pixel faces, ConvLSTM 16/16, seq_len 5, f32, as ``tests/test_stream.py``
runs the JAX stream.  Tolerances: stage 1's f16 CAMs within one f16 ulp of
the JAX package's; the stream against the JAX resnet18 stream 1e-4
(absolute and relative), as ``tests/test_stream.py`` holds the JAX stream
against its offline path;
against the port's offline extract -> ``infer_video`` path 1e-5 (the same
f16 CAM cubes through the same code, in other window batches); a resumed
suffix, and the CLI's maps against the library's, bit for bit.  The
decode thread through a stub capture: how far it reads ahead, a read error
raised in order, closing, and the resume's grabs.
"""

import os
import threading
import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp360_tpu.config import Config as JaxConfig
from cp360_tpu.pipelines.stream import stream_video_saliency as jax_stream
from cp360_tpu_torch.cli import stream_saliency
from cp360_tpu_torch.compat import jax_params
from cp360_tpu_torch.config import Config
from cp360_tpu_torch.pipelines.extract import extract_video
from cp360_tpu_torch.pipelines.stream import (
    DECODE_AHEAD_BATCHES, _stream_frames, stream_video_saliency)
from cp360_tpu_torch.pipelines.temporal import infer_video

torch.set_num_threads(2)

CFG = dict(equi_h=256, equi_w=128, cube_dim=64, flow_h=32, seq_len=5,
           compute_dtype="float32", feat_dtype="float16", opt_flow=False, extract_batch=4,
           host_cube_remap=True)
CONFIG_YAML = ("equi_h: 256\nequi_w: 128\ncube_dim: 64\nseq_len: 5\ncompute_dtype: float32\n"
               "opt_flow: false\n")


def _video(path, n=12, seed=3, size=(256, 128)):
    rng = np.random.RandomState(seed)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10.0, size)
    base = (rng.rand(size[1], size[0], 3) * 255).astype(np.uint8)
    for t in range(n):
        vw.write(np.roll(base, 5 * t, axis=1))
    vw.release()
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The video, the weights (as trees and as .npz) and a config file."""
    root = tmp_path_factory.mktemp("stream")
    backbone = jax_params.init_resnet_params(0, "resnet18", num_classes=16)
    clstm = jax_params.init_clstm_params(1, 16, 16)
    jax_params.save_npz(str(root / "bb.npz"), backbone)
    jax_params.save_npz(str(root / "cl.npz"), clstm)
    (root / "config.yaml").write_text(CONFIG_YAML)
    return dict(root=root, video=_video(root / "v.mp4"), backbone=backbone, clstm=clstm)


@pytest.fixture(scope="module")
def models(inputs):
    return (jax_params.backbone_from_params(inputs["backbone"], "resnet18",
                                            compute_dtype=torch.float32),
            jax_params.clstm_from_params(inputs["clstm"], torch.float32))


@pytest.fixture(scope="module")
def streamed(inputs, models):
    return dict(stream_video_saliency(*models, inputs["video"], Config(**CFG), stage1_batch=4))


def _frames(video):
    cap = cv2.VideoCapture(video)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            return frames
        frames.append(frame)


class StubCapture:
    """``read``, ``grab`` and ``release`` over ``n`` frames (``frames`` in a
    cycle), counting each; the read of index ``fail_at`` raises."""

    def __init__(self, frames, n, fail_at=None):
        self.frames, self.n, self.fail_at = frames, n, fail_at
        self.pos = self.reads = self.grabs = self.releases = 0
        self.retrieved = []

    def grab(self):
        if self.pos >= self.n:
            return False
        self.pos += 1
        self.grabs += 1
        return True

    def read(self):
        if self.pos == self.fail_at:
            raise RuntimeError(f"corrupt frame {self.pos}")
        if self.pos >= self.n:
            return False, None
        self.retrieved.append(self.pos)
        self.reads += 1
        self.pos += 1
        return True, self.frames[(self.pos - 1) % len(self.frames)].copy()

    def release(self):
        self.releases += 1


def _stub_stream(models, cap, batch, start_output=0):
    return _stream_frames(*models, Config(**CFG), batch, cap, cap.n, start_output)


def _settle(cap, want, timeout=10.0):
    """Wait until the decode thread has read ``want`` frames, or ``timeout``
    has passed, and a little longer: its read count then."""
    end = time.monotonic() + timeout
    while cap.reads < want and time.monotonic() < end:
        time.sleep(0.002)
    time.sleep(0.02)
    return cap.reads


def test_stream_cams_equal_jax_to_one_f16_ulp(inputs, models):
    """Stage 1 of the stream (host remap, f16 scores) against the JAX
    package's on every frame the stream feeds: the f32 CAMs agree to 1e-5
    of their largest value (measured 2.4e-6), so after the f16 rounding a
    few values fall on the other side of a rounding boundary (measured 7 of
    4224), one f16 ulp apart and no more."""
    from cp360_tpu.pipelines import extract as jax_extract
    from cp360_tpu_torch.pipelines import extract

    cfg = Config(**CFG)
    faces = np.stack([extract.host_faces_for_upload(extract._resize_frame(f, cfg), 64, False)
                      for f in _frames(inputs["video"])[:-1]])
    out = {}
    for dtype in (torch.float32, torch.float16):
        with torch.no_grad():
            out[dtype] = extract.stage1_batch_faces(models[0], torch.from_numpy(faces),
                                                    out_dtype=dtype)[0].numpy()
    jtree = jax.tree_util.tree_map(jnp.asarray, inputs["backbone"])
    want = np.asarray(jax_extract.stage1_batch_faces(jtree, jnp.asarray(faces), arch="resnet18",
                                                     compute_dtype=jnp.float32,
                                                     out_dtype=jnp.float32)[0])
    assert np.abs(out[torch.float32] - want).max() <= 1e-5 * np.abs(want).max()
    got16, want16 = out[torch.float16].astype(np.float32), want.astype(np.float16)
    ulp = np.spacing(np.maximum(np.abs(got16), np.abs(want16.astype(np.float32))).astype(
        np.float16)).astype(np.float32)
    assert np.all(np.abs(got16 - want16.astype(np.float32)) <= ulp)


def test_stream_equals_the_jax_stream(inputs, streamed):
    """The JAX package's resnet18 stream on the same video and weights
    against the port's: the same ids, the carry, the padded tail and the
    window batches, within 1e-4 (measured 1.5e-5: the previous test's f16
    CAMs agree here to the last bit or one ulp, which moves a map far less
    than 1e-4)."""
    jtree = {k: jax.tree_util.tree_map(jnp.asarray, inputs[k]) for k in ("backbone", "clstm")}
    want = dict(jax_stream(jtree["backbone"], jtree["clstm"], inputs["video"], JaxConfig(**CFG),
                           arch="resnet18", stage1_batch=4))
    # 11 frames after the lag seed: batches of 4 + 4 + 3 (padded), windows 4..10
    assert sorted(streamed) == sorted(want) == list(range(4, 11))
    for k in want:
        assert streamed[k].shape == (4, 8)  # [2h, 4w] of the 2x2 CAM faces
        np.testing.assert_allclose(streamed[k], want[k], atol=1e-4, rtol=1e-4, err_msg=str(k))


def test_stream_equals_the_offline_path_plus_the_final_window(inputs, models, streamed,
                                                              tmp_path):
    model, cell = models
    out = tmp_path / "art"
    extract_video(model, Config(**CFG), inputs["video"], str(out), output_img=False,
                  batch_frames=CFG["extract_batch"])
    offline = infer_video(cell, str(out / "cube_feat"), 5, batch_windows=3)
    offline_ids = {idx + 4: p for idx, p in offline.items()}
    # the offline loop skips the final complete window; the stream emits it
    assert sorted(offline_ids) == sorted(streamed)[:-1]
    for k, p in offline_ids.items():
        np.testing.assert_allclose(streamed[k], p, atol=1e-5, rtol=1e-5, err_msg=str(k))


def test_missing_video_raises_at_the_call(models, tmp_path):
    with pytest.raises(FileNotFoundError, match="cannot open video"):
        stream_video_saliency(*models, str(tmp_path / "no.mp4"), Config(**CFG))  # no next()


def test_resumed_suffix_is_bit_identical(inputs, models, streamed):
    for mid in (6, 9):
        resumed = dict(stream_video_saliency(*models, inputs["video"], Config(**CFG),
                                             stage1_batch=4, start_output=mid))
        assert sorted(resumed) == [k for k in sorted(streamed) if k >= mid]
        for k in resumed:
            np.testing.assert_array_equal(resumed[k], streamed[k])
    assert dict(stream_video_saliency(*models, inputs["video"], Config(**CFG),
                                      start_output=10_000)) == {}


def test_decode_reads_two_batches_ahead_and_no_further(inputs, models):
    """At each map the caller has taken every frame of the batches so far
    (map m comes from the batch of frame m); the decode thread reads up to
    DECODE_AHEAD_BATCHES batches of frames past them, the lag frame
    included, and stops there."""
    batch, n = 2, 24
    cap = StubCapture(_frames(inputs["video"]), n)
    ids = []
    for fid, _ in _stub_stream(models, cap, batch):
        taken = min(n - 1, (fid // batch + 1) * batch)
        want = min(n, taken + DECODE_AHEAD_BATCHES * batch)
        assert _settle(cap, want) == want, fid
        ids.append(fid)
    assert ids == list(range(4, n - 1)) and cap.releases == 1


def test_decode_error_raises_after_the_batches_before_it(inputs, models, streamed):
    """A read that raises at frame 10: the two whole batches before it
    (frames 0-7, maps 4-7) are yielded as the stream yields them, frame 8's
    unfinished batch is not, then the error; the capture is released once."""
    cap = StubCapture(_frames(inputs["video"]), 12, fail_at=10)
    got = []
    with pytest.raises(RuntimeError, match="corrupt frame 10"):
        for fid, sal in _stub_stream(models, cap, 4):
            got.append((fid, sal))
    assert [fid for fid, _ in got] == [4, 5, 6, 7]
    for fid, sal in got:
        np.testing.assert_array_equal(sal, streamed[fid])
    assert cap.releases == 1


def test_close_joins_the_decode_thread_then_releases_once(inputs, models):
    before = threading.active_count()
    cap = StubCapture(_frames(inputs["video"]), 40)
    gen = _stub_stream(models, cap, 2)
    assert next(gen)[0] == 4
    assert any(t.name == "stream-decode" for t in threading.enumerate())
    gen.close()
    assert cap.releases == 1
    assert threading.active_count() == before
    assert not any(t.name == "stream-decode" for t in threading.enumerate())
    reads = cap.reads
    assert reads <= 6 + DECODE_AHEAD_BATCHES * 2  # frames 0-5 taken at map 4
    time.sleep(0.05)
    assert cap.reads == reads


def test_resume_grabs_without_a_retrieve(inputs, models, streamed):
    """start_output 9: frames 0-4 feed written windows only and are grabbed;
    frame 5 seeds the lag and is read with every later one."""
    cap = StubCapture(_frames(inputs["video"]), 12)
    got = dict(_stub_stream(models, cap, 4, start_output=9))
    assert cap.grabs == 5 and cap.retrieved == list(range(5, 12))
    assert sorted(got) == [9, 10]
    for k in got:
        np.testing.assert_array_equal(got[k], streamed[k])


@pytest.mark.parametrize("kw,exc,match", [
    # pipeline_stages runs when it divides seq_len (tests/test_torch_parallel.py)
    (dict(pipeline_stages=3), ValueError, "pipeline_stages=3 must divide seq_len=5"),
    (dict(upload_format="yuv422"), ValueError, "upload_format"),
])
def test_stream_refusals(inputs, models, kw, exc, match):
    with pytest.raises(exc, match=match):
        stream_video_saliency(*models, inputs["video"], Config(**{**CFG, **kw}))


def _cli(inputs, out, *extra):
    root = inputs["root"]
    return stream_saliency.main([
        "--video", inputs["video"], "--backbone", str(root / "bb.npz"),
        "--clstm", str(root / "cl.npz"), "--out", str(out), "--stage1-batch", "4", "--arch", "resnet18",
        "--config", str(root / "config.yaml"), "--device", "cpu", *extra])


def _maps(out):
    return {int(f[:-4]): np.load(os.path.join(out, f))
            for f in sorted(os.listdir(out)) if f.endswith(".npy")}


def test_cli_writes_the_stream_and_overlays(inputs, models, tmp_path):
    """The CLI (config file, host remap off: the stream always samples on
    the host) writes the library's maps bit for bit, and with --overlay one
    jpg per map at the working frame size."""
    out = tmp_path / "sal"
    assert _cli(inputs, out, "--overlay") == 7
    got = _maps(out)
    want = dict(stream_video_saliency(*models, inputs["video"], Config(**CFG), stage1_batch=4))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    jpgs = sorted(int(f[:-4]) for f in os.listdir(out / "overlay"))
    assert jpgs == sorted(got)
    from PIL import Image

    with Image.open(out / "overlay" / f"{jpgs[0]:05}.jpg") as img:
        assert img.size == (256, 128) and img.mode == "RGB"


def test_cli_resume_continues_at_the_first_missing_map(inputs, tmp_path, capsys):
    full, part = tmp_path / "full", tmp_path / "part"
    _cli(inputs, full)
    maps = _maps(full)
    keys = sorted(maps)
    part.mkdir()
    for k in keys[:2]:
        np.save(part / f"{k:05}.npy", maps[k])
    capsys.readouterr()
    assert _cli(inputs, part, "--resume") == len(keys) - 2
    assert f"maps before {keys[2]:05} exist" in capsys.readouterr().out
    resumed = _maps(part)
    assert sorted(resumed) == keys
    for k in keys:
        np.testing.assert_array_equal(resumed[k], maps[k])


def test_cli_needs_a_card_or_cpu(inputs, streamed, tmp_path, monkeypatch):
    """Without a card the CLI exits unless --device cpu is given; on the CPU
    it streams other backbone families too: resnet18 gives the library's
    first map, vgg16 (16 classes, seeded) a finite one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    # the refusal needs no CP360_PLATFORM (the JAX convert CLI sets it
    # in-process) and no ./config.yaml: the built-in defaults, use_gpu true
    monkeypatch.delenv("CP360_PLATFORM", raising=False)
    monkeypatch.chdir(tmp_path)
    root = inputs["root"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stream_saliency.main(["--video", inputs["video"], "--backbone", str(root / "bb.npz"),
                              "--clstm", str(root / "cl.npz"), "--out", str(tmp_path / "o")])
    jax_params.save_npz(str(tmp_path / "vgg.npz"),
                        jax_params.init_vgg16_params(2, num_classes=16))
    for arch, backbone in (("resnet18", root / "bb.npz"), ("vgg16", tmp_path / "vgg.npz")):
        out = tmp_path / arch
        # 6 decoded frames: 5 CAM frames after the lag seed, one window of 5
        assert stream_saliency.main(
            ["--video", inputs["video"], "--backbone", str(backbone),
             "--clstm", str(root / "cl.npz"), "--out", str(out), "--arch", arch,
             "--max-frames", "6", "--stage1-batch", "4", "--config", str(root / "config.yaml"),
             "--device", "cpu"]) == 1
        got = _maps(out)
        assert sorted(got) == [4] and got[4].shape == (4, 8) and np.isfinite(got[4]).all()
        if arch == "resnet18":
            np.testing.assert_allclose(got[4], streamed[4], atol=1e-5, rtol=1e-5)
