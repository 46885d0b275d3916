"""PyTorch port, the yuv420 upload against the JAX package on the CPU: the
host 4:2:0 packing, the device reconstruction, ``stage1_batch_faces_yuv``,
extraction and serving with ``upload_format: yuv420``.

Sizes are cut for the CPU (64-pixel faces, a 16-class ResNet-50 CAM, f32).
Inputs come from seeded numpy.  Tolerances: the host packing and the
chroma upsample bit for bit; the device reconstruction bit for bit against
the JAX package's op-by-op result, and within the round-trip bounds of
tests/test_extract.py:133-163; stage-1 CAMs within 1e-4 of their largest
value; yuv420 within the JAX package's bound of rgb8 (relative max error
under 0.08, correlation over 0.998; tests/test_extract.py:209-230,
tests/test_serving.py:526-547).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp360_tpu.pipelines import extract as jax_extract
from cp360_tpu_torch.compat import jax_params
from cp360_tpu_torch.config import Config
from cp360_tpu_torch.pipelines import extract
from cp360_tpu_torch.serving.server import SaliencyModel

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)
CD = 64


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _natural_frame(h, w, seed):
    """Multi-scale smooth texture (a natural-image-like spectrum), as
    tests/test_extract.py makes it."""
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w))
    for scale in (4, 8, 16):
        small = rng.rand(h // scale + 2, w // scale + 2)
        img += cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC) * scale
    img = ((img - img.min()) / (img.max() - img.min()) * 255).astype(np.uint8)
    return np.stack([img, np.roll(img, 2, 0), np.roll(img, 5, 1)], -1)


@pytest.fixture(scope="module")
def resnet_tree():
    return jax_params.init_resnet_params(11, "resnet50", num_classes=16)


@pytest.fixture(scope="module")
def model(resnet_tree):
    return jax_params.resnet_from_params(resnet_tree, compute_dtype=torch.float32)


def test_host_packing_equals_jax():
    rng = np.random.RandomState(0)
    faces = rng.randint(0, 256, (2, 6, 16, 16, 3)).astype(np.uint8)
    for got, want in zip(extract.host_rgb_to_yuv420(faces), jax_extract.host_rgb_to_yuv420(faces)):
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    frame = _natural_frame(64, 128, 1)
    for yuv in (False, True):
        got = extract.host_faces_for_upload(frame, CD, yuv)
        want = jax_extract.host_faces_for_upload(frame, CD, yuv)
        for g, w in zip(got if yuv else [got], want if yuv else [want]):
            np.testing.assert_array_equal(g, w)
    y, uv = extract.host_faces_for_upload(frame, CD, True)
    assert y.shape == (6, CD, CD) and uv.shape == (6, CD // 2, CD // 2, 2)


@pytest.mark.parametrize("shape,axis", [((4, 16, 16, 2), 1), ((4, 32, 16, 2), 2),
                                        ((3, 7, 9, 2), 1), ((3, 7, 9, 2), 2),
                                        ((2, 1, 5, 2), 1)])
def test_chroma_upsample_equals_jax(shape, axis):
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    got = extract._up2_axis_slice(torch.from_numpy(x), axis, 2 * shape[axis]).numpy()
    for form in (jax_extract._up2_axis_slice, jax_extract._up2_axis_take):
        np.testing.assert_array_equal(got, np.asarray(form(jnp.asarray(x), axis,
                                                           2 * shape[axis])))
    with pytest.raises(ValueError):
        extract._up2_axis_slice(torch.from_numpy(x), axis, 2 * shape[axis] + 1)


def test_device_reconstruction_equals_jax_and_is_bounded():
    # flat colour: only u8 rounding
    flat = np.broadcast_to(np.array([200, 30, 90], np.uint8), (1, 1, 16, 16, 3)).copy()
    y, uv = extract.host_rgb_to_yuv420(flat)
    rec = extract._device_yuv420_to_rgb01(torch.from_numpy(y), torch.from_numpy(uv))
    assert rec.dtype == torch.float32 and tuple(rec.shape) == flat.shape
    assert np.abs(rec.numpy() * 255 - flat).max() < 1.5
    # natural-spectrum texture: ~1/255 mean, the tail at chroma edges
    frame = _natural_frame(64, 64, 0)[None, None]
    y, uv = extract.host_rgb_to_yuv420(frame)
    rec = extract._device_yuv420_to_rgb01(torch.from_numpy(y), torch.from_numpy(uv)).numpy()
    want = np.asarray(jax_extract._device_yuv420_to_rgb01(jnp.asarray(y), jnp.asarray(uv)))
    np.testing.assert_array_equal(rec, want)
    err = np.abs(rec * 255 - frame)
    assert err.mean() < 4.0 and np.percentile(err, 99) < 25.0


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_stage1_batch_faces_yuv_equals_jax(model, resnet_tree, codec):
    frames = [_natural_frame(64, 128, s) for s in (2, 3)]
    planes = [extract.host_faces_for_upload(f, CD, True) for f in frames]
    y = np.stack([p[0] for p in planes])
    uv = np.stack([p[1] for p in planes])
    with torch.no_grad():
        out = extract.stage1_batch_faces_yuv(model, torch.from_numpy(y), torch.from_numpy(uv),
                                             out_dtype=torch.float32, codec=codec)
    want = jax_extract.stage1_batch_faces_yuv(
        _jax(resnet_tree), jnp.asarray(y), jnp.asarray(uv), compute_dtype=jnp.float32,
        out_dtype=jnp.float32, codec=codec)
    sal, jsal = out[-1].numpy(), np.asarray(want[-1])
    assert np.abs(sal - jsal).max() <= 2e-4 * np.abs(jsal).max()
    if codec == "none":
        scores, jscores = out[0].numpy(), np.asarray(want[0])
        assert scores.shape == (2, 6, 2, 2, 16)
        assert np.abs(scores - jscores).max() <= 1e-4 * np.abs(jscores).max()
    else:  # one int8 step at most, where the scores' rounding sits on a boundary
        assert out[0].dtype == torch.int8 and out[1].dtype == torch.float16
        assert np.abs(out[0].numpy().astype(int) - np.asarray(want[0]).astype(int)).max() <= 1
        np.testing.assert_allclose(out[1].float().numpy(), np.asarray(want[1], np.float32),
                                   rtol=2e-3)


@pytest.fixture(scope="module")
def natural_frames():
    base = _natural_frame(64, 128, 7)
    return [np.roll(base, 3 * t, axis=1) for t in range(6)]


def _cfg(**kw):
    base = dict(equi_h=128, equi_w=64, cube_dim=CD, extract_batch=4, opt_flow=False,
                compute_dtype="float32", feat_dtype="float32", host_cube_remap=True)
    base.update(kw)
    return Config(**base)


def test_yuv420_extraction_close_to_rgb8(model, resnet_tree, natural_frames, tmp_path):
    """The yuv420 artifacts within the codec's bound of the rgb8 ones, and
    each equal to the JAX package's stage1_batch_faces_yuv on the same
    planes (the first batch of 4, the tail of 1 padded)."""
    outs = {}
    for fmt in ("rgb8", "yuv420"):
        out = tmp_path / fmt
        assert extract.extract_frames(model, _cfg(upload_format=fmt), natural_frames,
                                      str(out), output_img=False) == 5
        outs[fmt] = out
    names = sorted(os.listdir(outs["rgb8"] / "cube_feat"))
    assert names == sorted(os.listdir(outs["yuv420"] / "cube_feat")) and len(names) == 5
    planes = [jax_extract.host_faces_for_upload(f, CD, True) for f in natural_frames[:5]]
    jscores, _ = jax_extract.stage1_batch_faces_yuv(
        _jax(resnet_tree), jnp.asarray(np.stack([p[0] for p in planes])),
        jnp.asarray(np.stack([p[1] for p in planes])), compute_dtype=jnp.float32,
        out_dtype=jnp.float32)
    jscores = np.asarray(jscores).transpose(0, 1, 4, 2, 3)
    for k, n in enumerate(names):
        a = np.load(outs["rgb8"] / "cube_feat" / n)
        b = np.load(outs["yuv420"] / "cube_feat" / n)
        assert np.abs(a - b).max() / np.abs(a).max() < 0.08, n
        assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.998, n
        assert np.abs(b - jscores[k]).max() <= 1e-4 * np.abs(jscores[k]).max(), n


def test_serving_yuv420_close_to_rgb8(resnet_tree):
    """SaliencyModel with host_cube_remap and yuv420: the served map within
    the codec bound of rgb8, and equal to the JAX package's
    stage1_batch_faces_yuv on the same planes."""
    cfg = Config(equi_h=256, equi_w=128, cube_dim=CD, compute_dtype="float32",
                 host_cube_remap=True, serve_max_batch=2)
    frame = _natural_frame(128, 256, 3)
    m_rgb = SaliencyModel(resnet_tree, cfg, device="cpu")
    m_yuv = SaliencyModel(resnet_tree, cfg.replace(upload_format="yuv420"), device="cpu")
    try:
        a = m_rgb.predict(frame)
        b = m_yuv.predict(frame)
        y, uv = m_yuv._host_prep(frame)
    finally:
        m_rgb.close()
        m_yuv.close()
    assert a.shape == b.shape == (4, 8)
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.998
    assert np.abs(a - b).max() / max(np.abs(a).max(), 1e-6) < 0.08
    _, jsal = jax_extract.stage1_batch_faces_yuv(_jax(resnet_tree), jnp.asarray(y[None]),
                                                 jnp.asarray(uv[None]),
                                                 compute_dtype=jnp.float32)
    assert np.abs(b - np.asarray(jsal)[0]).max() <= 2e-4 * np.abs(np.asarray(jsal)).max()
