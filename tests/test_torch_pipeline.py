"""PyTorch port, the serving slice: stage 1, stage 2, SaliencyModel and HTTP,
against the JAX package on the CPU; plus the port's package rules.

Sizes are cut for the CPU (64 faces of 64x128 frames, a 16-class CAM, a
16-channel ConvLSTM); the code path is the full-width one.  One numpy param
tree, made by compat/jax_params.py, goes into both packages.  Tolerances:
stage-1 outputs to 1e-4 of their largest value (He-initialized weights with
identity BN statistics grow activations, so the bound scales with them);
ConvLSTM outputs to 1e-4; served temporal predictions, whose session cubes
are held in float16 by both servers, to 2e-3.
"""

import ast
import dataclasses
import http.client
import json
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp360_tpu import config as jax_config
from cp360_tpu.pipelines import extract as jax_extract
from cp360_tpu.pipelines import temporal as jax_temporal
from cp360_tpu_torch import config as torch_config
from cp360_tpu_torch.compat import jax_params
from cp360_tpu_torch.pipelines import extract, temporal
from cp360_tpu_torch.serving.server import SaliencyModel, serve

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CD, EH = 64, 64  # cube faces, equi rows (frames are EH x 2EH)


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def resnet_tree():
    return jax_params.init_resnet_params(0, "resnet50", num_classes=16)


@pytest.fixture(scope="module")
def clstm_tree():
    return jax_params.init_clstm_params(1, 16, 16)


@pytest.fixture(scope="module")
def frames():
    return np.random.RandomState(2).randint(0, 256, (4, EH, 2 * EH, 3)).astype(np.uint8)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_stage1_batch_equals_jax(resnet_tree, frames):
    model = jax_params.resnet_from_params(resnet_tree, compute_dtype=torch.float32)
    with torch.no_grad():
        scores, sal = extract.stage1_batch(model, torch.from_numpy(frames[:2]), CD)
    jscores, jsal = jax_extract.stage1_batch(_jax(resnet_tree), jnp.asarray(frames[:2]),
                                             cube_dim=CD, compute_dtype=jnp.float32)
    assert scores.dtype == torch.float32 and tuple(sal.shape) == (2, 4, 8)
    _close(scores.numpy(), jscores)
    _close(sal.numpy(), jsal, rel=2e-4)


def test_stage1_batch_faces_equals_jax(resnet_tree, frames):
    faces = np.stack([jax_extract.host_equi_to_cube_u8(f, CD) for f in frames[:2]])
    model = jax_params.resnet_from_params(resnet_tree, compute_dtype=torch.float32)
    with torch.no_grad():
        scores, sal = extract.stage1_batch_faces(model, torch.from_numpy(faces))
    jscores, jsal = jax_extract.stage1_batch_faces(_jax(resnet_tree), jnp.asarray(faces),
                                                   compute_dtype=jnp.float32)
    assert scores.dtype == torch.float16
    _close(scores.float().numpy(), np.asarray(jscores, np.float32), rel=2e-3)
    _close(sal.numpy(), jsal, rel=2e-4)
    np.testing.assert_array_equal(extract.host_equi_to_cube_u8(frames[0], CD), faces[0])


@pytest.mark.parametrize("conv_impl", ["pallas", "xla"])
def test_window_infer_equals_jax(clstm_tree, conv_impl):
    windows = np.random.RandomState(3).randn(2, 3, 6, 7, 7, 16).astype(np.float32) * 5
    cell = jax_params.clstm_from_params(clstm_tree, torch.float32, conv_impl=conv_impl)
    with torch.no_grad():
        got = temporal.window_infer(cell, torch.from_numpy(windows))
    want = jax_temporal.window_infer(_jax(clstm_tree), jnp.asarray(windows),
                                     compute_dtype=jnp.float32, conv_impl=conv_impl)
    assert tuple(got.shape) == (2, 14, 28)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_constant_window_stays_finite(clstm_tree):
    """Kept divergence from the reference: a constant window normalizes to
    zeros instead of NaN (cp360_tpu/pipelines/temporal.py:43-46)."""
    windows = np.full((1, 3, 6, 7, 7, 16), 2.5, np.float32)
    cell = jax_params.clstm_from_params(clstm_tree, torch.float32)
    with torch.no_grad():
        got = temporal.window_infer(cell, torch.from_numpy(windows)).numpy()
    want = jax_temporal.window_infer(_jax(clstm_tree), jnp.asarray(windows),
                                     compute_dtype=jnp.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def _cfg(**kw):
    base = dict(cube_dim=CD, equi_h=2 * EH, equi_w=EH, input_size=16, hidden_size=16,
                seq_len=3, compute_dtype="float32", host_cube_remap=False,
                clstm_conv_impl="pallas", serve_max_batch=2)
    base.update(kw)
    return torch_config.Config(**base)


@pytest.fixture(scope="module")
def served(resnet_tree, clstm_tree):
    model = SaliencyModel(resnet_tree, _cfg(), clstm_params=clstm_tree, device="cpu")
    model.warmup()
    yield model
    model.close()


def test_saliency_model_matches_jax_pipeline(served, resnet_tree, clstm_tree, frames):
    """predict == stage 1; a session's prediction == window_infer over the
    last seq_len float16 CAM cubes (the JAX server's protocol)."""
    jscores, jsal = jax_extract.stage1_batch(_jax(resnet_tree), jnp.asarray(frames),
                                             cube_dim=CD, compute_dtype=jnp.float32)
    for i in range(2):
        sal = served.predict(frames[i])
        assert sal.shape == (4, 8) and sal.dtype == np.float32
        _close(sal, jsal[i], rel=2e-4)

    sid = served.temporal_start()
    got = [served.temporal_push(sid, f) for f in frames]
    served.temporal_close(sid)
    assert [idx for idx, _ in got] == [0, 1, 2, 3]
    assert got[0][1] is None and got[1][1] is None
    cubes = np.asarray(jscores).astype(np.float16)
    for end in (2, 3):
        window = jnp.asarray(cubes[end - 2:end + 1][None])
        want = jax_temporal.window_infer(_jax(clstm_tree), window,
                                         compute_dtype=jnp.float32, conv_impl="pallas")
        np.testing.assert_allclose(got[end][1], np.asarray(want)[0], atol=2e-3)


def test_host_remap_mode_matches_device_mode(resnet_tree, frames):
    """host_cube_remap: true samples faces with cv2 on the host and runs
    stage1_batch_faces, as the JAX server does."""
    pytest.importorskip("cv2")
    model = SaliencyModel(resnet_tree, _cfg(host_cube_remap=True), device="cpu")
    try:
        sal = model.predict(frames[0])
    finally:
        model.close()
    faces = jax_extract.host_equi_to_cube_u8(frames[0], CD)[None]
    _, jsal = jax_extract.stage1_batch_faces(_jax(resnet_tree), jnp.asarray(faces),
                                             compute_dtype=jnp.float32)
    _close(sal, jsal[0], rel=2e-4)


def test_http_round_trip(served, frames):
    pytest.importorskip("PIL")
    from cp360_tpu_torch.serving.client import SaliencyClient

    httpd = serve(served, host="127.0.0.1", port=0, warmup=False)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        client = SaliencyClient(port=httpd.server_address[1], timeout_s=120)
        info = client.health()
        assert info["status"] == "ok" and info["device"] == "cpu" and info["temporal"]
        np.testing.assert_array_equal(client.saliency(frames[0]), served.predict(frames[0]))
        with client.temporal_session() as session:
            outs = [session.push(f) for f in frames[:3]]
        assert outs[0] is None and outs[2].shape == (4, 8)
        assert "cp360_requests_total" in client.metrics()
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=30)
        conn.request("POST", "/saliency", body=b"not an image")
        resp = conn.getresponse()
        assert resp.status == 400 and "error" in json.loads(resp.read())
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    assert not th.is_alive()


def test_entry_points_need_a_card_or_cpu(resnet_tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cp360_tpu_torch.cli import serve as serve_cli

    with pytest.raises(RuntimeError, match="device='cpu'"):
        SaliencyModel(resnet_tree, _cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--port", "0"])


@pytest.mark.parametrize("kw,exc,match", [
    (dict(mesh_data=2), NotImplementedError, 'ROADMAP.md, "parallel"'),
    (dict(upload_format="yuv422"), ValueError, "upload_format"),  # yuv420 runs
])
def test_unported_serving_options_raise(resnet_tree, kw, exc, match):
    with pytest.raises(exc, match=match):
        SaliencyModel(resnet_tree, _cfg(**kw), device="cpu")


def test_config_matches_jax_config():
    mine = {f.name: f.default for f in dataclasses.fields(torch_config.Config)}
    theirs = {f.name: f.default for f in dataclasses.fields(jax_config.Config)}
    assert mine == theirs
    path = str(ROOT / "config.yaml")
    assert (dataclasses.asdict(torch_config.load_config(path))
            == dataclasses.asdict(jax_config.load_config(path)))


def _port_files():
    files = sorted((ROOT / "cp360_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def test_port_imports_neither_jax_nor_the_jax_package():
    banned = {"jax", "jaxlib", "cp360_tpu"}
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"


def test_refusals_name_their_roadmap_item():
    """A refusal names the ROADMAP.md item that ports what it refuses
    ("parallel", "trainer options", ...), never an item number, which a
    renumbered queue would make wrong."""
    import re

    numbered = re.compile(r"ROADMAP[^\n]{0,40}(queue|item)s? *\d", re.I)
    for path in _port_files():
        text = path.read_text()
        assert not numbered.search(text), f"{path}: {numbered.search(text).group(0)}"


def test_kernel_sources_live_in_the_port():
    from cp360_tpu_torch.ops import _build

    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert _build.CSRC == ROOT / "cp360_tpu_torch" / "csrc"
