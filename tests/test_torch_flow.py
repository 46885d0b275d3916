"""PyTorch port, optical flow against the JAX package on the CPU: the
stencils, the Horn-Schunck and Brox solvers, the analytic-motion checks of
tests/test_flow_backends.py, the wrappers, and motion in extraction.

Inputs come from seeded numpy (``tools/flow_backend_report.py::make_scenes``
at width 240, whose pyramids reach odd levels such as 15 columns).

Tolerances:
- the stencils equal the JAX package's op-by-op results bit for bit; the
  2x2 mean of ``_downsample2`` to 2 ulps, because XLA sums the four values
  in pairs at some widths and one after another at others;
- the solvers within 1e-3 px of the jitted JAX solvers (measured: 1.2e-5
  px Horn-Schunck, 1.0e-4 px Brox): XLA fuses the stencils and contracts
  products and sums into FMAs inside ``jit``, where torch rounds each op;
- a batch of pairs equals each pair solved alone, bit for bit;
- motion artifacts within 1e-3 px of the JAX package's extraction at the
  f32 link, and the f16 link within ``2e-3 max|flow| + 1e-4`` of the f32
  link (tests/test_extract.py:95-106).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp360_tpu.flow import optical_flow as jflow
from cp360_tpu.flow import variational as jvar
from cp360_tpu_torch.flow import optical_flow as flow
from cp360_tpu_torch.flow import variational as var

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import flow_backend_report as fbr  # noqa: E402

torch.set_num_threads(2)
SOLVER_TOL = 1e-3  # px


@pytest.fixture(scope="module")
def scenes():
    return fbr.make_scenes(240)


def _pairs(scenes):
    p = np.stack([scenes[s][0] for s in scenes])
    c = np.stack([scenes[s][1] for s in scenes])
    return p, c


# ---- stencils ------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 17, 30), (2, 16, 31)])
def test_stencils_equal_jax(shape):
    rng = np.random.RandomState(sum(shape))
    x = rng.rand(*shape).astype(np.float32)
    u, v = (rng.randn(*shape) * 3).astype(np.float32), (rng.randn(*shape) * 3).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)

    def equal(got, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    equal(flow._gauss5(tx), jax.vmap(jflow._gauss5)(jx))
    equal(flow._median3(tx), jax.vmap(jflow._median3)(jx))
    equal(torch.stack(flow._grad(tx)), jnp.stack(jax.vmap(jflow._grad)(jx)))
    equal(flow._avg_neighbors(tx), jax.vmap(jflow._avg_neighbors)(jx))
    got, valid = flow._warp_valid(tx, torch.from_numpy(u), torch.from_numpy(v))
    want = jax.vmap(jflow._warp_valid)(jx, jnp.asarray(u), jnp.asarray(v))
    equal(got, want[0])
    equal(valid, want[1])
    for oh, ow in ((2 * shape[1], 2 * shape[2]), (2 * shape[1] + 1, 2 * shape[2] + 1)):
        equal(flow._upsample2(tx, oh, ow),
              jax.vmap(lambda a: jflow._upsample2(a, oh, ow))(jx))
    # the wrap-around of _grad: the first column's x-derivative reads the last
    ix, _ = flow._grad(tx)
    np.testing.assert_array_equal(ix[..., 0].numpy(), (x[..., 1] - x[..., -1]) * 0.5)


@pytest.mark.parametrize("shape", [(3, 17, 30), (2, 16, 31), (4, 64, 128)])
def test_downsample_within_two_ulps_of_jax(shape):
    x = np.random.RandomState(shape[2]).rand(*shape).astype(np.float32)
    got = flow._downsample2(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.vmap(jflow._downsample2)(jnp.asarray(x)))
    assert got.shape == want.shape == (shape[0], shape[1] // 2, shape[2] // 2)
    assert np.all(np.abs(got - want) <= 2 * np.spacing(np.abs(want)))


def test_median_is_the_middle_of_nine():
    x = np.random.RandomState(1).rand(2, 6, 7).astype(np.float32)
    got = flow._median3(torch.from_numpy(x)).numpy()
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1)), mode="edge")
    win = np.stack([xp[:, dy:dy + 6, dx:dx + 7] for dy in range(3) for dx in range(3)])
    np.testing.assert_array_equal(got, np.sort(win, axis=0)[4])


# ---- solvers ---------------------------------------------------------------------


@pytest.mark.parametrize("backend,kw", [
    ("horn_schunck", dict(iters=10, n_warp=1)),
    ("horn_schunck", {}),
    ("variational", dict(fp_iters=2, solver_iters=5, n_warp=1)),
    ("variational", {}),
])
def test_solvers_equal_jax(scenes, backend, kw):
    p, c = _pairs(scenes)
    mine = flow.horn_schunck_flow_batch if backend == "horn_schunck" else var.brox_flow_batch
    theirs = (jflow.horn_schunck_flow_batch if backend == "horn_schunck"
              else jvar.brox_flow_batch)
    got = mine(flow.u8_to_unit(torch.from_numpy(p)), flow.u8_to_unit(torch.from_numpy(c)), **kw)
    want = np.asarray(theirs(jnp.asarray(p, jnp.float32) / 255.0,
                             jnp.asarray(c, jnp.float32) / 255.0, **kw))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 120, 240, 2)
    assert np.abs(got.numpy() - want).max() <= SOLVER_TOL


# ---- analytic motion: tests/test_flow_backends.py's checks on the port's flows -----


@pytest.fixture(scope="module")
def port_flows(scenes):
    p, c = _pairs(scenes)
    tp, tc = flow.u8_to_unit(torch.from_numpy(p)), flow.u8_to_unit(torch.from_numpy(c))
    out = {}
    for name, solve in (("horn_schunck", flow.horn_schunck_flow_batch),
                        ("variational", var.brox_flow_batch)):
        batch = solve(tp, tc).numpy()
        out[name] = dict(zip(scenes, batch))
    return out


def epe(f, gt):
    ok = fbr.interior(*gt.shape[:2])
    return float(np.linalg.norm(f - gt, axis=-1)[ok].mean())


def test_port_flows_track_ground_truth(scenes, port_flows):
    """EPE bounds of test_flow_backends.py: Horn-Schunck < 0.4 px and the
    variational solver < 0.15 px on all three scenes, and the variational
    solver beats Horn-Schunck and Farneback at the moving patch."""
    for sname, (f1, f2, gt) in scenes.items():
        assert epe(port_flows["horn_schunck"][sname], gt) < 0.4, sname
        assert epe(port_flows["variational"][sname], gt) < 0.15, sname
    f1, f2, gt = scenes["moving_patch"]
    e_var = epe(port_flows["variational"]["moving_patch"], gt)
    e_hs = epe(port_flows["horn_schunck"]["moving_patch"], gt)
    e_fb = epe(fbr.backend_flow("farneback", f1, f2), gt)
    assert e_var < e_hs and e_var < e_fb, (e_var, e_hs, e_fb)


@pytest.mark.parametrize("backend,min_tnr", [("horn_schunck", 0.84), ("variational", 0.90)])
def test_port_motion_mask_at_shipped_threshold(scenes, port_flows, backend, min_tnr):
    _, _, gt = scenes["moving_patch"]
    tpr, tnr, *_ = fbr.mask_metrics(port_flows[backend]["moving_patch"], gt)
    assert tpr > 0.99, (backend, tpr)
    assert tnr > min_tnr, (backend, tnr)


def test_batch_equals_each_pair_alone(scenes, port_flows):
    for name, single in (("horn_schunck", flow.horn_schunck_flow), ("variational", var.brox_flow)):
        for sname in ("translation", "moving_patch"):
            f1, f2, _ = scenes[sname]
            alone = single(flow.u8_to_unit(torch.from_numpy(f1)),
                           flow.u8_to_unit(torch.from_numpy(f2))).numpy()
            np.testing.assert_array_equal(alone, port_flows[name][sname])


# ---- wrappers ----------------------------------------------------------------------


def _bgr_pair(scenes, sname):
    f1, f2, _ = scenes[sname]
    return np.stack([f1] * 3, -1), np.stack([f2] * 3, -1)


@pytest.mark.parametrize("have_cv2", [True, False])
def test_preprocess_pair_equals_jax(scenes, monkeypatch, have_cv2):
    pytest.importorskip("cv2")
    monkeypatch.setattr(flow, "_have_cv2", lambda: have_cv2)
    monkeypatch.setattr(jflow, "_HAVE_CV2", have_cv2)
    rng = np.random.RandomState(5)
    a, b = (rng.randint(0, 256, (40, 70, 3)).astype(np.uint8) for _ in range(2))
    for got, want in zip(flow._preprocess_pair(a, b, (64, 32)),
                         jflow._preprocess_pair(a, b, (64, 32))):
        assert got.dtype == np.uint8 and got.shape == (32, 64)
        np.testing.assert_array_equal(got, want)


def test_host_flow_equals_jax(scenes):
    pytest.importorskip("cv2")
    a, b = _bgr_pair(scenes, "moving_patch")
    (mag, got), (jmag, want) = flow.calc_optical_flow(a, b, (240, 120)), \
        jflow.calc_optical_flow(a, b, (240, 120))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mag, jmag)


def test_device_wrappers(scenes):
    """The per-pair wrappers, the batched one and the u8 batch solver agree
    on the CPU; the per-pair wrapper is within the solver tolerance of the
    JAX package's, and its magnitude follows."""
    bgr = [_bgr_pair(scenes, s) for s in ("translation", "moving_patch")]
    res = (240, 120)
    batched = flow.calc_optical_flow_batched(bgr, res=res, device="cpu")
    for (p, c), (mag_b, fl_b) in zip(bgr, batched):
        mag_1, fl_1 = flow.calc_optical_flow_device(p, c, res=res, device="cpu")
        np.testing.assert_array_equal(fl_b, fl_1)
        np.testing.assert_array_equal(mag_b, mag_1)
        _, want = jflow.calc_optical_flow_device(p, c, res=res)
        assert np.abs(fl_1 - want).max() <= SOLVER_TOL
    grays = [flow._preprocess_pair(p, c, res) for p, c in bgr]
    prev, cur = np.stack([g[0] for g in grays]), np.stack([g[1] for g in grays])
    f32 = flow.get_batch_solver_u8("horn_schunck", "float32", "cpu")(prev, cur)
    f16 = flow.get_batch_solver_u8("horn_schunck", "float16", "cpu")(prev, cur)
    assert f32.dtype == torch.float32 and f16.dtype == torch.float16
    np.testing.assert_array_equal(f32.numpy(), np.stack([b[1] for b in batched]))
    np.testing.assert_array_equal(f16.numpy(), f32.half().numpy())
    assert flow.get_batch_solver_u8("horn_schunck", "float32", "cpu") is \
        flow.get_batch_solver_u8("horn_schunck", "float32", "cpu")
    mag, fl = var.calc_optical_flow_variational(*bgr[1], res=res, device="cpu")
    np.testing.assert_array_equal(
        fl, flow.calc_optical_flow_batched(bgr[1:], res=res, backend="variational",
                                           device="cpu")[0][1])


def test_flow_fn_selection_and_refusals():
    assert flow.get_flow_fn("horn_schunck") is flow.calc_optical_flow_device
    assert flow.get_flow_fn("variational") is var.calc_optical_flow_variational
    assert flow.get_flow_fn("farneback") is flow.calc_optical_flow
    with pytest.raises(ValueError, match="unknown flow backend"):
        flow.get_flow_fn("lucas_kanade")
    with pytest.raises(ValueError, match="no device batch solver"):
        flow.get_batch_solver_u8("farneback", "float32", "cpu")
    with pytest.raises(ValueError, match="flow_link_dtype"):
        flow.get_batch_solver_u8("horn_schunck", "bfloat16", "cpu")
    with pytest.raises(ValueError, match=r"\[N, H, W\]"):
        flow.horn_schunck_flow_batch(torch.zeros(4, 8), torch.zeros(4, 8))


def test_device_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    frame = np.zeros((16, 32, 3), np.uint8)
    for call in (lambda: flow.calc_optical_flow_device(frame, frame, (32, 16)),
                 lambda: var.calc_optical_flow_variational(frame, frame, (32, 16)),
                 lambda: flow.calc_optical_flow_batched([(frame, frame)], (32, 16)),
                 lambda: flow.get_batch_solver_u8("horn_schunck")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---- motion in extraction ------------------------------------------------------------


ROWS, COLS, FLOW_H = 64, 128, 16


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """7 frames of a smooth texture moving 3 px a frame (mp4, cv2)."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path_factory.mktemp("flowvid") / "moving.mp4")
    base = fbr.textured(ROWS, COLS, 3)
    base = np.stack([base, np.roll(base, 7, 0), np.roll(base, 11, 1)], -1)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (COLS, ROWS))
    for t in range(7):
        vw.write(np.roll(base, 3 * t, axis=1))
    vw.release()
    return path


@pytest.fixture(scope="module")
def port_model():
    from cp360_tpu_torch.compat import jax_params

    return jax_params.resnet_from_params(jax_params.init_resnet_params(8, "resnet50", 16),
                                         compute_dtype=torch.float32)


def _port_cfg(**kw):
    from cp360_tpu_torch.config import Config

    base = dict(equi_h=COLS, equi_w=ROWS, cube_dim=64, flow_h=FLOW_H, extract_batch=4,
                compute_dtype="float32", feat_dtype="float32", host_cube_remap=False)
    base.update(kw)
    return Config(**base)


def _motion(out):
    names = sorted(os.listdir(os.path.join(out, "motion")))
    return names, [np.load(os.path.join(out, "motion", n)) for n in names]


@pytest.fixture(scope="module")
def jax_motion(video, tmp_path_factory):
    """The JAX package's extract_video motion at both link dtypes."""
    from cp360_tpu.config import Config as JaxConfig
    from cp360_tpu.models.resnet import init_resnet_params
    from cp360_tpu.pipelines.extract import extract_video

    params = init_resnet_params(jax.random.PRNGKey(0), "resnet18")
    out = {}
    for link in ("float32", "float16"):
        d = str(tmp_path_factory.mktemp(f"jax_{link}"))
        cfg = JaxConfig(equi_h=COLS, equi_w=ROWS, cube_dim=64, flow_h=FLOW_H,
                        compute_dtype="float32", flow_backend="horn_schunck",
                        flow_link_dtype=link)
        extract_video(params, cfg, video, d, output_img=False, output_feature=False,
                      output_motion=True, arch="resnet18", batch_frames=4)
        out[link] = _motion(d)
    return out


@pytest.mark.parametrize("link", ["float32", "float16"])
def test_extract_motion_equals_jax(port_model, video, jax_motion, tmp_path, link):
    """-om with the device backend: 6 motion artifacts (000002..000007, the
    flow from decoded frame k-2 to k-1), f32 [16, 32, 2], within 1e-3 px of
    the JAX package's at the same link dtype; the f16 link within its
    bound of the f32 link."""
    from cp360_tpu_torch.pipelines import extract

    out = str(tmp_path / "port")
    n = extract.extract_video(port_model, _port_cfg(flow_link_dtype=link), video, out,
                              output_img=False, output_feature=True, output_motion=True)
    assert n == 6
    names, got = _motion(out)
    assert names == [f"{i:06}.npy" for i in range(2, 8)] == jax_motion[link][0]
    for g, w in zip(got, jax_motion[link][1]):
        assert g.shape == (FLOW_H, 2 * FLOW_H, 2) and g.dtype == np.float32
        assert g.flags["C_CONTIGUOUS"]
        scale = max(1e-3, np.abs(w).max())
        tol = SOLVER_TOL if link == "float32" else 2e-3 * scale + 1e-4
        assert np.abs(g - w).max() <= tol
    for g, w in zip(got, jax_motion["float32"][1]):  # the f16 link's bound
        assert np.abs(g - w).max() <= 2e-3 * max(1e-3, np.abs(w).max()) + 1e-4


def test_extract_motion_resumes_and_host_backend(port_model, video, tmp_path):
    """A resumed run with every motion artifact present writes nothing; a
    missing one is computed again, equal to the first; the host backend
    (Farneback, on a thread pool) writes the per-pair cv2 flow of the
    decoded frames."""
    cv2 = pytest.importorskip("cv2")
    from cp360_tpu_torch.pipelines import extract

    cfg = _port_cfg()
    out = tmp_path / "vid"
    assert extract.extract_video(port_model, cfg, video, str(out), output_img=False,
                                 output_feature=False, output_motion=True) == 6
    before = {p: p.stat().st_mtime_ns for p in out.rglob("*") if p.is_file()}
    assert extract.extract_video(port_model, cfg, video, str(out), output_img=False,
                                 output_feature=False, output_motion=True) == 6
    assert {p: p.stat().st_mtime_ns for p in out.rglob("*") if p.is_file()} == before
    keep = np.load(out / "motion" / "000004.npy")
    os.remove(out / "motion" / "000004.npy")
    assert extract.extract_video(port_model, cfg, video, str(out), output_img=False,
                                 output_feature=False, output_motion=True) == 6
    np.testing.assert_array_equal(np.load(out / "motion" / "000004.npy"), keep)

    cap = cv2.VideoCapture(video)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    host = tmp_path / "farneback"
    extract.extract_frames(port_model, _port_cfg(flow_backend="farneback", processes=2),
                           frames, str(host), output_img=False, output_feature=False,
                           output_motion=True)
    for k in range(1, len(frames)):
        got = np.load(host / "motion" / f"{k + 1:06}.npy")
        _, want = jflow.calc_optical_flow(frames[k - 1], frames[k], (2 * FLOW_H, FLOW_H))
        np.testing.assert_array_equal(got, want)
