"""PyTorch port, ops and geometry: held against the JAX package on the CPU.

The same numpy inputs go through the JAX function and the port's; the
port runs on CPU tensors here (its kernels' plain versions).  Tolerances:
exact where the port performs the same selection (index maps, pads, max
pools), 1e-6 for the bilinear gathers (same f32 arithmetic in the same
order), 1e-5 for the cube->equi product (f32 sums in another order).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp360_tpu import geometry as jgeo
from cp360_tpu.ops import cube_pad as jcp
from cp360_tpu.ops import resample as jrs
from cp360_tpu.ops.slot_gather import apply_plan_pallas, equi_cube_plan
from cp360_tpu_torch import geometry as tgeo
from cp360_tpu_torch.ops import cube_pad as tcp
from cp360_tpu_torch.ops import equi_gather
from cp360_tpu_torch.ops import resample as trs

torch.set_num_threads(2)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
CUBE_GOLDEN = np.load(os.path.join(GOLDEN_DIR, "cube_pad.npz"))
CASES = sorted({k.rsplit("_", 1)[0] for k in CUBE_GOLDEN.files if k.endswith("_in")})


def _cube(rng, n, h, c, dtype=np.float32):
    return rng.randn(n, 6, h, h, c).astype(dtype)


@pytest.mark.parametrize("h,pads", [
    (8, (1, 1, 1, 1)), (7, (1, 1, 1, 1)), (8, (3, 3, 3, 3)), (5, (2, 2, 2, 2)),
    (8, (1, 2, 0, 3)), (8, (0, 0, 1, 1)), (8, (2, 0, 0, 1)), (6, (0, 1, 0, 2)),
    (4, (3, 1, 2, 0)), (8, 0),
])
def test_index_map_equals_jax(h, pads):
    np.testing.assert_array_equal(tcp.build_cube_pad_index_map(h, h, pads),
                                  jcp.build_cube_pad_index_map(h, h, pads))


@pytest.mark.parametrize("case", CASES)
def test_cube_pad_golden_and_jax(case):
    x = CUBE_GOLDEN[f"{case}_in"]  # reference [6N, C, H, W]
    pad = tuple(int(p) for p in CUBE_GOLDEN[f"{case}_pad"])
    n = x.shape[0] // 6
    x6 = x.reshape(n, 6, *x.shape[1:]).transpose(0, 1, 3, 4, 2)
    got = tcp.cube_pad(torch.from_numpy(np.ascontiguousarray(x6)), pad).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcp.cube_pad(jnp.asarray(x6), pad)))
    want = CUBE_GOLDEN[f"{case}_out"]
    got_nchw = got.transpose(0, 1, 4, 2, 3).reshape(want.shape)
    np.testing.assert_array_equal(got_nchw, want)


def test_cube_pad_face_batch_and_zero_pad():
    x = _cube(np.random.RandomState(1), 2, 6, 3)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(tcp.cube_pad(xt[0], 2).numpy(),
                                  tcp.cube_pad(xt, 2).numpy()[0])
    np.testing.assert_array_equal(tcp.zero_pad(xt, (1, 2, 0, 3)).numpy(),
                                  np.asarray(jcp.zero_pad(jnp.asarray(x), (1, 2, 0, 3))))
    with pytest.raises(ValueError):
        tcp.cube_pad(torch.zeros(1, 6, 4, 5, 2), 1)


@pytest.mark.parametrize("h,c,dtype", [(8, 5, np.float32), (14, 3, np.float32),
                                       (16, 4, np.float16)])
def test_stem_pool_bit_exact(h, c, dtype):
    x = _cube(np.random.RandomState(3), 2, h, c, dtype)
    got = tcp.cube_pad_max_pool_3x3s2(torch.from_numpy(x)).numpy()
    want = np.asarray(jcp.cube_pad_max_pool_3x3s2(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("face_w,eh", [(32, 128), (224, 960)])
def test_geometry_maps_equal_jax(face_w, eh):
    for a, b in zip(tgeo.build_equi2cube_maps(face_w, eh, 2 * eh),
                    jgeo.build_equi2cube_maps(face_w, eh, 2 * eh)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tgeo.build_cube2equi_map(7), jgeo.build_cube2equi_map(7)):
        np.testing.assert_array_equal(a, b)


FW, H = 32, 64


@pytest.fixture(scope="module")
def equi():
    return np.random.RandomState(0).rand(2, H, 2 * H, 3).astype(np.float32)


def test_equi_to_cube_equals_jax(equi):
    want = np.asarray(jrs.equi_to_cube(jnp.asarray(equi), FW))
    got = trs.equi_to_cube(torch.from_numpy(equi), FW).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    got1 = trs.equi_to_cube(torch.from_numpy(equi[0]), FW).numpy()
    np.testing.assert_allclose(got1, want[0], atol=1e-6)


def test_equi_to_cube_equals_pallas_slot_gather(equi):
    """The port's equi->cube (K2's plain version) against the TPU kernel it
    replaces, run in interpret mode on [B, H, W] planes."""
    plan = equi_cube_plan(FW, H, 2 * H)
    src = jnp.moveaxis(jnp.asarray(equi), -1, 1).reshape(6, H, 2 * H)
    pal = np.asarray(apply_plan_pallas(plan, src, interpret=True))
    pal = pal[:, : 6 * FW].reshape(2, 3, 6, FW, FW).transpose(0, 2, 3, 4, 1)
    got = trs.equi_to_cube(torch.from_numpy(equi), FW).numpy()
    np.testing.assert_allclose(got, pal, atol=1e-6)


def test_u8_frames_divide_then_sample_as_stage1():
    """equi_gather.equi_to_cube on u8 frames is stage 1's /255 then the
    f32 gather (cp360_tpu/pipelines/extract.py:313-314)."""
    frames = np.random.RandomState(4).randint(0, 256, (2, H, 2 * H, 3)).astype(np.uint8)
    want = np.asarray(jrs.equi_to_cube(jnp.asarray(frames, jnp.float32) / 255.0, FW))
    got = equi_gather.equi_to_cube(torch.from_numpy(frames), FW)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 6, FW, FW, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_equi_gather_rejects_bad_input():
    with pytest.raises(ValueError):
        equi_gather.equi_to_cube(torch.zeros(H, 2 * H, 3, dtype=torch.uint8), FW)
    with pytest.raises(TypeError):
        equi_gather.equi_to_cube(torch.zeros(1, H, 2 * H, 3, dtype=torch.int32), FW)
    with pytest.raises(ValueError):
        equi_gather.equi_to_cube(torch.zeros(1, H, 2 * H, 3, device="meta"), FW)


@pytest.mark.parametrize("w,c", [(7, 16), (4, 3), (24, 2)])
def test_cube_to_equi_equals_jax(w, c):
    """Matrix form (w <= 20) and gather form (w > 20)."""
    faces = np.random.RandomState(w).randn(2, 6, w, w, c).astype(np.float32)
    want = np.asarray(jrs.cube_to_equi(jnp.asarray(faces)))
    got = trs.cube_to_equi(torch.from_numpy(faces)).numpy()
    assert got.shape == (2, 2 * w, 4 * w, c)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(trs.cube_to_equi(torch.from_numpy(faces[0])).numpy(),
                               want[0], atol=1e-5, rtol=1e-5)


def test_cube2equi_matrix_equals_jax():
    np.testing.assert_array_equal(trs.build_cube2equi_matrix(7),
                                  jrs.build_cube2equi_matrix(7))
