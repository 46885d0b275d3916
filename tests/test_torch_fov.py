"""PyTorch port, NFoV rendering (``imaging/fov.py``), against the JAX package.

The port's module is host numpy like the JAX one; the same seeded inputs go
through both at several yaw, pitch and fov settings, within 1e-6.  The
checks of tests/test_fov.py carry over to the port.
"""

import numpy as np
import pytest

from cp360_tpu.imaging import fov as jax_fov
from cp360_tpu.ops import resample as jax_resample
from cp360_tpu_torch.imaging import fov
from cp360_tpu_torch.ops import resample

VIEWS = [(0.0, 0.0, 65.5), (np.pi / 2, 0.0, 65.5), (-2.5, 0.7, 90.0), (0.3, -1.2, 40.0),
         (3.1, 1.5, 120.0)]


def _equi_gradient(h=128, w=256):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx / w, yy / h, 0.5 * np.ones_like(xx, float)], -1)
    return (img * 255).astype(np.float32)


@pytest.mark.parametrize("yaw,pitch,fov_deg", VIEWS)
def test_fov_functions_equal_jax(yaw, pitch, fov_deg):
    rng = np.random.RandomState(0)
    img = (rng.rand(96, 192, 3) * 255).astype(np.float32)
    for got, want in zip(fov.nfov_sample_coords(yaw, pitch, fov_deg, 24, 40, 96, 192),
                         jax_fov.nfov_sample_coords(yaw, pitch, fov_deg, 24, 40, 96, 192)):
        np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(fov.nfov_render(img, yaw, pitch, fov_deg, 24, 40),
                               jax_fov.nfov_render(img, yaw, pitch, fov_deg, 24, 40), atol=1e-6)
    np.testing.assert_array_equal(fov.fov_boundary_mask(yaw, pitch, fov_deg, 96, 192),
                                  jax_fov.fov_boundary_mask(yaw, pitch, fov_deg, 96, 192))
    u8 = img.astype(np.uint8)
    np.testing.assert_array_equal(fov.draw_fov_box(u8, yaw, pitch, fov_deg),
                                  jax_fov.draw_fov_box(u8, yaw, pitch, fov_deg))


def test_remap_bilinear_numpy_equals_jax():
    rng = np.random.RandomState(1)
    img = rng.rand(20, 30, 2).astype(np.float32)
    xs = rng.uniform(-2, 32, (7, 9))
    ys = rng.uniform(-2, 22, (7, 9))
    np.testing.assert_allclose(resample.remap_bilinear_numpy(img, xs, ys),
                               jax_resample.remap_bilinear_numpy(img, xs, ys), atol=1e-6)
    np.testing.assert_allclose(resample.remap_bilinear_numpy(img[..., 0], xs, ys),
                               jax_resample.remap_bilinear_numpy(img[..., 0], xs, ys), atol=1e-6)


def test_nfov_center_looks_forward():
    crop = fov.nfov_render(_equi_gradient(), yaw=0.0, pitch=0.0, out_h=64, out_w=64)
    assert crop.shape == (64, 64, 3)
    # the forward view's centre samples the equi centre column, red ~0.5
    assert abs(crop[32, 32, 0] / 255.0 - 0.5) < 0.02
    assert crop[0, 32, 1] < crop[-1, 32, 1]  # the vertical gradient survives


def test_nfov_yaw_shifts_view():
    right = fov.nfov_render(_equi_gradient(), yaw=np.pi / 2, pitch=0.0, out_h=32, out_w=32)
    assert abs(right[16, 16, 0] / 255.0 - 0.75) < 0.02  # theta = pi/2 -> x = 3w/4


def test_fov_boundary_mask_nonempty_and_local():
    mask = fov.fov_boundary_mask(0.3, 0.1, 65.5, 128, 256)
    assert mask.any()
    assert mask.mean() < 0.2  # a thin outline, not a filled region


def test_draw_fov_box_marks_pixels():
    img = _equi_gradient()
    out = fov.draw_fov_box(img, yaw=0.0, pitch=0.0)
    assert out.shape == img.shape
    assert (out != img).any()
    np.testing.assert_array_equal(img, _equi_gradient())  # the input is untouched
