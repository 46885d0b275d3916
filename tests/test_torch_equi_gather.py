"""PyTorch port, K2 (equi -> cube) on the CPU: the arithmetic the kernel
uses in place of IEEE operations, the byte count of its bound, and its
plain version against the JAX package at full geometry.

The kernel itself runs on the card only (tests/test_torch_cuda.py holds it
bit for bit against the plain version).  Here: its /255 (a product with
RN(1/255) and one FMA correction) and its u8 -> f32 conversion (a byte
under the exponent of 2^23) are replayed exactly, in rational arithmetic,
for all 256 byte values against IEEE division, the one the plain version
uses on the CPU; ``source_bytes`` / ``source_sectors`` against a brute-force
count; and the plain version at 960x1920 -> 224 against
``cp360_tpu/ops/resample.py::equi_to_cube`` on frame / 255 within 1e-6
(the same f32 arithmetic in the same order).
"""

import re
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp360_tpu.ops import resample as jrs
from cp360_tpu_torch.geometry import equi_cube
from cp360_tpu_torch.ops import _build, equi_gather

torch.set_num_threads(2)


def _rn32(x: Fraction) -> np.float32:
    """x rounded to the nearest f32, ties to even (exact, no double rounding)."""
    c = np.float32(float(x))
    cands = (np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf)))
    return min(cands, key=lambda d: (abs(Fraction(float(d)) - x), int(d.view(np.int32)) & 1))


def _kernel_inv255() -> np.float32:
    src = (_build.CSRC / "equi_to_cube.cu").read_text()
    return np.float32(float.fromhex(re.search(r"kInv255 = (0x[0-9a-fA-Fp.+-]+)f;", src)[1]))


def test_kernel_div255_equals_ieee_division_for_every_byte():
    """div255 in csrc/equi_to_cube.cu: q = RN(v r), e = RN(v - 255 q) (one
    FMA), RN(q + e r) (one FMA), replayed exactly: equal to numpy's
    float32(v) / float32(255) and to the plain version's torch division."""
    r = _kernel_inv255()
    assert r == np.float32(1) / np.float32(255)
    fr = Fraction(float(r))
    want = np.arange(256, dtype=np.float32) / np.float32(255)
    plain = (torch.arange(256, dtype=torch.uint8).float() / 255.0).numpy()
    np.testing.assert_array_equal(plain.view(np.int32), want.view(np.int32))
    got = []
    for v in range(256):
        q = _rn32(v * fr)
        e = _rn32(v - 255 * Fraction(float(q)))
        got.append(_rn32(Fraction(float(q)) + Fraction(float(e)) * fr))
    np.testing.assert_array_equal(np.array(got, np.float32).view(np.int32), want.view(np.int32))


def test_kernel_byte_to_float_is_exact():
    """span_byte: PRMT puts a byte under 0x4B 0x00 0x00, the f32 2^23 + byte;
    subtracting 2^23 leaves the byte's value exactly."""
    v = np.arange(256, dtype=np.uint32)
    got = (v | np.uint32(0x4B000000)).view(np.float32) - np.float32(2 ** 23)
    np.testing.assert_array_equal(got, v.astype(np.float32))


def _brute_force_taps(face_w, h, w):
    in_x, in_y = equi_cube.build_equi2cube_maps(face_w, h, w)
    pix = set()
    for xs, ys in zip(in_x.astype(np.float32).ravel(), in_y.astype(np.float32).ravel()):
        x0, y0 = int(np.floor(xs)), int(np.floor(ys))
        for y in (y0, y0 + 1):
            for x in (x0, x0 + 1):
                pix.add((min(max(y, 0), h - 1), min(max(x, 0), w - 1)))
    return pix


@pytest.mark.parametrize("c,itemsize", [(3, 1), (3, 4), (1, 1), (16, 4)])
def test_source_bytes_and_sectors_equal_a_brute_force_count(c, itemsize):
    pix = _brute_force_taps(32, 64, 128)
    assert equi_gather.source_bytes(32, 64, 128, c, itemsize) == len(pix) * c * itemsize
    sectors = {((y * 128 + x) * c * itemsize + b) // 32
               for y, x in pix for b in range(c * itemsize)}
    assert equi_gather.source_sectors(32, 64, 128, c, itemsize) == len(sectors)


def test_source_bytes_at_full_geometry():
    """960x1920 -> 224: 1,043,349 distinct tap pixels (56.6% of the frame),
    152,590 of the frame's 172,800 sectors."""
    assert equi_gather.source_bytes(224, 960, 1920, 3) == 1_043_349 * 3
    assert equi_gather.source_sectors(224, 960, 1920, 3) == 152_590


def test_plain_equals_jax_at_full_geometry():
    """One u8 960x1920 frame -> 224 faces: the kernel's plain version against
    the JAX package's equi_to_cube on frame / 255."""
    frame = np.random.RandomState(21).randint(0, 256, (1, 960, 1920, 3)).astype(np.uint8)
    want = np.asarray(jrs.equi_to_cube(jnp.asarray(frame, jnp.float32) / 255.0, 224))
    got = equi_gather.equi_to_cube(torch.from_numpy(frame), 224)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 6, 224, 224, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
