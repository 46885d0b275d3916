"""PyTorch port, K3 — the stem's cube-padded 3x3 / stride-2 max pool —
against the JAX package on the CPU.

The port's plain version (cube pad + ``F.max_pool2d``) is held bit for bit
against the JAX package's ``cube_pad_max_pool_3x3s2`` in all four of its
forms, in f32 and bf16, and against the TPU kernels themselves
(``tools/bench_pool_pallas.py``'s interior pools, run in Pallas interpret
mode, plus ``make_full_op``'s halo max).  Max is exact, so every tolerance
here is zero: equal values, NaN where the reference has NaN.

Inputs differ per face and per position (a seeded permutation of distinct
values), so a flipped or transposed halo strip changes some window's max
and shows at the cube seams.  The kernel itself runs on the card only
(``tests/test_torch_cuda.py``).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp360_tpu.ops import cube_pad as jax_cp
from cp360_tpu_torch.ops import cube_pad, cube_pool

ROOT = Path(__file__).resolve().parent.parent
SHAPE = (2, 6, 16, 16, 8)


def _distinct(seed, shape=SHAPE):
    """Distinct f32 values, shuffled over faces, positions and channels."""
    n = int(np.prod(shape))
    return (np.random.RandomState(seed).permutation(n).astype(np.float32) / n - 0.5
            ).reshape(shape)


def _with_specials(x):
    """Plant +inf, -inf and NaN on face edges and corners (rows/cols 0 and
    H-1, which feed the neighbours' halos) and one in the interior."""
    x = x.copy()
    h = x.shape[2]
    x[0, 0, 0, 0, 0] = np.nan  # corner of B: read by its own row/col 0
    x[0, 5, 0, h - 1, 1] = np.inf  # top face, top-right corner
    x[1, 3, h - 1, 0, 2] = -np.inf  # left face, bottom-left corner
    x[1, 2, 0, 5, 3] = np.nan  # front, top edge: front's top halo row
    x[0, 4, 7, h - 1, 4] = np.inf  # right face, right edge
    x[1, 1, h - 1, 6, 5] = np.nan  # down face, bottom edge
    x[0, 2, 9, 9, 6] = np.nan  # interior
    x[1, 4, :, 0, 7] = -np.inf  # a whole -inf column at a seam
    return x


def _as(dtype, x):
    """(torch tensor, jax array) holding the same values in ``dtype``."""
    t = torch.from_numpy(x).to(dtype)
    j = jnp.asarray(t.float().numpy())
    return t, (j.astype(jnp.bfloat16) if dtype == torch.bfloat16 else j)


def _assert_same(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got, want)  # NaN == NaN here


@pytest.mark.parametrize("form", ["fused2d", "fused2d_dus", "separable", "pairmax"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("specials", [False, True])
def test_plain_matches_jax_forms(form, dtype, specials):
    x = _distinct(0)
    if specials:
        x = _with_specials(x)
    t, j = _as(dtype, x)
    got = cube_pool.cube_pad_max_pool_3x3s2_plain(t)
    assert got.dtype == dtype and tuple(got.shape) == (2, 6, 8, 8, 8)
    want = jax_cp.cube_pad_max_pool_3x3s2(j, form=form)
    _assert_same(got.float().numpy(), want.astype(jnp.float32))


def _pallas_tool():
    spec = importlib.util.spec_from_file_location(
        "bench_pool_pallas", ROOT / "tools" / "bench_pool_pallas.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel,variant", [
    ("interior", "stride"), ("interior", "reshape"), ("interior", "lanefold_concat"),
    ("interior", "lanefold_roll"), ("rowgrid", "concat"), ("rowgrid", "roll")])
def test_plain_matches_pallas_kernels_interpret(kernel, variant):
    """The TPU kernels K3a (make_pool_interior) and K3b
    (make_pool_interior_rowgrid), in interpret mode, with make_full_op's
    halo max (tools/bench_pool_pallas.py:211-224)."""
    tool = _pallas_tool()
    x = _with_specials(_distinct(1))
    xs = jnp.asarray(x)
    if kernel == "interior":
        interior = tool.make_pool_interior(variant, interpret=True)
    else:
        interior = tool.make_pool_interior_rowgrid(variant, interpret=True)
    n, six, h, w, c = xs.shape
    halo_t, halo_l = jax_cp._pool_halo_strips_slice(xs)
    pooled = interior(xs.reshape(n * six, h, w, c)).reshape(n, six, h // 2, w // 2, c)

    def win3(s):
        return jnp.maximum(jnp.maximum(s[:, :, 0:-2:2], s[:, :, 1:-1:2]), s[:, :, 2::2])

    pooled = pooled.at[:, :, 0].set(jnp.maximum(pooled[:, :, 0], win3(halo_t)))
    want = pooled.at[:, :, :, 0].set(jnp.maximum(pooled[:, :, :, 0], win3(halo_l)))
    got = cube_pool.cube_pad_max_pool_3x3s2_plain(torch.from_numpy(x))
    _assert_same(got.numpy(), want)


@pytest.mark.parametrize("h", [4, 16, 112])
def test_halo_table_is_the_jax_halo_strips(h):
    """The kernel's source table names the pixels _pool_halo_strips_slice
    takes, in its order (row 0 over columns 0..W, then column 0 over rows
    0..H, per face)."""
    idx = jnp.arange(6 * h * h, dtype=jnp.float32).reshape(1, 6, h, h, 1)
    halo_t, halo_l = jax_cp._pool_halo_strips_slice(idx)
    want = np.concatenate([np.asarray(halo_t).reshape(-1), np.asarray(halo_l).reshape(-1)])
    table = cube_pool.halo_table(h)
    assert table.dtype == np.int32 and table.shape == (12 * (h + 1),)
    np.testing.assert_array_equal(table, want.astype(np.int32))


def test_dispatch_on_cpu_runs_the_plain_version_and_counts_nothing():
    x = torch.from_numpy(_distinct(2))
    before = cube_pool.launches
    got = cube_pad.cube_pad_max_pool_3x3s2(x)
    assert cube_pool.launches == before
    assert torch.equal(got, cube_pool.cube_pad_max_pool_3x3s2_plain(x))


@pytest.mark.parametrize("shape", [(1, 6, 7, 7, 8), (1, 6, 8, 6, 8), (1, 5, 8, 8, 8),
                                   (6, 8, 8, 8)])
def test_rejects_odd_nonsquare_and_wrong_faces(shape):
    with pytest.raises(ValueError):
        cube_pool.cube_pad_max_pool_3x3s2(torch.zeros(shape))
