"""PyTorch port, hand kernels: the wrappers' plain versions (what a CPU
tensor runs) against the TPU kernels they replace.  The CUDA kernels
themselves are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: f32 1e-4 and bf16 atol 0.15 / rtol 0.05, as
tests/test_pallas_kernels.py holds the Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp360_tpu.ops.pallas_kernels import (
    build_selection_matrix,
    cube_conv3x3 as jax_cube_conv3x3,
    cube_conv3x3_reference,
)
from cp360_tpu_torch.ops import cube_conv, equi_gather

torch.set_num_threads(2)


def _conv_inputs(seed, n, cin, cout, dtype=np.float32):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6, 7, 7, cin).astype(dtype)
    w = (rng.randn(3, 3, cin, cout) * 0.1).astype(dtype)
    b = rng.randn(cout).astype(dtype)
    return x, w, b


@pytest.mark.parametrize("h", [7, 4])
def test_source_table_equals_selection_matrix(h):
    """Row [k, p] of the kernel's source table is the column that the TPU
    kernel's 0/1 selection matrix picks for tap k of output position p."""
    rows = 6 * h * h
    sel = build_selection_matrix(h, h).reshape(9, rows, rows)
    tab = cube_conv.source_table(h, h)
    assert tab.dtype == np.int32 and tab.shape == (9, rows)
    np.testing.assert_array_equal(np.argmax(sel, axis=-1), tab)


@pytest.mark.parametrize("cin,cout", [(16, 24), (40, 16)])
def test_plain_cube_conv_equals_pallas_and_reference(cin, cout):
    x, w, b = _conv_inputs(0, 2, cin, cout)
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    got = cube_conv.cube_conv3x3(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b)).numpy()
    pallas = np.asarray(jax_cube_conv3x3(jx, jw, jb, ci_tile=16, co_tile=8,
                                         interpret=True))
    ref = np.asarray(cube_conv3x3_reference(jx, jw, jb))
    np.testing.assert_allclose(got, pallas, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_plain_cube_conv_bf16():
    x, w, b = _conv_inputs(1, 1, 32, 16)
    jx, jw, jb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))
    tx, tw, tb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b))
    got = cube_conv.cube_conv3x3(tx, tw, tb)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    pallas = np.asarray(jax_cube_conv3x3(jx, jw, jb, ci_tile=32, co_tile=16,
                                         interpret=True).astype(jnp.float32))
    ref = np.asarray(cube_conv3x3_reference(jx, jw, jb).astype(jnp.float32))
    np.testing.assert_allclose(got, pallas, atol=0.15, rtol=0.05)
    np.testing.assert_allclose(got, ref, atol=0.15, rtol=0.05)


def test_cube_conv_wrapper_rejects_bad_operands():
    x, w, b = (torch.from_numpy(a) for a in _conv_inputs(2, 1, 8, 8))
    with pytest.raises(ValueError):
        cube_conv.cube_conv3x3(x[:, :5], w, b)
    with pytest.raises(ValueError):
        cube_conv.cube_conv3x3(x, w[:, :, :4], b)
    with pytest.raises(ValueError):
        cube_conv.cube_conv3x3(x, w, b[:4])
    with pytest.raises(ValueError):
        cube_conv.cube_conv3x3(x.to("meta"), w.to("meta"), b.to("meta"))


def test_plain_paths_count_no_launches():
    before = (cube_conv.launches, equi_gather.launches)
    x, w, b = (torch.from_numpy(a) for a in _conv_inputs(3, 1, 8, 8))
    cube_conv.cube_conv3x3(x, w, b)
    equi_gather.equi_to_cube(torch.zeros(1, 16, 32, 3, dtype=torch.uint8), 8)
    assert (cube_conv.launches, equi_gather.launches) == before


@pytest.mark.parametrize("m,n,k", [(294, 4000, 4000), (2352, 4000, 4000), (2352, 2000, 4000),
                                   (294, 4000, 2000), (294, 40, 24), (96, 72, 200)])
def test_depth_split_units_cover_the_work_once(m, n, k):
    """For every split count, the bf16 kernel's work units cover each
    (step, M tile, N tile) exactly once, where a step is one tap's
    64-channel chunk: 9 taps x ceil(k / 64) chunks.  M = 294 and 2352 are
    one and 8 windows; 96 rows (h = 4) and Cin 24 are ragged."""
    steps = 9 * -(-k // cube_conv.BK)
    for splits in range(1, cube_conv.MAX_SPLITS + 1):
        seen = {}
        for m0, n0, first, end in cube_conv.work_units(m, n, k, splits):
            assert m0 < m and n0 < n and 0 <= first < end <= steps
            for step in range(first, end):
                seen[(step, m0, n0)] = seen.get((step, m0, n0), 0) + 1
        tiles = -(-m // cube_conv.BM) * -(-n // cube_conv.BN)
        assert len(seen) == steps * tiles and set(seen.values()) == {1}


def test_depth_split_rule():
    """One count per conv shape: the ConvLSTM's convs on 7x7 cubes split
    (one window alone fills 48 of 132 SMs), a conv whose K fits one step
    never pays for a second pass, and each count is one of the kernel's."""
    assert cube_conv.depth_splits(294, 4000, 4000, 132) == 2
    assert cube_conv.depth_splits(294, 4000, 2000, 132) == 2
    assert cube_conv.depth_splits(294, 2000, 4000, 132) > 1
    assert cube_conv.depth_splits(294, 40, 24, 132) == 1
    for p, n, k in [(96, 72, 200), (294, 1000, 4000), (24, 8, 8)]:
        assert 1 <= cube_conv.depth_splits(p, n, k, 132) <= cube_conv.MAX_SPLITS
