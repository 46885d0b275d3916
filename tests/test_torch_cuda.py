"""PyTorch port, CUDA kernels against their plain versions on the card.

The kernels build (nvcc) and run only on a CUDA device, so every test here
carries the ``cuda`` marker and skips without one.  This file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: bf16 kernel output against the f32 plain version on the same
bf16-rounded inputs at 1e-2 of max|ref| (both accumulate in f32; they differ
by summation order and the kernel's one bf16 rounding, at most one bf16 ulp
~0.4%); f32 at 1e-4 of max|ref| + 1e-4; the equi->cube gather at 1e-6.  The
input-gradient kernel (dx) is held the same way against autograd of the
plain cube pad + conv.  The stem pool (K3) is held bit for bit: max is
exact, so equal bits wherever the plain version is not NaN, and NaN where
it is.
"""

import numpy as np
import pytest
import torch

from cp360_tpu_torch.ops import cube_conv, cube_pool, equi_gather


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels run on the card only")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _conv_inputs(seed, n, cin, cout):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6, 7, 7, cin).astype(np.float32)
    w = (rng.randn(3, 3, cin, cout) * (2.0 / (9 * cin)) ** 0.5).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, w, b


def _conv_inputs_h(seed, n, h, cin, cout):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 6, h, h, cin).astype(np.float32)
    w = (rng.randn(3, 3, cin, cout) * (2.0 / (9 * cin)) ** 0.5).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, w, b


# ragged M (n = 1, 3: 294 and 882 rows against 128-row tiles), Cout 4000
# and 2000 (against 256-column tiles), Cin 24 -> Cout 40 (less than one
# 64-deep step), Cin != Cout (a swapped transpose cannot hide) and h = 4
CONV_CASES = [
    (torch.bfloat16, 1, 7, 2000, 4000), (torch.bfloat16, 3, 7, 4000, 2000),
    (torch.bfloat16, 2, 7, 136, 264), (torch.bfloat16, 1, 7, 24, 40),
    (torch.bfloat16, 3, 4, 200, 72), (torch.float32, 2, 7, 64, 96),
    (torch.float32, 1, 7, 20, 12), (torch.float32, 1, 4, 24, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,h,cin,cout", CONV_CASES)
def test_cuda_cube_conv_matches_plain(cuda, dtype, n, h, cin, cout):
    x, w, b = (torch.from_numpy(a).to(cuda, dtype)
               for a in _conv_inputs_h(4, n, h, cin, cout))
    before = cube_conv.launches
    got = cube_conv.cube_conv3x3(x, w, b)
    assert cube_conv.launches == before + 1 and got.dtype == dtype
    ref = cube_conv.cube_conv3x3_plain(x.float(), w.float(), b.float())
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    tol = 1e-2 * scale if dtype == torch.bfloat16 else 1e-4 * scale + 1e-4
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 9])
@pytest.mark.parametrize("n,cin,cout", [(1, 2000, 4000), (3, 264, 136)])
def test_cuda_cube_conv_bf16_repeats_bit_for_bit(cuda, splits, n, cin, cout):
    """Two launches give the same bits, with and without the depth split;
    every split count agrees with the plain version."""
    x, w, b = (torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in _conv_inputs_h(13, n, 7, cin, cout))
    first = cube_conv._forward(x, w, b, splits=splits)
    second = cube_conv._forward(x, w, b, splits=splits)
    dx1 = cube_conv._dx(first, w, splits=splits)
    dx2 = cube_conv._dx(first, w, splits=splits)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
    assert torch.equal(dx1.view(torch.int16), dx2.view(torch.int16))
    ref = cube_conv.cube_conv3x3_plain(x.float(), w.float(), b.float())
    assert (first.float() - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(2000, 4000), (4000, 2000)])
def test_cuda_cube_conv_bf16_does_not_depend_on_the_batch(cuda, cin, cout):
    """Each cube's output, forward and dx, is the same bits in a batch of 3
    as alone: the depth split is one count per conv shape."""
    x, w, b = (torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in _conv_inputs_h(14, 3, 7, cin, cout))
    out = cube_conv.cube_conv3x3(x, w, b)
    dx = cube_conv.cube_conv3x3_dx(out, w)
    for i in range(3):
        alone = cube_conv.cube_conv3x3(x[i:i + 1].contiguous(), w, b)
        assert torch.equal(alone.view(torch.int16), out[i:i + 1].view(torch.int16))
        dx_alone = cube_conv.cube_conv3x3_dx(out[i:i + 1].contiguous(), w)
        assert torch.equal(dx_alone.view(torch.int16), dx[i:i + 1].view(torch.int16))


@pytest.mark.cuda
def test_cuda_cube_conv_rejects_what_the_kernel_does_not_take(cuda):
    x, w, b = (torch.from_numpy(a).to(cuda) for a in _conv_inputs(6, 1, 12, 8))
    with pytest.raises(ValueError):  # bf16 needs Cin % 8 == 0
        cube_conv.cube_conv3x3(x.bfloat16(), w.bfloat16(), b.bfloat16())
    with pytest.raises(TypeError):
        cube_conv.cube_conv3x3(x.half(), w.half(), b.half())
    with pytest.raises(ValueError):
        cube_conv.cube_conv3x3(x.transpose(2, 3), w, b)
    x16 = torch.randn(1, 6, 7, 7, 16, device=cuda, dtype=torch.bfloat16)
    w16 = torch.randn(3, 3, 16, 8, device=cuda, dtype=torch.bfloat16)
    b16 = torch.zeros(8, device=cuda, dtype=torch.bfloat16)
    buf = torch.empty(x16.numel() + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # 16-byte alignment of the bf16 operands
        cube_conv.cube_conv3x3(buf[1:].view(x16.shape), w16, b16)


def _tol(ref, dtype):
    scale = ref.abs().max().item()
    return 1e-2 * scale if dtype == torch.bfloat16 else 1e-4 * scale + 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,h,cin,cout", CONV_CASES + [(torch.bfloat16, 1, 7, 4000, 4000)])
def test_cuda_cube_conv_dx_matches_plain(cuda, dtype, n, h, cin, cout):
    _, w, _ = _conv_inputs_h(7, n, h, cin, cout)
    dy = np.random.RandomState(8).randn(n, 6, h, h, cout).astype(np.float32)
    tdy, tw = (torch.from_numpy(a).to(cuda, dtype) for a in (dy, w))
    before = cube_conv.dx_launches
    got = cube_conv.cube_conv3x3_dx(tdy, tw)
    assert cube_conv.dx_launches == before + 1 and got.dtype == dtype
    assert tuple(got.shape) == (n, 6, h, h, cin)
    ref = cube_conv.cube_conv3x3_dx_plain(tdy.float(), tw.float())
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    assert err <= _tol(ref, dtype), (err, _tol(ref, dtype))


@pytest.mark.cuda
def test_cuda_cube_conv_dx_rejects_what_the_kernel_does_not_take(cuda):
    _, w, _ = _conv_inputs(9, 1, 12, 8)
    dy = torch.randn(1, 6, 7, 7, 8, device=cuda)
    w = torch.from_numpy(w).to(cuda)
    with pytest.raises(ValueError):  # bf16 needs Cin % 8 == 0
        cube_conv.cube_conv3x3_dx(dy.bfloat16(), w.bfloat16())
    with pytest.raises(TypeError):
        cube_conv.cube_conv3x3_dx(dy.half(), w.half())
    with pytest.raises(TypeError):  # mixed dtypes
        cube_conv.cube_conv3x3_dx(dy, w[..., :8].bfloat16())
    with pytest.raises(ValueError):
        cube_conv.cube_conv3x3_dx(dy.transpose(2, 3), w)
    w16 = torch.randn(3, 3, 16, 8, device=cuda, dtype=torch.bfloat16)
    buf = torch.empty(1 * 6 * 7 * 7 * 8 + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # 16-byte alignment of the bf16 operands
        cube_conv.cube_conv3x3_dx(buf[1:].view(1, 6, 7, 7, 8), w16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_cube_conv_train_grads_match_plain(cuda, dtype):
    """cube_conv3x3_train's dx, dw, db on the card against autograd of the
    plain version in f32 (f32 masters, compute-dtype copies)."""
    x, w, b = _conv_inputs(10, 2, 64, 32)
    g = torch.from_numpy(np.random.RandomState(11).randn(2, 6, 7, 7, 32).astype(np.float32))
    g = g.to(cuda)
    xc = torch.from_numpy(x).to(cuda, dtype).requires_grad_()
    tw, tb = (torch.from_numpy(a).to(cuda).requires_grad_() for a in (w, b))
    before = (cube_conv.launches, cube_conv.dx_launches)
    out = cube_conv.cube_conv3x3_train(xc, tw, tb, tw.to(dtype), tb.to(dtype))
    (out.float() * g).sum().backward()
    assert (cube_conv.launches, cube_conv.dx_launches) == (before[0] + 1, before[1] + 1)
    px = xc.detach().float().requires_grad_()
    pw, pb = (t.detach().to(dtype).float().requires_grad_() for t in (tw, tb))
    (cube_conv.cube_conv3x3_plain(px, pw, pb) * g.to(dtype).float()).sum().backward()
    torch.cuda.synchronize()
    for got, ref in ((xc.grad, px.grad), (tw.grad, pw.grad), (tb.grad, pb.grad)):
        err = (got.float() - ref).abs().max().item()
        assert err <= _tol(ref, dtype), (err, _tol(ref, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_cuda_equi_to_cube_matches_plain(cuda, dtype):
    rng = np.random.RandomState(5)
    frames = rng.randint(0, 256, (2, 64, 128, 3)).astype(np.uint8)
    t = torch.from_numpy(frames).to(cuda)
    t = t if dtype == torch.uint8 else t.float() / 255.0
    before = equi_gather.launches
    got = equi_gather.equi_to_cube(t, 32)
    assert equi_gather.launches == before + 1
    ref = equi_gather.equi_to_cube_plain(t.cpu(), 32)
    assert (got.cpu() - ref).abs().max().item() <= 1e-6


def _pool_input(seed, n, h, c, dtype, device):
    """Distinct values per face and position, with +-inf and NaN planted
    on face edges and corners (they feed the neighbours' halos)."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, 6, h, h, c)).astype(np.float32)
    x += np.arange(6, dtype=np.float32).reshape(1, 6, 1, 1, 1)
    x[0, 0, 0, 0, 0] = np.nan
    x[0, 5, 0, h - 1, 1] = np.inf
    x[-1, 3, h - 1, 0, 2] = -np.inf
    x[-1, 2, 0, 5, 3] = np.nan
    x[0, 1, h - 1, 3, c - 1] = np.nan
    x[-1, 4, :, 0, c // 2] = -np.inf
    return torch.from_numpy(x).to(device, dtype)


def _assert_bit_equal(got, ref):
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    ints = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(ints)[~nan], ref.view(ints)[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,h,c", [
    (torch.bfloat16, 2, 112, 64), (torch.bfloat16, 1, 16, 8),
    (torch.float32, 2, 112, 64), (torch.float32, 1, 8, 4),
])
def test_cuda_cube_pool_matches_plain_bit_for_bit(cuda, dtype, n, h, c):
    x = _pool_input(12, n, h, c, dtype, cuda)
    before = cube_pool.launches
    got = cube_pool.cube_pad_max_pool_3x3s2(x)
    assert cube_pool.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (n, 6, h // 2, h // 2, c)
    ref = cube_pool.cube_pad_max_pool_3x3s2_plain(x)
    torch.cuda.synchronize()
    _assert_bit_equal(got, ref)
    # and the CPU's plain version, the JAX package's twin
    _assert_bit_equal(got.cpu(), cube_pool.cube_pad_max_pool_3x3s2_plain(x.cpu()))


@pytest.mark.cuda
def test_cuda_cube_pool_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.randn(1, 6, 8, 8, 8, device=cuda)
    with pytest.raises(TypeError):
        cube_pool.cube_pad_max_pool_3x3s2(x.half())
    with pytest.raises(ValueError):  # C * 4 bytes not a multiple of 16
        cube_pool.cube_pad_max_pool_3x3s2(x[..., :6].contiguous())
    with pytest.raises(ValueError):
        cube_pool.cube_pad_max_pool_3x3s2(x.transpose(2, 3))
    with pytest.raises(ValueError):  # odd face
        cube_pool.cube_pad_max_pool_3x3s2(torch.zeros(1, 6, 7, 7, 8, device=cuda))
