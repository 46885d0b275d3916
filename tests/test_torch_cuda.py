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
plain cube pad + conv.
"""

import numpy as np
import pytest
import torch

from cp360_tpu_torch.ops import cube_conv, equi_gather


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,cin,cout", [
    (torch.bfloat16, 2, 2000, 4000), (torch.bfloat16, 1, 24, 40),
    (torch.float32, 2, 64, 96), (torch.float32, 1, 20, 12),
])
def test_cuda_cube_conv_matches_plain(cuda, dtype, n, cin, cout):
    x, w, b = (torch.from_numpy(a).to(cuda, dtype)
               for a in _conv_inputs(4, n, cin, cout))
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
def test_cuda_cube_conv_rejects_what_the_kernel_does_not_take(cuda):
    x, w, b = (torch.from_numpy(a).to(cuda) for a in _conv_inputs(6, 1, 12, 8))
    with pytest.raises(ValueError):  # bf16 needs Cin % 8 == 0
        cube_conv.cube_conv3x3(x.bfloat16(), w.bfloat16(), b.bfloat16())
    with pytest.raises(TypeError):
        cube_conv.cube_conv3x3(x.half(), w.half(), b.half())
    with pytest.raises(ValueError):
        cube_conv.cube_conv3x3(x.transpose(2, 3), w, b)


def _tol(ref, dtype):
    scale = ref.abs().max().item()
    return 1e-2 * scale if dtype == torch.bfloat16 else 1e-4 * scale + 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,cin,cout", [
    (torch.bfloat16, 2, 2000, 4000), (torch.bfloat16, 1, 4000, 4000),
    (torch.bfloat16, 1, 24, 40), (torch.float32, 2, 64, 96), (torch.float32, 1, 20, 12),
])
def test_cuda_cube_conv_dx_matches_plain(cuda, dtype, n, cin, cout):
    _, w, _ = _conv_inputs(7, n, cin, cout)
    dy = np.random.RandomState(8).randn(n, 6, 7, 7, cout).astype(np.float32)
    tdy, tw = (torch.from_numpy(a).to(cuda, dtype) for a in (dy, w))
    before = cube_conv.dx_launches
    got = cube_conv.cube_conv3x3_dx(tdy, tw)
    assert cube_conv.dx_launches == before + 1 and got.dtype == dtype
    assert tuple(got.shape) == (n, 6, 7, 7, cin)
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
