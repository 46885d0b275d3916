"""PyTorch port, CUDA kernels against their plain versions on the card.

The kernels build (nvcc) and run only on a CUDA device, so every test here
carries the ``cuda`` marker and skips without one.  This file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: bf16 kernel output against the f32 plain version on the same
bf16-rounded inputs at 1e-2 of max|ref| (both accumulate in f32; they differ
by summation order and the kernel's one bf16 rounding, at most one bf16 ulp
~0.4%); f32 at 1e-4 of max|ref| + 1e-4; the equi->cube gather at 1e-6.
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
