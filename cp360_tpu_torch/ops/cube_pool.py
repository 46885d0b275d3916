"""The ResNet stem's cube-padded 3x3 / stride-2 max pool (K3).

``max_pool(cube_pad(x, 1), 3, stride 2)`` on [N, 6, H, W, C] faces.  On a
CUDA tensor :func:`cube_pad_max_pool_3x3s2` launches the hand-written kernel
in ``csrc/cube_pool3x3s2.cu``, which replaces the TPU kernels
``tools/bench_pool_pallas.py::make_pool_interior`` and
``make_pool_interior_rowgrid`` together with their halo max (its header
states the bound); on a CPU tensor it runs :func:`cube_pad_max_pool_3x3s2_plain`,
the cube pad's ``index_select`` followed by ``F.max_pool2d``, which is bit
for bit the JAX package's ``cube_pad_max_pool_3x3s2``.  The kernel scans
each window in the plain version's order with its NaN-propagating compare,
so the two agree bit for bit too.

``launches`` counts the kernel's launches; a replay of a CUDA graph that
holds the kernel adds those its capture recorded (``models/cam.py``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from cp360_tpu_torch.models import layers
from cp360_tpu_torch.ops import _build
from cp360_tpu_torch.ops import cube_pad as cp

launches = 0

_VEC_BYTES = 16  # one thread moves 16 bytes of channels


@lru_cache(maxsize=1)
def _lib():
    lib = _build.load("cube_pool3x3s2")
    ptr = ctypes.c_void_p
    lib.cp360_cube_pool3x3s2.argtypes = [ptr, ctypes.c_int, ptr, ptr] + \
        [ctypes.c_int] * 3 + [ptr]
    lib.cp360_cube_pool3x3s2.restype = ctypes.c_int
    return lib


def halo_table(h: int) -> np.ndarray:
    """int32 [12*(h+1)]: the padded row 0 over columns 0..W of each face
    (``m[:, 0, :W+1]``), then the padded column 0 over rows 0..H
    (``m[:, :H+1, 0]``), as flat indices into a cube's [6*H*W] pixels — the
    entries ``cp360_tpu/ops/cube_pad.py::_pool_halo_strips_slice`` builds."""
    m = cp.build_cube_pad_index_map(h, h, 1)
    return np.concatenate([m[:, 0, :h + 1].reshape(-1),
                           m[:, :h + 1, 0].reshape(-1)]).astype(np.int32)


@lru_cache(maxsize=16)
def _halo_tensor(h: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(halo_table(h)).to(device)


def _check(x: torch.Tensor) -> None:
    cp._check_cube(x)
    if x.shape[2] % 2:
        raise ValueError(f"the fused stem pool needs an even face size, got {x.shape[2]}")


def cube_pad_max_pool_3x3s2_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: cube pad (one ``index_select``), then
    ``F.max_pool2d`` 3x3 / stride 2."""
    _check(x)
    n, _, h, w, c = x.shape
    xp = cp.cube_pad(x, 1).reshape(n * 6, h + 2, w + 2, c)
    return layers.max_pool(xp, 3, 2).reshape(n, 6, h // 2, w // 2, c)


def cube_pad_max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """[N, 6, H, W, C] (H = W, even) -> [N, 6, H/2, W/2, C], same dtype.

    A CUDA tensor launches the kernel (bf16 or f32, contiguous, C a
    multiple of 16 bytes, 16-byte aligned); a CPU tensor runs the plain
    version.
    """
    global launches
    _check(x)
    if x.device.type == "cpu":
        return cube_pad_max_pool_3x3s2_plain(x)
    if not x.is_cuda:
        raise ValueError(f"cube_pad_max_pool_3x3s2 runs on CUDA or CPU tensors, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the stem pool kernel takes bfloat16 or float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the stem pool kernel needs contiguous faces")
    n, _, h, _, c = x.shape
    if (c * x.element_size()) % _VEC_BYTES or x.data_ptr() % _VEC_BYTES:
        raise ValueError(f"the stem pool kernel needs C * itemsize a multiple of "
                         f"{_VEC_BYTES} and a {_VEC_BYTES}-byte aligned tensor "
                         f"(C={c}, {x.dtype})")
    out = torch.empty((n, 6, h // 2, h // 2, c), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    halo = _halo_tensor(h, x.device)
    with torch.cuda.device(x.device):
        err = _lib().cp360_cube_pool3x3s2(
            x.data_ptr(), int(x.dtype == torch.bfloat16), halo.data_ptr(),
            out.data_ptr(), n, h, c, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cube_pool3x3s2 kernel launch failed: CUDA error {err}")
    launches += 1
    return out
