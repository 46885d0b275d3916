"""Fused CubePad(1) + 3x3 VALID conv + bias on small cube feature maps.

The op the ConvLSTM runs 3 times per step on [N, 6, 7, 7, C] CAM cubes
(reference model/clstm.py:57-65).  It replaces the TPU kernel
``cp360_tpu/ops/pallas_kernels.py::cube_conv3x3``: on a CUDA tensor
:func:`cube_conv3x3` launches the hand-written Hopper kernel in
``csrc/cube_conv3x3.cu`` (an implicit GEMM whose A tiles gather the cube
padding through :func:`source_table`; its header states the bound); on a
CPU tensor it runs :func:`cube_conv3x3_plain`, the counterpart of
``cube_conv3x3_reference`` (cube pad, then a VALID conv).

``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from cp360_tpu_torch.models import layers
from cp360_tpu_torch.ops import _build
from cp360_tpu_torch.ops.cube_pad import build_cube_pad_index_map, cube_pad

launches = 0


@lru_cache(maxsize=8)
def source_table(h: int, w: int) -> np.ndarray:
    """int32 [9, 6hw]: entry [k, p] is the face pixel (flat over the cube)
    that tap k = 3*dy + dx of output position p reads through cube padding."""
    pad_map = build_cube_pad_index_map(h, w, (1, 1, 1, 1))  # [6, h+2, w+2]
    rows = 6 * h * w
    return np.stack([pad_map[:, dy:dy + h, dx:dx + w].reshape(rows)
                     for dy in range(3) for dx in range(3)]).astype(np.int32)


@lru_cache(maxsize=8)
def _table_on(h: int, w: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(source_table(h, w)).to(device)


@lru_cache(maxsize=1)
def _lib():
    lib = _build.load("cube_conv3x3")
    ptr = ctypes.c_void_p
    lib.cp360_cube_conv3x3.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ptr]
    lib.cp360_cube_conv3x3.restype = ctypes.c_int
    return lib


def cube_conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cube pad, then a VALID conv with bias: [N, 6, h, h, Cin] ->
    [N, 6, h, h, Cout] in x.dtype (the kernel's plain version)."""
    n, _, h, ww, cin = x.shape
    xp = cube_pad(x, 1).reshape(n * 6, h + 2, ww + 2, cin)
    out = layers.conv2d(xp, w, b)
    return out.reshape(n, 6, h, ww, -1)


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.ndim != 5 or x.shape[1] != 6 or x.shape[2] != x.shape[3]:
        raise ValueError(f"x must be [N, 6, h, h, Cin], got {tuple(x.shape)}")
    cin = x.shape[4]
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be [3, 3, {cin}, Cout], got {tuple(w.shape)}")
    if tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"b must be [{w.shape[3]}], got {tuple(b.shape)}")
    if len({x.device, w.device, b.device}) != 1:
        raise ValueError(f"x, w, b on different devices: {x.device}, {w.device}, {b.device}")


def cube_conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cube-padded 3x3 VALID conv + bias on cube feature maps.

    Args:
      x: [N, 6, h, h, Cin] cube features (bf16 or f32), faces B D F L R T.
      w: [3, 3, Cin, Cout] HWIO kernel, x's dtype.
      b: [Cout] bias, x's dtype.

    Returns [N, 6, h, h, Cout] in x.dtype, accumulated in f32.  A CUDA
    tensor launches the kernel (contiguous operands; bf16 needs Cin and
    Cout divisible by 8); a CPU tensor runs the plain version.
    """
    global launches
    _check(x, w, b)
    if x.device.type == "cpu":
        return cube_conv3x3_plain(x, w, b)
    if not x.is_cuda:
        raise ValueError(f"cube_conv3x3 runs on CUDA or CPU tensors, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or {w.dtype, b.dtype} != {x.dtype}:
        raise TypeError(f"cube_conv3x3 takes bf16 or f32 operands of one dtype, "
                        f"got {x.dtype}, {w.dtype}, {b.dtype}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("cube_conv3x3 needs contiguous x, w, b")
    n, _, h, ww, cin = x.shape
    cout = w.shape[3]
    is_bf16 = x.dtype == torch.bfloat16
    if is_bf16 and (cin % 8 or cout % 8):
        raise ValueError(f"the bf16 kernel needs Cin and Cout divisible by 8, got {cin}, {cout}")
    out = torch.empty((n, 6, h, ww, cout), dtype=x.dtype, device=x.device)
    if is_bf16 and any(t.data_ptr() % 16 for t in (x, w, out)):
        raise ValueError("the bf16 kernel needs 16-byte aligned x, w and out")
    if n == 0:
        return out
    tab = _table_on(h, ww, x.device)
    with torch.cuda.device(x.device):
        err = _lib().cp360_cube_conv3x3(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), tab.data_ptr(), out.data_ptr(),
            n * 6 * h * ww, 6 * h * ww, cin, cout, int(is_bf16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cube_conv3x3 kernel launch failed: CUDA error {err}")
    launches += 1
    return out
