"""Equirectangular frames -> cube faces, with the /255 of stage 1 fused.

The counterpart of ``cp360_tpu/ops/slot_gather.py``: on a CUDA tensor
:func:`equi_to_cube` launches the hand-written kernel in
``csrc/equi_to_cube.cu``, which replaces the TPU kernels of
``apply_plan_pallas`` with one direct 4-tap gather, one output pixel per
thread (its header states the bound and the design); on a CPU tensor it
runs :func:`equi_to_cube_plain`, the port's ``resample.equi_to_cube``.
The kernel's output is bit-equal to the plain version on the CPU.

:func:`source_bytes` counts the source bytes the gather needs, for the
kernel's bound.  ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from cp360_tpu_torch.geometry import equi_cube
from cp360_tpu_torch.ops import _build, resample

launches = 0


@lru_cache(maxsize=1)
def _lib():
    lib = _build.load("equi_to_cube")
    ptr = ctypes.c_void_p
    lib.cp360_equi_to_cube.argtypes = [ptr, ctypes.c_int, ptr, ptr, ptr] + \
        [ctypes.c_int] * 5 + [ptr]
    lib.cp360_equi_to_cube.restype = ctypes.c_int
    return lib


def equi_to_cube_plain(frames: torch.Tensor, face_w: int) -> torch.Tensor:
    """The kernel's plain version: a u8 frame is divided by 255 in f32 and
    then sampled, as ``stage1_batch`` does; an f32 frame is sampled as is.
    On the CPU the division is IEEE's, which the kernel reproduces."""
    src = frames.float() / 255.0 if frames.dtype == torch.uint8 else frames
    return resample.equi_to_cube_plain(src, face_w)


def equi_to_cube(frames: torch.Tensor, face_w: int) -> torch.Tensor:
    """[N, H, 2H, C] u8 or f32 equirectangular frames -> [N, 6, fw, fw, C]
    f32 cube faces (B D F L R T); a u8 frame comes out in [0, 1].

    A CUDA tensor launches the kernel (contiguous input); a CPU tensor runs
    the plain version.
    """
    global launches
    if frames.ndim != 4:
        raise ValueError(f"frames must be [N, H, 2H, C], got {tuple(frames.shape)}")
    if frames.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"frames must be uint8 or float32, got {frames.dtype}")
    if frames.device.type == "cpu":
        return equi_to_cube_plain(frames, face_w)
    if not frames.is_cuda:
        raise ValueError(f"equi_to_cube runs on CUDA or CPU tensors, got {frames.device}")
    if not frames.is_contiguous():
        raise ValueError("equi_to_cube needs a contiguous frame batch")
    n, h, w, c = frames.shape
    xs, ys = resample.equi2cube_maps(face_w, h, w, frames.device)  # checks w == 2h
    out = torch.empty((n, 6, face_w, face_w, c), dtype=torch.float32,
                      device=frames.device)
    if n == 0:
        return out
    with torch.cuda.device(frames.device):
        err = _lib().cp360_equi_to_cube(
            frames.data_ptr(), int(frames.dtype == torch.uint8), xs.data_ptr(),
            ys.data_ptr(), out.data_ptr(), n, h, w, c, face_w,
            torch.cuda.current_stream(frames.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"equi_to_cube kernel launch failed: CUDA error {err}")
    launches += 1
    return out


@lru_cache(maxsize=8)
def source_pixels(face_w: int, h: int, w: int) -> np.ndarray:
    """The distinct flat source pixels ``y * w + x`` that the 4 clamped
    taps of every face pixel read, sorted (the kernel's floor and clamp on
    the f32 maps of ``resample.equi2cube_maps``)."""
    in_x, in_y = equi_cube.build_equi2cube_maps(face_w, h, w)
    xs, ys = in_x.astype(np.float32), in_y.astype(np.float32)
    x0 = np.floor(xs).astype(np.int64)
    y0 = np.floor(ys).astype(np.int64)
    cols = (np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1))
    rows = (np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1))
    return np.unique(np.concatenate([(r * w + c).ravel() for r in rows for c in cols]))


def source_bytes(face_w: int, h: int, w: int, c: int, itemsize: int = 1) -> int:
    """Bytes of one [h, w, c] frame that the gather needs: each distinct
    tap pixel once (the input side of the kernel's bound)."""
    return int(source_pixels(face_w, h, w).size) * c * itemsize


def source_sectors(face_w: int, h: int, w: int, c: int, itemsize: int = 1) -> int:
    """32-byte sectors of one frame (from a sector-aligned frame start)
    that hold a byte the gather needs: what the memory system moves at
    its finest grain."""
    first = source_pixels(face_w, h, w) * (c * itemsize)
    last = first + c * itemsize - 1
    ends = [(first + k) // 32 for k in range(0, c * itemsize, 32)]
    return int(np.unique(np.concatenate(ends + [last // 32])).size)
