"""Equirectangular frames -> cube faces, with the /255 of stage 1 fused.

The counterpart of ``cp360_tpu/ops/slot_gather.py``: on a CUDA tensor
:func:`equi_to_cube` launches the hand-written kernel in
``csrc/equi_to_cube.cu``, which replaces the TPU kernels of
``apply_plan_pallas`` with one direct 4-tap gather (its header states the
bound); on a CPU tensor it runs :func:`equi_to_cube_plain`, the port's
``resample.equi_to_cube``.

``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

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
    then sampled, as ``stage1_batch`` does; an f32 frame is sampled as is."""
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
