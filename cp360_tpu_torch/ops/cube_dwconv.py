"""The cube-padded depthwise 7x7 conv at stride 1 with its bias: ConvNeXt's
token mixer (``models/convnext.py``).

``y = conv2d(pad_faces(x, 3), w, groups=C) + b`` on a face batch x [N*6, S,
S, C] (NHWC), with w [C, 7, 7] and b [C]: each face is padded by 3 from its
neighbours (``ops/cube_pad.py``) or, with ``use_cube_pad`` False, with
zeros.  On a CUDA tensor :func:`cube_dwconv` launches the hand-written
kernel in ``csrc/cube_dwconv.cu``, which reads each tap outside the face
through the cube pad's index map (``build_cube_pad_index_map(S, S, 3)``)
and makes no padded copy; on a CPU tensor it runs :func:`plain_cube_dwconv`,
the pad's ``index_select`` and ``F.conv2d(groups=C)``, which is also the
kernel's oracle.  Both sum the 49 products of an output in f32, add the
bias in f32 and round once to the output's dtype: x's, or bf16 from f32
faces (ConvNeXt's residual stream is f32, and the rest of its block bf16);
only the order of the sums differs, so they agree within one ulp of that
dtype.

The cube pad needs faces at least as wide as the pad (S >= 3).  The kernel
holds the [C, 7, 7] kernel in its storage order: a view of [7, 7, C]
memory (channels last, as the backbones hold their kernels) costs no copy.

``launches`` counts the kernel's launches; a replay of a CUDA graph that
holds the kernel adds those its capture recorded (``models/cam.py``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import torch

from cp360_tpu_torch.models import layers
from cp360_tpu_torch.ops import _build
from cp360_tpu_torch.ops.cube_pad import build_cube_pad_index_map

launches = 0

K = 7  # the kernel's size: ConvNeXt's 7x7 at pad 3
_VEC_BYTES = 16  # one thread moves 16 bytes of channels


@lru_cache(maxsize=1)
def _lib():
    lib = _build.load("cube_dwconv")
    ptr = ctypes.c_void_p
    lib.cp360_cube_dwconv.argtypes = [ptr, ctypes.c_int, ptr, ptr, ptr, ptr] + \
        [ctypes.c_int] * 5 + [ptr]
    lib.cp360_cube_dwconv.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=16)
def _map_on(s: int, p: int, device: torch.device) -> torch.Tensor:
    """The cube pad's index map int32 [6, S+2p, S+2p] on ``device``."""
    return torch.from_numpy(build_cube_pad_index_map(s, s, p)).to(device)


def _check(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           use_cube_pad: bool) -> int:
    """The pad of a valid call."""
    if x.ndim != 4 or x.shape[0] % 6 or x.shape[1] != x.shape[2]:
        raise ValueError(f"expected square faces [N*6, S, S, C], got {tuple(x.shape)}")
    c, s = x.shape[3], x.shape[1]
    if w.ndim != 3 or w.shape[0] != c or w.shape[1] != w.shape[2] or w.shape[1] % 2 == 0:
        raise ValueError(f"expected an odd square depthwise kernel [{c}, k, k], got "
                         f"{tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (c,):
        raise ValueError(f"bias of shape {tuple(b.shape)} for {c} channels")
    p = w.shape[1] // 2
    if use_cube_pad and s < p:
        raise ValueError(f"a cube pad of {p} needs faces of at least {p} pixels, got {s}")
    return p


def plain_cube_dwconv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                      use_cube_pad: bool = True,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's plain version: the pad (an ``index_select`` off the
    cube pad's map, or zeros), one f32 ``F.conv2d`` with ``groups = C``
    (TF32 off), the bias in f32, one rounding to ``out_dtype`` (x's dtype
    by default); any k."""
    p = _check(x, w, b, use_cube_pad)
    xp = layers.pad_faces(x, p, use_cube_pad)
    hwio = w.float().permute(1, 2, 0)[:, :, None, :]  # [k, k, 1, C]
    y = layers.conv2d(xp.float(), hwio, groups=x.shape[3])
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype if out_dtype is None else out_dtype)


def cube_dwconv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                use_cube_pad: bool = True,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[N*6, S, S, C] -> [N*6, S, S, C] in ``out_dtype`` (x's dtype by
    default): the depthwise conv with ``w`` [C, k, k] (x's dtype) and ``b``
    [C] (any float dtype, applied in f32) after a pad of k // 2.

    A CPU tensor runs :func:`plain_cube_dwconv`.  A CUDA tensor launches
    the kernel (k = 7; bf16 to bf16, f32 to f32 or f32 to bf16; contiguous
    faces; C * itemsize a multiple of 16 bytes; x 16-byte aligned) into a
    new tensor, or raises.  The kernel has no backward: a CUDA call that
    autograd would record raises too.
    """
    global launches
    p = _check(x, w, b, use_cube_pad)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return plain_cube_dwconv(x, w, b, use_cube_pad, out_dtype)
    if not x.is_cuda:
        raise ValueError(f"cube_dwconv runs on CUDA or CPU tensors, got {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
        raise RuntimeError("the cube_dwconv kernel has no backward: call it with autograd off")
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype or \
            out_dtype not in (x.dtype, torch.bfloat16):
        raise TypeError(f"the cube_dwconv kernel takes bfloat16 or float32 faces and a kernel "
                        f"of their dtype, to their dtype or bfloat16; got {x.dtype} and "
                        f"{w.dtype} to {out_dtype}")
    if w.shape[1] != K:
        raise ValueError(f"the cube_dwconv kernel computes a {K}x{K} conv, got "
                         f"{w.shape[1]}x{w.shape[2]}")
    c = x.shape[3]
    if not x.is_contiguous() or (c * x.element_size()) % _VEC_BYTES \
            or x.data_ptr() % _VEC_BYTES:
        raise ValueError(f"the cube_dwconv kernel needs contiguous faces, C * itemsize a "
                         f"multiple of {_VEC_BYTES} and a {_VEC_BYTES}-byte aligned tensor "
                         f"(C={c}, {x.dtype})")
    taps = w.permute(1, 2, 0).contiguous()  # [k, k, C]: no copy for channels-last storage
    if taps.data_ptr() % _VEC_BYTES:
        raise ValueError(f"the cube_dwconv kernel needs a {_VEC_BYTES}-byte aligned kernel")
    bias = None if b is None else b.to(device=x.device, dtype=torch.float32).contiguous()
    table = _map_on(x.shape[1], p, x.device) if use_cube_pad else None
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().cp360_cube_dwconv(
            x.data_ptr(), int(x.dtype == torch.bfloat16), taps.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if table is None else table.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), x.shape[0], x.shape[1], c, K,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cube_dwconv kernel launch failed: CUDA error {err}")
    launches += 1
    return out
