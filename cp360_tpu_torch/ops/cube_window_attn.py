"""Window attention on cube faces: Swin's token mixer (``models/swin.py``).

Each head attends within M x M windows of a face batch's tokens:

    out_i = sum_j softmax_j(q_i . k_j / sqrt(d) + B[h, rel(i, j)] (+ mask)) v_j

with q, k and v the three C-wide parts of ``qkv`` [N*6, S, S, 3C] (the qkv
GEMM's output, NHWC) plus ``qkv_bias``, d = 32 the head size, and B the
block's relative-position table [(2M-1)^2, heads] at ``rel(i, j) = (r_i -
r_j + M - 1)(2M - 1) + (c_i - c_j + M - 1)`` of the two tokens' rows and
columns in the window.

A window's M^2 slots are described by two tables built once per shape
(:func:`window_maps`): the source of each slot, a flat index into one
cube's 6 * S * S tokens, and whether the slot is a token of the window's
own face, which alone gets an output.

- Regular layers (``shift`` False): the M x M tiles of each face, as the
  published code partitions an image.
- Shifted layers, cube-padded: the M x M tiles of each face's token grid
  cube-padded by M - M//2 before and M//2 after on each axis
  (``ops/cube_pad.py::build_cube_pad_index_map(S, S, (4, 3, 4, 3))`` at M =
  7, its corner rule included).  Its window boundaries are the published
  shifted ones; the windows at a face's edges take their out-of-face slots
  from the neighbouring faces, where the published code wraps the image
  round and masks the wrapped slots.  A face has (S/M + 1)^2 such windows.
- Shifted layers with ``use_cube_pad`` False: the published roll by -M//2
  and its mask (-100 between slots of different regions) on each face.

On a CUDA tensor :func:`cube_window_attn` launches the hand-written kernel
in ``csrc/cube_window_attn.cu`` (bf16 only), which reads q, k and v
through the slots' sources and writes the own-face outputs; on a CPU
tensor it runs :func:`plain_window_attn`, the gather, the matmuls and
the softmax in PyTorch ops, which is also the kernel's oracle.  Both add
the qkv bias in f32 and round q, k and v once to qkv's dtype, take the
scores and the softmax in f32, round the softmax's numerators to qkv's
dtype for the product with v (the kernel's tensor-core operands), sum in
f32, divide by the f32 sum of the numerators and round once to the output.
In f32 every rounding but the last is the identity.

``launches`` counts the kernel's launches and ``windows`` the windows they
served (faces times windows a face); a replay of a CUDA graph that holds
the kernel adds those its capture recorded (``models/cam.py``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from cp360_tpu_torch.ops import _build
from cp360_tpu_torch.ops.cube_pad import build_cube_pad_index_map

launches = 0
windows = 0

HEAD_DIM = 32  # every published Swin's head size, and the kernel's
MAX_SLOTS = 64  # the kernel pads a window's slots to four 16-row tiles
MASK = -100.0  # the published mask's value between slots of different regions
_VEC_BYTES = 16


@lru_cache(maxsize=1)
def _lib():
    lib = _build.load("cube_window_attn")
    ptr = ctypes.c_void_p
    lib.cp360_cube_window_attn.argtypes = [ptr] * 6 + [ctypes.c_int] * 7 + [ptr]
    lib.cp360_cube_window_attn.restype = ctypes.c_int
    return lib


def windows_per_face(s: int, m: int, shift: bool, use_cube_pad: bool = True) -> int:
    """Windows of one layer on a face of s x s tokens."""
    return ((s + m) // m) ** 2 if shift and use_cube_pad else (s // m) ** 2


@lru_cache(maxsize=32)
def window_maps(s: int, m: int, shift: bool, use_cube_pad: bool = True
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(src int32 [6 * nw, M * M], meta uint8 [6 * nw, M * M]) of S x S
    faces, the windows of a cube face by face, each window's slots row by
    row: ``src`` the flat index of a slot's token in the cube's [6 * S * S]
    tokens, ``meta`` bit 0 set for a slot of the window's own face (it gets
    the output) and bits 1-4 the slot's region of the published mask (0
    everywhere but a rolled layer)."""
    if s % m:
        raise ValueError(f"{m}x{m} windows do not tile a {s}x{s} token grid")
    r = np.arange(m)
    if shift and use_cube_pad:
        before, after = m - m // 2, m // 2  # the pad on each axis
        padded = build_cube_pad_index_map(s, s, (before, after, before, after))
        n = (s + m) // m
        rows = (np.arange(n)[:, None] * m + r)  # [n, M] padded coordinates
        src = padded[:, rows[:, None, :, None], rows[None, :, None, :]]  # [6, n, n, M, M]
        inside = (rows >= before) & (rows < before + s)
        own = inside[:, None, :, None] & inside[None, :, None, :]
        meta = np.broadcast_to(own, src.shape).astype(np.uint8)
    else:
        n = s // m
        rows = np.arange(n)[:, None] * m + r  # [n, M] coordinates in the (rolled) face
        region = np.zeros(s, np.int64)  # of each rolled coordinate
        if shift:  # the published mask's slices (0, -M), (-M, -M//2), (-M//2, None)
            region[s - m:] = 1
            region[s - m // 2:] = 2
        label = region[rows][:, None, :, None] * 3 + region[rows][None, :, None, :]
        if shift:  # the published roll by -M//2: rolled a holds (a + M//2) mod S
            rows = (rows + m // 2) % s
        faces = (np.arange(6) * s * s)[:, None, None, None, None]
        src = faces + rows[:, None, :, None] * s + rows[None, :, None, :]
        meta = np.broadcast_to(1 + 2 * label, src.shape).astype(np.uint8)
    return (np.ascontiguousarray(src.reshape(-1, m * m), dtype=np.int32),
            np.ascontiguousarray(meta.reshape(-1, m * m)))


@lru_cache(maxsize=8)
def rel_index(m: int) -> np.ndarray:
    """int64 [M * M, M * M]: each pair's row of the relative-position table
    (the published ``relative_position_index``)."""
    r, c = np.divmod(np.arange(m * m), m)
    return (r[:, None] - r[None, :] + m - 1) * (2 * m - 1) + (c[:, None] - c[None, :] + m - 1)


def _check(qkv: torch.Tensor, qkv_bias: Optional[torch.Tensor], table: torch.Tensor,
           heads: int, m: int) -> Tuple[int, int]:
    """(S, C) of a valid call."""
    if qkv.ndim != 4 or qkv.shape[0] % 6 or qkv.shape[1] != qkv.shape[2] \
            or qkv.shape[3] % 3:
        raise ValueError(f"expected square faces [N*6, S, S, 3C], got {tuple(qkv.shape)}")
    s, c = qkv.shape[1], qkv.shape[3] // 3
    if heads < 1 or c % heads:
        raise ValueError(f"{heads} heads for {c} channels")
    if qkv_bias is not None and tuple(qkv_bias.shape) != (3 * c,):
        raise ValueError(f"qkv bias of shape {tuple(qkv_bias.shape)} for {3 * c} channels")
    if tuple(table.shape) != ((2 * m - 1) ** 2, heads):
        raise ValueError(f"relative-position table of shape {tuple(table.shape)}, expected "
                         f"{((2 * m - 1) ** 2, heads)}")
    return s, c


def plain_window_attn(qkv: torch.Tensor, qkv_bias: Optional[torch.Tensor],
                      table: torch.Tensor, heads: int, window: int, shift: bool,
                      use_cube_pad: bool = True) -> torch.Tensor:
    """The kernel's plain version in PyTorch ops (any head size): the
    slots' gather, the scores, the bias and mask, the softmax and the
    product with v, each in f32, with the kernel's roundings."""
    s, c = _check(qkv, qkv_bias, table, heads, window)
    n, m2, d = qkv.shape[0] // 6, window * window, c // heads
    src, meta = window_maps(s, window, shift, use_cube_pad)
    dev = qkv.device
    t = qkv.float() if qkv_bias is None else qkv.float() + qkv_bias.float()
    t = t.to(qkv.dtype).float().reshape(n, 6 * s * s, 3 * c)
    idx = torch.from_numpy(src.reshape(-1).astype(np.int64)).to(dev)
    win = t[:, idx].reshape(n, -1, m2, 3, heads, d).permute(3, 0, 1, 4, 2, 5)
    q, k, v = win[0], win[1], win[2]  # [n, windows, heads, M^2, d]
    bias = table.float()[torch.from_numpy(rel_index(window)).to(dev)].permute(2, 0, 1)
    scores = torch.matmul(q, k.transpose(-1, -2)) * d ** -0.5 + bias
    label = torch.from_numpy(meta >> 1).to(dev)
    scores = scores + torch.where(label[:, :, None] != label[:, None, :], MASK, 0.0)[:, None]
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    o = torch.matmul(p.to(qkv.dtype).float(), v) / p.sum(dim=-1, keepdim=True)
    o = o.permute(0, 1, 3, 2, 4).reshape(n, -1, c)
    own = torch.from_numpy(meta.reshape(-1) & 1).to(dev).bool()
    out = torch.empty((n, 6 * s * s, c), dtype=torch.float32, device=dev)
    out[:, idx[own]] = o[:, own]
    return out.reshape(qkv.shape[0], s, s, c).to(qkv.dtype)


@lru_cache(maxsize=32)
def _maps_on(s: int, m: int, shift: bool, use_cube_pad: bool, device: torch.device):
    src, meta = window_maps(s, m, shift, use_cube_pad)
    return torch.from_numpy(src).to(device), torch.from_numpy(meta).to(device)


def cube_window_attn(qkv: torch.Tensor, qkv_bias: Optional[torch.Tensor], table: torch.Tensor,
                     heads: int, window: int, shift: bool, use_cube_pad: bool = True
                     ) -> torch.Tensor:
    """[N*6, S, S, 3C] -> [N*6, S, S, C] in qkv's dtype: window attention
    of ``heads`` heads in ``window`` x ``window`` windows, regular or
    shifted, with ``qkv_bias`` [3C] and ``table`` [(2M-1)^2, heads] (any
    float dtype, applied in f32).

    A CPU tensor runs :func:`plain_window_attn`.  A CUDA tensor launches
    the kernel (bf16 qkv to bf16; head size 32; windows of at most 64
    slots; contiguous, 16-byte aligned faces) into a new tensor, or
    raises.  The kernel has no backward: a CUDA call that autograd would
    record raises too.
    """
    global launches, windows
    s, c = _check(qkv, qkv_bias, table, heads, window)
    if qkv.device.type == "cpu":
        return plain_window_attn(qkv, qkv_bias, table, heads, window, shift, use_cube_pad)
    if not qkv.is_cuda:
        raise ValueError(f"cube_window_attn runs on CUDA or CPU tensors, got {qkv.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (qkv, qkv_bias, table)):
        raise RuntimeError("the cube_window_attn kernel has no backward: call it with "
                           "autograd off")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the cube_window_attn kernel takes bfloat16 qkv, got {qkv.dtype}")
    if c != heads * HEAD_DIM or window * window > MAX_SLOTS:
        raise ValueError(f"the cube_window_attn kernel takes heads of {HEAD_DIM} and windows "
                         f"of at most {MAX_SLOTS} slots, got {c // heads} and "
                         f"{window}x{window}")
    if not qkv.is_contiguous() or qkv.data_ptr() % _VEC_BYTES:
        raise ValueError(f"the cube_window_attn kernel needs contiguous, {_VEC_BYTES}-byte "
                         f"aligned faces")
    src, meta = _maps_on(s, window, shift, use_cube_pad, qkv.device)
    bias = None if qkv_bias is None else \
        qkv_bias.to(device=qkv.device, dtype=torch.float32).contiguous()
    tab = table.to(device=qkv.device, dtype=torch.float32).contiguous()
    out = torch.empty((qkv.shape[0], s, s, c), dtype=qkv.dtype, device=qkv.device)
    nw = src.shape[0] // 6
    with torch.cuda.device(qkv.device):
        err = _lib().cp360_cube_window_attn(
            qkv.data_ptr(), None if bias is None else bias.data_ptr(), tab.data_ptr(),
            src.data_ptr(), meta.data_ptr(), out.data_ptr(), qkv.shape[0] // 6, s, c, heads,
            nw, window, int(shift and not use_cube_pad),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cube_window_attn kernel launch failed: CUDA error {err}")
    launches += 1
    windows += qkv.shape[0] * nw
    return out
