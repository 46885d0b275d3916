"""Fused CubePad(1) + 3x3 VALID conv + bias on small cube feature maps.

The op the ConvLSTM runs 3 times per step on [N, 6, 7, 7, C] CAM cubes
(reference model/clstm.py:57-65).  It replaces the TPU kernel
``cp360_tpu/ops/pallas_kernels.py::_conv_core`` in both of its uses:

- :func:`cube_conv3x3`, the forward (``pallas_kernels.py::cube_conv3x3``):
  on a CUDA tensor it launches the hand-written Hopper kernel in
  ``csrc/cube_conv3x3.cu`` (an implicit GEMM whose A tiles gather the cube
  padding through :func:`source_table`; its header states the bound); on a
  CPU tensor it runs :func:`cube_conv3x3_plain`, the counterpart of
  ``cube_conv3x3_reference`` (cube pad, then a VALID conv);
- :func:`cube_conv3x3_dx`, the input gradient (``pallas_kernels.py::_cc_bwd``):
  the same kernel source, with the inverse source map split into injective
  slots (:func:`dx_slot_table`) and the weights read transposed; on a CPU
  tensor, :func:`cube_conv3x3_dx_plain` (autograd of the plain version).

:func:`cube_conv3x3_train` is the differentiable form
(``pallas_kernels.py::cube_conv3x3_train``): forward and input gradient are
the kernels, the weight and bias gradients are torch products with the tap
selection folded into ``dy``, as ``_cc_bwd`` computes them with XLA einsums.

``launches`` and ``dx_launches`` count the two kernels' launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from cp360_tpu_torch.models import layers
from cp360_tpu_torch.ops import _build
from cp360_tpu_torch.ops.cube_pad import build_cube_pad_index_map, cube_pad

launches = 0
dx_launches = 0


@lru_cache(maxsize=8)
def source_table(h: int, w: int) -> np.ndarray:
    """int32 [9, 6hw]: entry [k, p] is the face pixel (flat over the cube)
    that tap k = 3*dy + dx of output position p reads through cube padding."""
    pad_map = build_cube_pad_index_map(h, w, (1, 1, 1, 1))  # [6, h+2, w+2]
    rows = 6 * h * w
    return np.stack([pad_map[:, dy:dy + h, dx:dx + w].reshape(rows)
                     for dy in range(3) for dx in range(3)]).astype(np.int32)


@lru_cache(maxsize=8)
def dx_slot_table(h: int, w: int):
    """The input gradient's gather tables: (tab int32 [S, 6hw], slot_tap
    int32 [S]).

    Tap k's source map (row k of :func:`source_table`) is not injective: an
    input pixel q on a face edge is read by up to 3 output positions p of
    the same tap.  Its inverse is split into layers: layer j of tap k holds,
    for each q, the j-th p (in ascending order) with src_k(p) = q, or -1.
    Then dx[q] = sum_s dy[tab[s, q]] W[slot_tap[s]]^T over the S slots (23
    at 7x7 faces: multiplicity 1 for the centre tap, 2 for taps 3 and 5, 3
    for the other six).
    """
    src = source_table(h, w)
    rows = src.shape[1]
    tabs, taps = [], []
    for k in range(9):
        order = np.argsort(src[k], kind="stable")  # outputs p grouped by q
        q_sorted = src[k][order]
        rank = np.arange(rows) - np.searchsorted(q_sorted, q_sorted)
        for j in range(int(rank.max()) + 1):
            t = np.full(rows, -1, np.int32)
            layer = rank == j
            t[q_sorted[layer]] = order[layer]
            tabs.append(t)
            taps.append(k)
    return np.stack(tabs), np.asarray(taps, np.int32)


@lru_cache(maxsize=8)
def _table_on(h: int, w: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(source_table(h, w)).to(device)


@lru_cache(maxsize=8)
def _dx_tables_on(h: int, w: int, device: torch.device):
    tab, slot_tap = dx_slot_table(h, w)
    return torch.from_numpy(tab).to(device), torch.from_numpy(slot_tap).to(device)


@lru_cache(maxsize=8)
def _selection_on(h: int, w: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """[9, 6hw, 6hw] 0/1 selection matrices A_k[p, q] = [src_k(p) == q]."""
    src = torch.from_numpy(source_table(h, w)).long()
    rows = src.shape[1]
    sel = torch.zeros(9, rows, rows, dtype=dtype)
    sel.scatter_(2, src[:, :, None], 1.0)
    return sel.to(device)


@lru_cache(maxsize=1)
def _lib():
    lib = _build.load("cube_conv3x3")
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.cp360_cube_conv3x3.argtypes = [ptr, ptr, ptr, ptr, ptr, cint, cint, cint, cint,
                                       cint, ptr]
    lib.cp360_cube_conv3x3.restype = cint
    lib.cp360_cube_conv3x3_dx.argtypes = [ptr, ptr, ptr, ptr, ptr, cint, cint, cint, cint,
                                          cint, cint, ptr]
    lib.cp360_cube_conv3x3_dx.restype = cint
    return lib


def cube_conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cube pad, then a VALID conv with bias: [N, 6, h, h, Cin] ->
    [N, 6, h, h, Cout] in x.dtype (the kernel's plain version)."""
    n, _, h, ww, cin = x.shape
    xp = cube_pad(x, 1).reshape(n * 6, h + 2, ww + 2, cin)
    out = layers.conv2d(xp, w, b)
    return out.reshape(n, 6, h, ww, -1)


def cube_conv3x3_dx_plain(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The input gradient of :func:`cube_conv3x3_plain` by autograd:
    dy [N, 6, h, h, Cout], w [3, 3, Cin, Cout] -> dx [N, 6, h, h, Cin] in
    dy.dtype (the dx kernel's plain version)."""
    n, _, h, ww, _ = dy.shape
    with torch.enable_grad():
        x = torch.zeros((n, 6, h, ww, w.shape[2]), dtype=dy.dtype, device=dy.device,
                        requires_grad=True)
        out = cube_conv3x3_plain(x, w.detach(), torch.zeros_like(dy[0, 0, 0, 0]))
        (dx,) = torch.autograd.grad(out, x, dy)
    return dx


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


def _check_kernel_operands(name: str, tensors, c_in: int, c_out: int) -> bool:
    """The kernels' demands on CUDA operands; returns whether they are bf16."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= {torch.bfloat16, torch.float32}:
        raise TypeError(f"{name} takes bf16 or f32 operands of one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous operands")
    is_bf16 = tensors[0].dtype == torch.bfloat16
    if is_bf16 and (c_in % 8 or c_out % 8):
        raise ValueError(f"the bf16 kernel needs Cin and Cout divisible by 8, got {c_in}, {c_out}")
    return is_bf16


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
    n, _, h, ww, cin = x.shape
    cout = w.shape[3]
    is_bf16 = _check_kernel_operands("cube_conv3x3", (x, w, b), cin, cout)
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


def cube_conv3x3_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of :func:`cube_conv3x3`.

    Args:
      dy: [N, 6, h, h, Cout] output gradient (bf16 or f32).
      w: [3, 3, Cin, Cout] HWIO kernel, dy's dtype (read transposed in place).

    Returns dx [N, 6, h, h, Cin] in dy.dtype, accumulated in f32.  A CUDA
    tensor launches the dx kernel (contiguous operands; bf16 needs Cin and
    Cout divisible by 8); a CPU tensor runs :func:`cube_conv3x3_dx_plain`.
    """
    global dx_launches
    if dy.ndim != 5 or dy.shape[1] != 6 or dy.shape[2] != dy.shape[3]:
        raise ValueError(f"dy must be [N, 6, h, h, Cout], got {tuple(dy.shape)}")
    if w.ndim != 4 or w.shape[:2] != (3, 3) or w.shape[3] != dy.shape[4]:
        raise ValueError(f"w must be [3, 3, Cin, {dy.shape[4]}], got {tuple(w.shape)}")
    if dy.device != w.device:
        raise ValueError(f"dy and w on different devices: {dy.device}, {w.device}")
    if dy.device.type == "cpu":
        return cube_conv3x3_dx_plain(dy, w)
    if not dy.is_cuda:
        raise ValueError(f"cube_conv3x3_dx runs on CUDA or CPU tensors, got {dy.device}")
    n, _, h, ww, cout = dy.shape
    cin = w.shape[2]
    is_bf16 = _check_kernel_operands("cube_conv3x3_dx", (dy, w), cin, cout)
    dx = torch.empty((n, 6, h, ww, cin), dtype=dy.dtype, device=dy.device)
    if is_bf16 and any(t.data_ptr() % 16 for t in (dy, w, dx)):
        raise ValueError("the bf16 kernel needs 16-byte aligned dy, w and dx")
    if n == 0:
        return dx
    tab, slot_tap = _dx_tables_on(h, ww, dy.device)
    with torch.cuda.device(dy.device):
        err = _lib().cp360_cube_conv3x3_dx(
            dy.data_ptr(), w.data_ptr(), tab.data_ptr(), slot_tap.data_ptr(),
            dx.data_ptr(), n * 6 * h * ww, 6 * h * ww, tab.shape[0], cin, cout,
            int(is_bf16), torch.cuda.current_stream(dy.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cube_conv3x3_dx kernel launch failed: CUDA error {err}")
    dx_launches += 1
    return dx


def cube_conv3x3_wgrad(x: torch.Tensor, dy: torch.Tensor):
    """Weight and bias gradients of :func:`cube_conv3x3` in x's dtype:
    dw [3, 3, Cin, Cout], db [Cout].

    dw[k] = sum_{n,p} x[n, src_k(p)]^T dy[n, p].  As ``_cc_bwd`` does, the
    selection is folded into dy (dy_k = A_k^T dy, one [N, P, Cout]
    temporary per tap) so the 9x tap-expanded activations never exist;
    each product accumulates in f32 (or wider) and rounds once to x's dtype.
    """
    n, _, h, ww, cin = x.shape
    cout = dy.shape[-1]
    rows = 6 * h * ww
    sel = _selection_on(h, ww, x.device, x.dtype)
    x2t = x.reshape(n * rows, cin).t()
    dy3 = dy.reshape(n, rows, cout)
    dw = torch.stack([x2t @ torch.matmul(sel[k].t(), dy3).reshape(n * rows, cout)
                      for k in range(9)])
    db = dy3.sum(dim=(0, 1), dtype=torch.promote_types(dy.dtype, torch.float32)).to(x.dtype)
    return dw.reshape(3, 3, cin, cout), db


class _CubeConv3x3Train(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, wc, bc):
        ctx.save_for_backward(x, wc)
        ctx.param_dtypes = (w.dtype, b.dtype)
        return cube_conv3x3(x, wc, bc)

    @staticmethod
    def backward(ctx, dy):
        x, wc = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = cube_conv3x3_dx(dy, wc)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            # rounded to the compute dtype first, then widened to the
            # parameters' dtype, as the JAX cast's VJP does (:285-286)
            dw, db = cube_conv3x3_wgrad(x, dy)
            dw, db = dw.to(ctx.param_dtypes[0]), db.to(ctx.param_dtypes[1])
        return dx, dw, db, None, None


def cube_conv3x3_train(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       wc: Optional[torch.Tensor] = None,
                       bc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable :func:`cube_conv3x3`.

    Args:
      x: [N, 6, h, h, Cin] in the compute dtype, contiguous.
      w, b: the parameters (e.g. f32 master weights); they receive the
        gradients, in their own dtype.
      wc, bc: w and b in x's dtype, cast once per training step by the
        caller (default: w and b themselves).

    Forward is the K1 kernel, the input gradient the dx kernel (run only
    when x needs a gradient); dw and db come from :func:`cube_conv3x3_wgrad`.
    """
    wc = w if wc is None else wc
    bc = b if bc is None else bc
    return _CubeConv3x3Train.apply(x, w, b, wc, bc)
