"""Fused CubePad(1) + 3x3 VALID conv + bias on small cube feature maps.

The op the ConvLSTM runs 3 times per step on [N, 6, 7, 7, C] CAM cubes
(reference model/clstm.py:57-65).  It replaces the TPU kernel
``cp360_tpu/ops/pallas_kernels.py::_conv_core`` in both of its uses:

- :func:`cube_conv3x3`, the forward (``pallas_kernels.py::cube_conv3x3``):
  on a CUDA tensor it launches the hand-written Hopper kernel in
  ``csrc/cube_conv3x3.cu`` (an implicit GEMM whose A tiles gather the cube
  padding through :func:`source_table`; bf16 runs warp-specialised
  ``wgmma`` with TMA weights; its header states the bound); on a CPU tensor
  it runs :func:`cube_conv3x3_plain`, the counterpart of
  ``cube_conv3x3_reference`` (cube pad, then a VALID conv);
- :func:`cube_conv3x3_dx`, the input gradient (``pallas_kernels.py::_cc_bwd``):
  the same kernel over the 9 taps, with the weights read transposed; per
  tap, the <= 3 dy rows that feed one input pixel (:func:`dx_tap_table`)
  are summed once in f32 before the product (:func:`dx_gather_tables`); on
  a CPU tensor, :func:`cube_conv3x3_dx_plain` (autograd of the plain
  version).

In bf16 the kernel may split its depth into ranges (:func:`depth_splits`,
one count per conv shape, whatever the batch) and sum the f32 partials in a
second pass of the same call, in a fixed order: the result is
bit-identical from run to run and does not depend on the batch.

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
def dx_tap_table(h: int, w: int) -> np.ndarray:
    """The input gradient's gather table: int32 [9, 6hw, 3].

    Tap k's source map (row k of :func:`source_table`) is not injective: an
    input pixel q on a face edge is read by up to 3 output positions p of
    the same tap.  Entry [k, q, j] is the j-th such p (ascending), or -1.
    Then dx[q] = sum_k (sum_j dy[tab[k, q, j]]) W[k]^T: per tap, the <= 3
    rows are summed first, so the products are the forward's 9 taps.
    """
    src = source_table(h, w)
    rows = src.shape[1]
    tab = np.full((9, rows, 3), -1, np.int32)
    for k in range(9):
        order = np.argsort(src[k], kind="stable")  # outputs p grouped by q
        q_sorted = src[k][order]
        rank = np.arange(rows) - np.searchsorted(q_sorted, q_sorted)
        if rank.max() >= 3:
            raise AssertionError(f"tap {k} reads one pixel {rank.max() + 1} times")
        tab[k, q_sorted, rank] = order
    return tab


@lru_cache(maxsize=8)
def dx_gather_tables(h: int, w: int):
    """What the dx kernel reads, from :func:`dx_tap_table`: (tab int32
    [9, 6hw], rows int32 [E, 3]).

    Entry tab[k, q] is -1 where no output reads pixel q through tap k, p
    where exactly one output p does, and -2 - e where two or three do:
    rows[e] lists them (-1 after the last; e counts such pairs in (k, q)
    order, E = 188 at 7x7 faces).  The kernel first sums each cube's rows[e]
    of dy into one row (in f32, rounded once to dy's dtype), so every A row
    then has one source.
    """
    tab3 = dx_tap_table(h, w)
    count = (tab3 >= 0).sum(axis=2)
    tab = np.where(count == 1, tab3[:, :, 0], -1).astype(np.int32)
    multi = count >= 2
    tab[multi] = -2 - np.arange(int(multi.sum()), dtype=np.int32)
    return tab, tab3[multi].astype(np.int32)


# The bf16 kernel's tiles (csrc/cube_conv3x3.cu): BM rows x BN columns, BK
# channels of depth a step, 9 * ceil(K / BK) steps in all.
BM, BN, BK = 128, 256, 64
# The split rule's cost model, from the card's peaks (H100: 989 TFLOP/s
# bf16 on 132 SMs, 3.35 TB/s): one 128x256x64 step of one block takes
# about 0.7 us (0.56 us at the peak); the second pass moves 8 bytes per
# partial element (written, read) and 2 per output at about 2.5 TB/s, and
# costs a launch of about 4 us.
_STEP_US = 0.7
_REDUCE_BYTES_PER_US = 2.5e6
_REDUCE_LAUNCH_US = 4.0
MAX_SPLITS = 9


# Batch sizes, in cubes, at which the rule weighs each split count: one
# window (training at batch 1, a lone request), a serving bucket and a
# training batch of 8, and the evaluation's 64 windows per batch.
REFERENCE_CUBES = (1, 8, 64)


def _split_us(m: int, n: int, k: int, sms: int, s: int) -> float:
    """Estimated time of one bf16 launch at M = m with s depth splits.  The
    grid is persistent (one block per SM), so a block runs ceil(units /
    sms) units of ceil(steps / s) steps each."""
    tiles = -(-m // BM) * -(-n // BN)
    steps = 9 * -(-k // BK)
    us = -(-tiles * s // sms) * -(-steps // s) * _STEP_US
    if s > 1:
        us += _REDUCE_LAUNCH_US + m * n * (8 * s + 2) / _REDUCE_BYTES_PER_US
    return us


@lru_cache(maxsize=64)
def depth_splits(p: int, n: int, k: int, sms: int) -> int:
    """How many ranges the bf16 kernel splits its depth into, for cubes of
    p = 6hw positions, N = n output channels and K = k channels a tap, on a
    card with ``sms`` SMs.

    The count does not depend on the batch: a split changes the order in
    which each output's f32 sum is taken, so one count per conv shape keeps
    every output independent of what else is in the batch (a served window
    equals the same window computed alone, bit for bit).  It is the count in
    1..9 whose estimated time, over the best count's at each of the
    reference batches (:data:`REFERENCE_CUBES`), sums lowest: more splits
    fill the card at small batches and cost the f32 partials' second pass
    at large ones.
    """
    best, best_cost = 1, None
    for s in range(1, MAX_SPLITS + 1):
        cost = 0.0
        for cubes in REFERENCE_CUBES:
            m = cubes * p
            t = [_split_us(m, n, k, sms, c) for c in range(1, MAX_SPLITS + 1)]
            cost += t[s - 1] / min(t)
        if best_cost is None or cost < best_cost - 1e-9:
            best, best_cost = s, cost
    return best


def work_units(m: int, n: int, k: int, splits: int):
    """The bf16 kernel's work units in launch order, as the kernel derives
    them (``unit_of``): (m0, n0, first step, end step) for u = 0, 1, ...;
    M tiles fastest, then N tiles, then depth ranges.  A step is
    tap * ceil(k / BK) + channel chunk."""
    tiles_m, tiles_n = -(-m // BM), -(-n // BN)
    steps = 9 * -(-k // BK)
    tiles = tiles_m * tiles_n
    units = []
    for u in range(tiles * splits):
        tile, split = u % tiles, u // tiles
        units.append(((tile % tiles_m) * BM, (tile // tiles_m) * BN,
                      split * steps // splits, (split + 1) * steps // splits))
    return units


@lru_cache(maxsize=8)
def _table_on(h: int, w: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(source_table(h, w)).to(device)


@lru_cache(maxsize=8)
def _dx_tables_on(h: int, w: int, device: torch.device):
    tab, rows = dx_gather_tables(h, w)
    return torch.from_numpy(tab).to(device), torch.from_numpy(rows).to(device)


@lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    for fn in (lib.cp360_cube_conv3x3, lib.cp360_cube_conv3x3_dx):
        n_ptrs, n_ints = (6, 7) if fn is lib.cp360_cube_conv3x3 else (7, 8)
        fn.argtypes = [ptr] * n_ptrs + [cint] * n_ints + [ptr]
        fn.restype = cint
    return lib


def _splits_and_workspace(is_bf16: bool, m: int, p: int, n: int, k: int,
                          device: torch.device, splits: Optional[int]):
    """(depth splits, f32 workspace pointer) for one launch: the rule's
    count unless ``splits`` is given; the f32 kernel never splits."""
    if not is_bf16:
        return 1, None
    if m * k >= 2**31:  # the bf16 kernel's row offsets are 32-bit
        raise ValueError(f"the bf16 kernel takes fewer than 2**31 input elements, got {m * k}")
    if splits is None:
        splits = depth_splits(p, n, k, _sm_count(device))
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits must be in 1..{MAX_SPLITS}, got {splits}")
    if splits == 1:
        return 1, None
    return splits, torch.empty((splits, m, n), dtype=torch.float32, device=device)


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
    _check(x, w, b)
    if x.device.type == "cpu":
        return cube_conv3x3_plain(x, w, b)
    if not x.is_cuda:
        raise ValueError(f"cube_conv3x3 runs on CUDA or CPU tensors, got {x.device}")
    return _forward(x, w, b)


def _forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             splits: Optional[int] = None) -> torch.Tensor:
    """The forward kernel's launch (``splits`` overrides :func:`depth_splits`)."""
    global launches
    n, _, h, ww, cin = x.shape
    cout = w.shape[3]
    is_bf16 = _check_kernel_operands("cube_conv3x3", (x, w, b), cin, cout)
    out = torch.empty((n, 6, h, ww, cout), dtype=x.dtype, device=x.device)
    if is_bf16 and any(t.data_ptr() % 16 for t in (x, w, out)):
        raise ValueError("the bf16 kernel needs 16-byte aligned x, w and out")
    if n == 0:
        return out
    m = n * 6 * h * ww
    splits, ws = _splits_and_workspace(is_bf16, m, 6 * h * ww, cout, cin, x.device, splits)
    tab = _table_on(h, ww, x.device)
    with torch.cuda.device(x.device):
        err = _lib().cp360_cube_conv3x3(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), tab.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), m, 6 * h * ww, cin, cout, splits,
            _sm_count(x.device), int(is_bf16), torch.cuda.current_stream(x.device).cuda_stream)
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
    return _dx(dy, w)


def _dx(dy: torch.Tensor, w: torch.Tensor, splits: Optional[int] = None) -> torch.Tensor:
    """The dx kernel's launch (``splits`` overrides :func:`depth_splits`)."""
    global dx_launches
    n, _, h, ww, cout = dy.shape
    cin = w.shape[2]
    is_bf16 = _check_kernel_operands("cube_conv3x3_dx", (dy, w), cin, cout)
    dx = torch.empty((n, 6, h, ww, cin), dtype=dy.dtype, device=dy.device)
    if is_bf16 and any(t.data_ptr() % 16 for t in (dy, w, dx)):
        raise ValueError("the bf16 kernel needs 16-byte aligned dy, w and dx")
    if n == 0:
        return dx
    m = n * 6 * h * ww
    splits, ws = _splits_and_workspace(is_bf16, m, 6 * h * ww, cin, cout, dy.device,
                                       splits)
    tab, rows = _dx_tables_on(h, ww, dy.device)
    sums = torch.empty((n * rows.shape[0], cout), dtype=dy.dtype, device=dy.device)
    with torch.cuda.device(dy.device):
        err = _lib().cp360_cube_conv3x3_dx(
            dy.data_ptr(), w.data_ptr(), tab.data_ptr(), rows.data_ptr(), sums.data_ptr(),
            dx.data_ptr(), None if ws is None else ws.data_ptr(), m, 6 * h * ww, rows.shape[0],
            cin, cout, splits, _sm_count(dy.device), int(is_bf16),
            torch.cuda.current_stream(dy.device).cuda_stream)
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
