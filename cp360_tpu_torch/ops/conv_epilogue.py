"""The epilogue of every backbone conv: the inference batch norm after it,
its bias, the block's residual and the activation in one pass,

    y = act(((x + conv_bias) * scale + shift) + residual)

over the conv's NHWC output x [..., C], with per-channel f32 vectors
``conv_bias``, ``scale`` and ``shift``, each optional (what
``models/layers.py::fold`` leaves of a batch norm and a conv bias once it
has folded what it can into the conv's kernel), and ReLU, ReLU6, GELU
(the exact erf form, ``y * 0.5 * (1 + erf(y / sqrt 2))`` in f32, as
``F.gelu`` computes it) or no activation.  On a CUDA tensor
:func:`conv_epilogue` launches the hand-written kernel in
``csrc/conv_epilogue.cu`` and writes over ``x`` (or into ``out``); a CPU
tensor runs :func:`plain_epilogue`, the same f32 operations in the same
order as PyTorch ops, into a new tensor.  Both round once to ``x``'s dtype
(to f32 where a bf16 ``x`` takes an f32 residual: ConvNeXt's residual
stream, ``models/convnext.py``), so they agree bit for bit, and in f32 both are the explicit conv -> batch
norm -> residual -> activation chain operation for operation.  GELU is the
one exception to bit for bit: the kernel's ``erff`` (within 2 ulp) and the
CPU's ``erf`` may differ in the last bits of an f32, so there the two agree
within one bf16 ulp, or a few f32 ulps.  Where autograd records a CUDA
call, the kernel writes a new tensor and the backward differentiates the
plain version (:class:`_Epilogue`).

``launches`` counts the kernel's launches; a replay of a CUDA graph that
holds the kernel adds those its capture recorded (``models/cam.py``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import torch

from cp360_tpu_torch.ops import _build

launches = 0

ACTS = {None: 0, "relu": 1, "relu6": 2, "gelu": 3}
SQRT_HALF = 0.7071067811865476  # 1 / sqrt 2, rounded to f32 where it multiplies
_VEC_BYTES = 16  # one thread's vector of channels


@lru_cache(maxsize=1)
def _lib():
    lib = _build.load("conv_epilogue")
    ptr = ctypes.c_void_p
    lib.cp360_conv_epilogue.argtypes = [ptr, ctypes.c_int, ptr, ptr, ptr, ptr, ptr,
                                        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ptr]
    lib.cp360_conv_epilogue.restype = ctypes.c_int
    lib.cp360_conv_epilogue_f32_residual.argtypes = [ptr] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ptr]
    lib.cp360_conv_epilogue_f32_residual.restype = ctypes.c_int
    return lib


def _result_dtype(x: torch.Tensor, residual: Optional[torch.Tensor]) -> torch.dtype:
    """x's dtype, or the residual's where that is wider (an f32 residual to
    a bf16 x)."""
    return x.dtype if residual is None else torch.promote_types(x.dtype, residual.dtype)


def plain_epilogue(x: torch.Tensor, shift: Optional[torch.Tensor] = None,
                   scale: Optional[torch.Tensor] = None,
                   conv_bias: Optional[torch.Tensor] = None,
                   residual: Optional[torch.Tensor] = None,
                   act: Optional[str] = None) -> torch.Tensor:
    """The kernel's plain version: each step one f32 op in the kernel's
    order, the activation, one cast to ``x``'s dtype (the residual's where
    that is wider); a new tensor."""
    y = x.float()
    if conv_bias is not None:
        y = y + conv_bias.float()
    if scale is not None:
        y = y * scale.float()
    if shift is not None:
        y = y + shift.float()
    if residual is not None:
        y = y + residual.float()
    if act == "relu":
        y = torch.relu(y)
    elif act == "relu6":
        y = torch.clamp(y, 0.0, 6.0)
    elif act == "gelu":
        y = y * 0.5 * (1.0 + torch.erf(y * SQRT_HALF))
    return y.to(_result_dtype(x, residual))


def conv_epilogue(x: torch.Tensor, shift: Optional[torch.Tensor] = None,
                  scale: Optional[torch.Tensor] = None,
                  conv_bias: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None, act: Optional[str] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act(((x + conv_bias) * scale + shift) + residual)`` over x [..., C];
    ``shift``, ``scale``, ``conv_bias`` [C] or None (skipped), applied in
    f32; residual x's shape and dtype, or f32 to a bf16 x (the result is
    then f32); act None, "relu", "relu6" or "gelu".

    A CPU tensor returns :func:`plain_epilogue`'s new tensor (copied into
    ``out`` if given).  A CUDA tensor launches the kernel (bf16 or f32, C *
    itemsize a multiple of 16 bytes, x, the residual and ``out`` 16-byte
    aligned) and returns ``out``, or ``x`` written over when ``out`` is
    None: pass a tensor nothing else holds.  With an f32 residual to a bf16
    x, ``out`` (f32; it may be the residual) or a new tensor takes the
    result.  Where autograd records (grad
    mode on and an argument that requires grad) the kernel writes a new
    tensor instead, copied into ``out`` if given, and the backward is the
    plain version's.
    """
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r} (one of {sorted(ACTS, key=str)})")
    c = x.shape[-1]
    for name, v in (("shift", shift), ("scale", scale), ("conv_bias", conv_bias)):
        if v is not None and tuple(v.shape) != (c,):
            raise ValueError(f"{name} of shape {tuple(v.shape)} for {c} channels")
    if residual is not None and (residual.shape != x.shape or (
            residual.dtype != x.dtype and (x.dtype, residual.dtype) !=
            (torch.bfloat16, torch.float32))):
        raise ValueError(f"residual {tuple(residual.shape)} {residual.dtype} does not match "
                         f"x {tuple(x.shape)} {x.dtype}")
    args = (x, shift, scale, conv_bias, residual)
    if x.device.type == "cpu":
        y = plain_epilogue(*args, act)
    elif not x.is_cuda:
        raise ValueError(f"conv_epilogue runs on CUDA or CPU tensors, got {x.device}")
    elif torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        y = _Epilogue.apply(*args, act)
    else:
        return _launch(*args, act, out)
    return y if out is None else out.copy_(y)


class _Epilogue(torch.autograd.Function):
    """The kernel into a new tensor; the backward recomputes the plain
    version from the saved inputs and differentiates it."""

    @staticmethod
    def forward(ctx, x, shift, scale, conv_bias, residual, act):
        ctx.act = act
        ctx.save_for_backward(x, shift, scale, conv_bias, residual)
        return _launch(x, shift, scale, conv_bias, residual, act,
                       torch.empty(x.shape, dtype=_result_dtype(x, residual), device=x.device))

    @staticmethod
    def backward(ctx, dy):
        ins = [None if t is None else t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wrt = [t for t in ins if t is not None and t.requires_grad]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(plain_epilogue(*ins, ctx.act), wrt, dy))
        return (*(next(grads) if t is not None and t.requires_grad else None for t in ins), None)


def _launch(x, shift, scale, conv_bias, residual, act, out) -> torch.Tensor:
    """One launch of the kernel on the current stream, writing ``out``, or
    ``x`` where ``out`` is None (a new tensor where the result is wider than
    x)."""
    global launches
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the conv epilogue kernel takes bfloat16 or float32, got {x.dtype}")
    x = x.contiguous()
    if residual is not None:
        residual = residual.contiguous()
    dtype = _result_dtype(x, residual)
    if out is None:
        out = x if dtype == x.dtype else torch.empty(x.shape, dtype=dtype, device=x.device)
    elif out.shape != x.shape or out.dtype != dtype or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {dtype} tensor of x's shape")
    c = x.shape[-1]
    if (c * x.element_size()) % _VEC_BYTES or any(
            t is not None and t.data_ptr() % _VEC_BYTES for t in (x, residual, out)):
        raise ValueError(f"the conv epilogue kernel needs C * itemsize a multiple of "
                         f"{_VEC_BYTES} and {_VEC_BYTES}-byte aligned tensors "
                         f"(C={c}, {x.dtype})")
    vecs = [None if v is None else v.to(device=x.device, dtype=torch.float32).contiguous()
            for v in (conv_bias, scale, shift)]
    ptrs = [None if v is None else v.data_ptr() for v in vecs]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if dtype != x.dtype:
            err = _lib().cp360_conv_epilogue_f32_residual(
                x.data_ptr(), *ptrs, residual.data_ptr(), out.data_ptr(), x.numel(), c,
                ACTS[act], stream)
        else:
            err = _lib().cp360_conv_epilogue(
                x.data_ptr(), int(x.dtype == torch.bfloat16), *ptrs,
                None if residual is None else residual.data_ptr(), out.data_ptr(),
                x.numel(), c, ACTS[act], stream)
    if err != 0:
        raise RuntimeError(f"conv_epilogue kernel launch failed: CUDA error {err}")
    launches += 1
    return out
