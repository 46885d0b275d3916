"""NN layers on NHWC tensors with HWIO kernels (the JAX package's layouts).

Thin wrappers over ``torch.nn.functional`` with the numerics of
``cp360_tpu/models/layers.py``: convolutions take a ``compute_dtype`` and
return the input's dtype; inference batch norm runs in f32.

Layout: an NHWC activation permuted to NCHW is a channels_last tensor, the
layout cuDNN convolves without a copy; the port keeps its ResNet kernels as
HWIO views of channels_last OIHW storage (compat/jax_params.py) so the
kernel side needs no copy either.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def f32_convs_without_tf32() -> None:
    """Switch cuDNN's TF32 off for f32 convolutions, for the whole process.

    cuDNN reads ``torch.backends.cudnn.allow_tf32`` (default True) when a
    conv launches, and the flag is process-global.  Entering and leaving
    ``torch.backends.cudnn.flags(allow_tf32=False)`` around each conv would
    race: the server's two batcher threads could interleave, and one
    thread's exit would restore True while the other convolves.  This
    latch only ever writes False and nothing in the package writes True,
    so once it has run no thread convolves f32 in TF32.  Every f32 conv
    calls it before its launch, whatever the caller's flags were; bf16
    convs never read the flag.  (f32 matmuls are true f32 products under
    torch's default ``float32_matmul_precision`` "highest".)
    """
    if torch.backends.cudnn.allow_tf32:
        torch.backends.cudnn.allow_tf32 = False


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: int = 1,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """2-D VALID convolution, NHWC x HWIO -> NHWC (callers pad explicitly).

    With ``compute_dtype`` the operands are cast to it and the result cast
    back to the input's dtype (``cp360_tpu/models/layers.py::conv2d``); a
    bf16 conv accumulates in f32 inside cuDNN and rounds once at the store.
    f32 operands convolve as true f32 products, as the JAX package's
    ``precision="highest"`` asks: see :func:`f32_convs_without_tf32`.
    """
    orig_dtype = x.dtype
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    if x.dtype == torch.float32:
        f32_convs_without_tf32()
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride)
    out = out.permute(0, 2, 3, 1).to(orig_dtype)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def batch_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode batch norm with running statistics, computed in f32
    and cast back (``cp360_tpu/models/layers.py:69-78``).

    p: {'scale', 'bias', 'mean', 'var'} each [C].
    """
    inv = torch.rsqrt(p["var"].float() + eps) * p["scale"].float()
    shift = p["bias"].float() - p["mean"].float() * inv
    return (x.float() * inv + shift).to(x.dtype)


def max_pool(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Max pooling, VALID padding (the models pre-pad explicitly)."""
    out = F.max_pool2d(x.permute(0, 3, 1, 2), k, stride)
    return out.permute(0, 2, 3, 1)
