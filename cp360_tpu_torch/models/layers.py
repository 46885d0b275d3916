"""NN layers on NHWC tensors with HWIO kernels (the JAX package's layouts).

Thin wrappers over ``torch.nn.functional`` with the numerics of
``cp360_tpu/models/layers.py``: convolutions take a ``compute_dtype`` and
return the input's dtype; inference batch norm runs in f32.  :class:`Conv`
and :class:`BatchNorm` hold one layer's weights for the backbones
(models/resnet.py, vgg.py, mobilenet.py).

Layout: an NHWC activation permuted to NCHW is a channels_last tensor, the
layout cuDNN convolves without a copy; the backbones keep their kernels as
HWIO views of channels_last OIHW storage (compat/jax_params.py) so the
kernel side needs no copy either.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cp360_tpu_torch.ops import cube_pad as cp_ops

Padding = Union[str, Sequence[Tuple[int, int]]]


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


def _pairs(x) -> Tuple[int, ...]:
    return (int(x),) * 2 if isinstance(x, (int, np.integer)) else tuple(int(v) for v in x)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: Union[int, Tuple[int, int]] = 1,
    padding: Padding = "VALID",
    compute_dtype: Optional[torch.dtype] = None,
    groups: int = 1,
) -> torch.Tensor:
    """2-D convolution, NHWC x HWIO -> NHWC (``cp360_tpu/models/layers.py:26``).

    ``padding`` is "VALID" or ((top, bottom), (left, right)) zero pads;
    ``groups`` takes an HWIO kernel [kh, kw, cin/groups, cout], so
    ``groups == cin`` with a [kh, kw, 1, cin] kernel is a depthwise conv.
    With ``compute_dtype`` the operands are cast to it and the result cast
    back to the input's dtype; a bf16 conv accumulates in f32 inside cuDNN
    and rounds once at the store.  f32 operands convolve as true f32
    products, as the JAX package's ``precision="highest"`` asks: see
    :func:`f32_convs_without_tf32`.
    """
    stride = _pairs(stride)
    pads = ((0, 0), (0, 0)) if padding == "VALID" else tuple(_pairs(p) for p in padding)
    orig_dtype = x.dtype
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    if x.dtype == torch.float32:
        f32_convs_without_tf32()
    xc = x.permute(0, 3, 1, 2)
    (pt, pb), (pl, pr) = pads
    if pt != pb or pl != pr:  # F.conv2d pads both sides alike: pad apart first
        xc = F.pad(xc, (pl, pr, pt, pb))
        pt = pl = 0
    out = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=(pt, pl), groups=groups)
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


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Average pooling with window = stride = k, VALID."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x [N, in] @ w [in, out] + b, accumulated in f32 and cast to x's
    dtype before the bias (``cp360_tpu/models/layers.py:93-104``)."""
    y = torch.matmul(x.float(), p["w"].float()).to(x.dtype)
    return y + p["b"]


def fold_batch_norm_into_conv(conv_w, bn: dict, eps: float = 1e-5):
    """Fold an inference batch norm into the conv before it: (w', b') with
    ``conv2d(x, w', b') == batch_norm(conv2d(x, w), bn)``
    (``cp360_tpu/models/layers.py:126``), computed in f64 and returned as
    tensors in the kernel's dtype.  For offline checkpoint preparation; the
    backbones keep the explicit batch norm."""
    f64 = {k: torch.as_tensor(np.asarray(v), dtype=torch.float64) for k, v in bn.items()}
    w = torch.as_tensor(np.asarray(conv_w))
    g = f64["scale"] / torch.sqrt(f64["var"] + eps)
    wf = w.to(torch.float64) * g
    bf = f64["bias"] - f64["mean"] * g
    return wf.to(w.dtype), bf.to(w.dtype)


def pad_faces(x: torch.Tensor, p: int, use_cube_pad: bool) -> torch.Tensor:
    """Pad a face-flattened batch [N*6, H, W, C] (cube- or zero-pad)."""
    if p == 0:
        return x
    x6 = x.reshape(-1, 6, *x.shape[1:])
    x6 = cp_ops.cube_pad(x6, p) if use_cube_pad else cp_ops.zero_pad(x6, p)
    return x6.reshape(-1, *x6.shape[2:])


class Conv(nn.Module):
    """A conv kernel (and optional bias): OIHW storage, exposed to
    :func:`conv2d` as the HWIO view the JAX layout names."""

    def __init__(self, w_oihw: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("w", w_oihw)
        self.register_buffer("b", b)

    @property
    def hwio(self) -> torch.Tensor:
        return self.w.permute(2, 3, 1, 0)

    def forward(self, x, stride=1, compute_dtype=None, padding="VALID", groups=1):
        return conv2d(x, self.hwio, self.b, stride=stride, padding=padding,
                      compute_dtype=compute_dtype, groups=groups)


class BatchNorm(nn.Module):
    """Inference batch norm over f32 running statistics."""

    def __init__(self, p: dict):
        super().__init__()
        for k in ("scale", "bias", "mean", "var"):
            self.register_buffer(k, p[k])

    def forward(self, x):
        return batch_norm(x, {"scale": self.scale, "bias": self.bias,
                              "mean": self.mean, "var": self.var})
