"""NN layers on NHWC tensors with HWIO kernels (the JAX package's layouts).

Thin wrappers over ``torch.nn.functional`` with the numerics of
``cp360_tpu/models/layers.py``: convolutions take a ``compute_dtype`` and
return the input's dtype; inference batch norm runs in f32.  :class:`Conv`
and :class:`BatchNorm` hold one layer's weights for the backbones
(models/resnet.py, vgg.py, mobilenet.py), which run each conv with the
batch norm after it as :func:`conv_bn`: the batch norm folded into the
conv's kernel and its epilogue (:func:`fold`), then one epilogue pass
(``ops/conv_epilogue.py``) for the bias, the residual and the activation.
:class:`Norm` (a LayerNorm over channels) and :func:`patch_embed` (the
patchify stem onto the f32 residual stream) serve ConvNeXt and Swin.

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
from cp360_tpu_torch.ops.conv_epilogue import conv_epilogue

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
    inv, shift = bn_affine(p, eps)
    return (x.float() * inv + shift).to(x.dtype)


def bn_affine(p, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """An inference batch norm as the f32 per-channel (scale, shift) that
    :func:`batch_norm` applies as ``x * scale + shift``: ``scale / sqrt(var
    + eps)`` and ``bias - mean * that``.  p: {'scale', 'bias', 'mean',
    'var'} each [C]."""
    inv = torch.rsqrt(p["var"].float() + eps) * p["scale"].float()
    return inv, p["bias"].float() - p["mean"].float() * inv


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
    backbones fold in their forward instead, from the buffers as they are
    at each call (:func:`fold`)."""
    f64 = {k: torch.as_tensor(np.asarray(v), dtype=torch.float64) for k, v in bn.items()}
    w = torch.as_tensor(np.asarray(conv_w))
    g = f64["scale"] / torch.sqrt(f64["var"] + eps)
    wf = w.to(torch.float64) * g
    bf = f64["bias"] - f64["mean"] * g
    return wf.to(w.dtype), bf.to(w.dtype)


def fold(conv: "Conv", bn: Optional["BatchNorm"], compute_dtype: Optional[torch.dtype] = None):
    """The inference batch norm after ``conv`` split between the conv's
    kernel and its epilogue (``ops/conv_epilogue.py``), from the modules'
    tensors as they are at this call (a weight or statistic changed in
    place shows at the next call, and inside a captured CUDA graph at the
    next replay).  With (g, shift) = :func:`bn_affine`:

    - a conv that computes below f32 (bf16): ``w' = w * g`` in f32, rounded
      once to the kernel's dtype, and the epilogue adds ``shift + g * conv
      bias``.  The kernel's own rounding absorbs g: for statistics at
      identity (g = 1/sqrt(1 + eps), or a power of two times it) ``w'``
      is w (times that power), and the trunk's results are those of the
      explicit chain bit for bit, where a g applied after the bf16 conv
      would push exact sums just below their rounding ties and bias every
      residual add the same way;
    - an f32 conv keeps w, and the epilogue computes ``(x + conv bias) *
      g + shift``: the explicit chain's f32 operations in its order.

    Returns (w OIHW in the kernel's layout, the factor folded into w or
    None, and the epilogue's shift, scale and conv bias, each [C] or None).
    """
    if bn is None:
        return conv.w, None, conv.b, None, None
    g, shift = bn_affine(dict(bn.named_buffers()))
    if (compute_dtype or conv.w.dtype) == torch.float32:
        return conv.w, None, shift, g, conv.b
    if conv.b is not None:
        shift = shift + g * conv.b.float()
    return (conv.w * g.view(-1, 1, 1, 1)).to(conv.w.dtype), g, shift, None, None


def conv_bn(x: torch.Tensor, conv: "Conv", bn: Optional["BatchNorm"], stride=1,
            compute_dtype: Optional[torch.dtype] = None, padding: Padding = "VALID",
            groups: int = 1, act: Optional[str] = None,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act(batch_norm(conv(x) + conv bias) + residual)`` (``bn`` None:
    ``act(conv(x) + conv bias + residual)``) as the conv with the kernel of
    :func:`fold` and one epilogue pass (``ops/conv_epilogue.py``) for the
    rest, in f32, rounded once to the input's dtype: the kernel on a CUDA
    input, writing over the conv's output unless autograd records it, the
    same operations in PyTorch ops on a CPU input.  act None, "relu" or
    "relu6"."""
    w, _, shift, scale, conv_bias = fold(conv, bn, compute_dtype)
    out = conv2d(x, w.permute(2, 3, 1, 0), stride=stride, padding=padding,
                 compute_dtype=compute_dtype, groups=groups)
    return conv_epilogue(out, shift, scale, conv_bias, residual, act)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last (channel) axis: computed in f32 inside
    ``F.layer_norm`` and rounded once to x's dtype."""
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def patch_embed(x: torch.Tensor, conv: "Conv", norm: "Norm", k: int,
                compute_dtype: torch.dtype) -> torch.Tensor:
    """The patchify stem of ConvNeXt and Swin: a kxk stride-k conv with its
    bias in the compute dtype, then a LayerNorm rounded to it; returns the
    f32 residual stream the blocks add onto."""
    out = conv_bn(x.to(compute_dtype), conv, None, k, compute_dtype)
    return norm(out).float()


def pad_faces(x: torch.Tensor, p: int, use_cube_pad: bool = True) -> torch.Tensor:
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
    """An inference batch norm's f32 running statistics, held as buffers
    under the state dict's names; the backbones fold them into the conv
    before (:func:`fold`), and :func:`batch_norm` applies them as an op of
    their own."""

    def __init__(self, p: dict):
        super().__init__()
        for k in ("scale", "bias", "mean", "var"):
            self.register_buffer(k, p[k])


class Norm(nn.Module):
    """A LayerNorm over channels with epsilon ``eps`` whose scale and shift
    are held in ``dtype`` (their own by default), the dtype of its input,
    and whose output is rounded to ``out_dtype`` (the input's by
    default)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor, eps: float,
                 dtype: Optional[torch.dtype] = None, out_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.register_buffer("w", w if dtype is None else w.to(dtype))
        self.register_buffer("b", b if dtype is None else b.to(dtype))
        self.eps, self.out_dtype = eps, out_dtype

    def forward(self, x):
        y = layer_norm(x, self.w, self.b, self.eps)
        return y if self.out_dtype is None else y.to(self.out_dtype)
