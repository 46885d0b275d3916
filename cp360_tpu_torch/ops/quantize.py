"""Transfer-layer int8 codec for CAM feature planes.

The port's copy of ``cp360_tpu/ops/quantize.py`` (``quantize_cam``,
``dequantize_cam`` and their numpy forms): a per-(face, channel) symmetric
int8 quantization, scale_c = amax_c / 127 over the 7x7 plane, so the
worst-case error is amax_c / 254, about 0.4% of the channel's own peak.
It is a TRANSFER codec only (config ``transfer_codec: int8``): the on-disk
artifact ([6, 1000, 7, 7] f16/f32 ``.npy``) is unchanged.  Stage 1
quantizes on the device and the host dequantizes before writing; stage 2
quantizes on the host after reading and dequantizes on the device.

The torch and numpy forms compute the same thing in the same f32 steps,
so the host and device quantizers agree bit for bit.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

# symmetric, zero-preserving grid (0.0 -> 0 -> 0.0 exactly; CAM planes are
# ReLU-adjacent and zero-heavy)
_QMAX = 127.0
# scale = amax * (1/127) as an explicit f32 reciprocal multiply, as the JAX
# package spells it, so every form rounds the scale identically
_INV_QMAX = np.float32(1.0) / np.float32(_QMAX)

_NP_DTYPES = {torch.float16: np.float16, torch.float32: np.float32}


class Quantized(NamedTuple):
    """A quantized plane batch on its way to the device: int8 planes
    [..., h, w, C] and their scales [..., 1, 1, C], numpy on the host or
    tensors on either device.  The training loader yields the CAM windows
    in this form with ``transfer_codec: int8``; the consumer calls
    :func:`maybe_dequantize`."""

    q: Any
    scales: Any

    def to(self, device, non_blocking: bool = False) -> "Quantized":
        """Both parts as tensors on ``device`` (numpy parts are wrapped
        first)."""
        return Quantized(*(torch.as_tensor(a).to(device, non_blocking=non_blocking)
                           for a in self))


def _scale_range(scale_dtype) -> tuple:
    """(smallest subnormal, max) of the scale dtype as f32: a scale rounded
    to f16 must stay finite and non-zero (dequantize would give 0*inf)."""
    fin = np.finfo(scale_dtype)
    return float(np.float32(fin.smallest_subnormal)), float(np.float32(fin.max))


def quantize_cam(x: torch.Tensor, scale_dtype: torch.dtype = torch.float32):
    """[..., h, w, C] float -> (q int8 [..., h, w, C], scales ``scale_dtype``
    [..., 1, 1, C]).  A constant-zero channel gets scale 1/127 and
    quantizes to exact zeros.  With ``scale_dtype=torch.float16`` the scale
    is rounded to f16 first and the planes quantize against the rounded
    value."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-3, -2), keepdim=True)
    inv = torch.tensor(_INV_QMAX, dtype=torch.float32, device=x.device)
    scales = torch.where(amax > 0.0, amax, torch.ones_like(amax)) * inv
    lo, hi = _scale_range(_NP_DTYPES[scale_dtype])
    scales = scales.clamp(lo, hi).to(scale_dtype)
    q = torch.round(xf / scales.float()).clamp(-_QMAX, _QMAX).to(torch.int8)
    return q, scales


def dequantize_cam(q: torch.Tensor, scales: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_cam` (on the device, so only int8 and
    the small scale tensor cross the link)."""
    return (q.float() * scales.float()).to(dtype)


def maybe_dequantize(x, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A tensor -> ``x.to(dtype)``; a :class:`Quantized` -> its dequantized
    planes, computed where its tensors live (on the card, only int8 and
    the scales crossed)."""
    if isinstance(x, Quantized):
        return dequantize_cam(x.q, x.scales, dtype)
    return x.to(dtype)


def quantize_cam_np(x: np.ndarray, scale_dtype=np.float32):
    """Host form of :func:`quantize_cam` (same math)."""
    xf = np.asarray(x, dtype=np.float32)
    amax = np.max(np.abs(xf), axis=(-3, -2), keepdims=True)
    scales = np.where(amax > 0.0, amax, 1.0).astype(np.float32) * _INV_QMAX
    lo, hi = _scale_range(scale_dtype)
    scales = np.clip(scales, np.float32(lo), np.float32(hi)).astype(scale_dtype)
    q = np.clip(np.round(xf / scales.astype(np.float32)), -_QMAX, _QMAX).astype(np.int8)
    return q, scales


def dequantize_cam_np(q: np.ndarray, scales: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Host form of :func:`dequantize_cam` (stage 1 writes the usual float
    artifact after fetching int8)."""
    return (q.astype(np.float32) * scales).astype(dtype)
