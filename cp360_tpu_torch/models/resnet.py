"""Cube-padded ResNet-50 (NHWC, PyTorch).

The forward of ``cp360_tpu/models/resnet.py:139-230`` (the reference's
model/resnet_cubic.py:109-263 with every spatial zero pad of the Bottleneck
and stem path replaced by cube padding):

- stem: CubePad(3) -> 7x7/s2 VALID conv -> BN -> ReLU -> CubePad(1) +
  3x3/s2 max-pool (fused, ops/cube_pad.py::cube_pad_max_pool_3x3s2);
- 16 Bottlenecks with CubePad(1) before each 3x3 VALID conv
  (model/resnet_cubic.py:92-93);
- ``use_cube_pad=False`` swaps in zero padding.

The Bottleneck cube conv runs in the 'pad' form (materialized cube pad, then
a VALID conv) for both dtypes; the JAX package's 'halo' form, its bf16
default, only reassociates the border ring's sum and is not ported yet.
resnet18/34/101/152 are not ported yet either.

Weights come from ``compat/jax_params.py::resnet_from_params``: conv kernels
in the compute dtype, held as OIHW channels_last storage (the layout cuDNN
reads without a copy) and handed to ``layers.conv2d`` as HWIO views; batch
norm statistics and the classifier stay f32, as the JAX package computes
them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cp360_tpu_torch.models import layers
from cp360_tpu_torch.ops import cube_pad as cp_ops

ARCHS = {"resnet50": (3, 4, 6, 3)}  # Bottleneck stage depths
EXPANSION = 4


class Conv(nn.Module):
    """A bias-free conv kernel: OIHW storage, exposed to ``layers.conv2d``
    as the HWIO view the JAX layout names."""

    def __init__(self, w_oihw: torch.Tensor):
        super().__init__()
        self.register_buffer("w", w_oihw)

    def forward(self, x, stride=1, compute_dtype=None):
        return layers.conv2d(x, self.w.permute(2, 3, 1, 0), stride=stride,
                             compute_dtype=compute_dtype)


class BatchNorm(nn.Module):
    """Inference batch norm over f32 running statistics."""

    def __init__(self, p: dict):
        super().__init__()
        for k in ("scale", "bias", "mean", "var"):
            self.register_buffer(k, p[k])

    def forward(self, x):
        return layers.batch_norm(x, {"scale": self.scale, "bias": self.bias,
                                     "mean": self.mean, "var": self.var})


def pad_faces(x: torch.Tensor, p: int, use_cube_pad: bool) -> torch.Tensor:
    """Pad a face-flattened batch [N*6, H, W, C] (cube- or zero-pad)."""
    if p == 0:
        return x
    x6 = x.reshape(-1, 6, *x.shape[1:])
    x6 = cp_ops.cube_pad(x6, p) if use_cube_pad else cp_ops.zero_pad(x6, p)
    return x6.reshape(-1, *x6.shape[2:])


class Bottleneck(nn.Module):
    def __init__(self, convs: dict, bns: dict, stride: int, use_cube_pad: bool):
        super().__init__()
        self.stride = stride
        self.use_cube_pad = use_cube_pad
        self.convs = nn.ModuleDict({k: Conv(v) for k, v in convs.items()})
        self.bns = nn.ModuleDict({k: BatchNorm(v) for k, v in bns.items()})

    def forward(self, x, compute_dtype):
        out = torch.relu(self.bns["bn1"](self.convs["conv1"](x, 1, compute_dtype)))
        out = pad_faces(out, 1, self.use_cube_pad)
        out = self.convs["conv2"](out, self.stride, compute_dtype)
        out = torch.relu(self.bns["bn2"](out))
        out = self.bns["bn3"](self.convs["conv3"](out, 1, compute_dtype))
        if "downsample" in self.convs:
            res = self.bns["downsample"](
                self.convs["downsample"](x, self.stride, compute_dtype))
        else:
            res = x
        return torch.relu(out + res)


class ResNet(nn.Module):
    """Cube-padded ResNet-50 trunk + classifier.

    ``forward(x)`` takes [N, 6, H, W, 3] cube faces (B D F L R T) or
    [N*6, H, W, 3] and returns (logits [N*6, K] or None, layer4 features
    [N*6, h, w, 2048]) like ``cp360_tpu.models.resnet.resnet_apply``.
    """

    def __init__(self, stem: dict, stages: list, fc: dict, arch: str,
                 use_cube_pad: bool, compute_dtype: torch.dtype):
        super().__init__()
        if arch not in ARCHS:
            raise NotImplementedError(
                f"arch {arch!r} is not ported yet (ported: {sorted(ARCHS)}); "
                'see ROADMAP.md, "resnet18/34/101/152"')
        self.arch = arch
        self.use_cube_pad = use_cube_pad
        self.compute_dtype = compute_dtype
        self.conv1 = Conv(stem["conv1"])
        self.bn1 = BatchNorm(stem["bn1"])
        self.stages = nn.ModuleList([
            nn.ModuleList([
                Bottleneck(blk["convs"], blk["bns"],
                           2 if (li > 0 and bi == 0) else 1, use_cube_pad)
                for bi, blk in enumerate(stage)])
            for li, stage in enumerate(stages)])
        self.register_buffer("fc_w", fc["w"])  # [C, K] f32
        self.register_buffer("fc_b", fc["b"])

    def forward(self, x: torch.Tensor, with_logits: bool = True
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        if x.ndim == 5:
            x = x.reshape(-1, *x.shape[2:])
        cd = self.compute_dtype
        # cast once at trunk entry: with bf16 compute every activation
        # (pads, BN, relu, residual adds) stays bf16, as in the JAX package
        x = x.to(cd)
        out = pad_faces(x, 3, self.use_cube_pad)
        out = torch.relu(self.bn1(self.conv1(out, 2, cd)))
        if self.use_cube_pad:
            out = cp_ops.cube_pad_max_pool_3x3s2(out.reshape(-1, 6, *out.shape[1:]))
            out = out.reshape(-1, *out.shape[2:])
        else:
            out = layers.max_pool(pad_faces(out, 1, False), 3, 2)
        for stage in self.stages:
            for block in stage:
                out = block(out, cd)
        feats = out  # layer4 output — the CAM feature map
        if not with_logits:
            return None, feats
        pooled = F.avg_pool2d(out.permute(0, 3, 1, 2).float(), 7).flatten(1)
        logits = (pooled @ self.fc_w.float()).to(out.dtype) + self.fc_b
        return logits, feats
