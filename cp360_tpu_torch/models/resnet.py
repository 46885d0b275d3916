"""Cube-padded ResNet family (NHWC, PyTorch): resnet18/34/50/101/152.

The forward of ``cp360_tpu/models/resnet.py:139-230`` (the reference's
model/resnet_cubic.py:109-263 with every spatial zero pad of the Bottleneck
and stem path replaced by cube padding):

- stem: CubePad(3) -> 7x7/s2 VALID conv -> BN -> ReLU -> CubePad(1) +
  3x3/s2 max-pool (fused, ops/cube_pad.py::cube_pad_max_pool_3x3s2);
- Bottlenecks (resnet50/101/152) with CubePad(1) before each 3x3 VALID conv
  (model/resnet_cubic.py:92-93);
- BasicBlocks (resnet18/34) keep zero padding=1 and no cube pad, a
  documented reference quirk (model/resnet_cubic.py:27-41);
- ``use_cube_pad=False`` swaps in zero padding.

The Bottleneck cube conv runs in one of the two forms of
``ops/cube_pad.py::cube_pad_conv3x3``: ``cube_conv_form=None`` resolves as
the JAX package does, to ``pad`` under f32 compute and to ``halo`` under
bf16.

Weights come from ``compat/jax_params.py::resnet_from_params``: conv kernels
in the compute dtype, held as OIHW channels_last storage (the layout cuDNN
reads without a copy) and handed to ``layers.conv2d`` as HWIO views; batch
norm statistics and the classifier stay f32, as the JAX package computes
them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from cp360_tpu_torch.models import layers
from cp360_tpu_torch.models.layers import BatchNorm, Conv, pad_faces
from cp360_tpu_torch.ops import cube_pad as cp_ops

ARCHS = {
    # name: (block kind, stage depths)
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}
EXPANSION = {"basic": 1, "bottleneck": 4}


def resolve_cube_conv_form(form: Optional[str], compute_dtype: torch.dtype) -> str:
    """``None`` -> ``pad`` under f32 compute, ``halo`` under bf16 (the JAX
    package's default, ``cp360_tpu/models/resnet.py:162-171``)."""
    if form is None:
        return "pad" if compute_dtype in (None, torch.float32) else "halo"
    if form not in cp_ops.CUBE_CONV_FORMS:
        raise ValueError(f"unknown cube-conv form {form!r} (one of {cp_ops.CUBE_CONV_FORMS})")
    return form


class Block(nn.Module):
    """A Bottleneck (convs conv1..conv3) or a BasicBlock (conv1, conv2),
    with an optional downsample conv + BN on the residual."""

    def __init__(self, kind: str, convs: dict, bns: dict, stride: int, use_cube_pad: bool,
                 cube_conv_form: str):
        super().__init__()
        self.kind = kind
        self.stride = stride
        self.use_cube_pad = use_cube_pad
        self.convs = nn.ModuleDict({k: Conv(v) for k, v in convs.items()})
        self.bns = nn.ModuleDict({k: BatchNorm(v) for k, v in bns.items()})
        halo = kind == "bottleneck" and use_cube_pad and cube_conv_form == "halo"
        # the strip convs' kernel, made once rather than on every call
        self.register_buffer("w_halo", cp_ops.halo_kernel(self.convs["conv2"].hwio, stride)
                             if halo else None)

    def _cube_conv(self, x, cd):
        if self.w_halo is not None and x.shape[1] == x.shape[2]:
            out = cp_ops.cube_pad_conv3x3(x.reshape(-1, 6, *x.shape[1:]),
                                          self.convs["conv2"].hwio, self.stride, cd, "halo",
                                          self.w_halo)
            return out.reshape(-1, *out.shape[2:])
        return self.convs["conv2"](pad_faces(x, 1, self.use_cube_pad), self.stride, cd)

    def forward(self, x, cd):
        if self.kind == "bottleneck":
            out = torch.relu(self.bns["bn1"](self.convs["conv1"](x, 1, cd)))
            out = torch.relu(self.bns["bn2"](self._cube_conv(out, cd)))
            out = self.bns["bn3"](self.convs["conv3"](out, 1, cd))
        else:  # BasicBlock: zero padding=1, whatever use_cube_pad says
            out = self.convs["conv1"](x, self.stride, cd, padding=((1, 1), (1, 1)))
            out = torch.relu(self.bns["bn1"](out))
            out = self.bns["bn2"](self.convs["conv2"](out, 1, cd, padding=((1, 1), (1, 1))))
        if "downsample" in self.convs:
            res = self.bns["downsample"](self.convs["downsample"](x, self.stride, cd))
        else:
            res = x
        return torch.relu(out + res)


class ResNet(nn.Module):
    """Cube-padded ResNet trunk + classifier.

    ``forward(x)`` takes [N, 6, H, W, 3] cube faces (B D F L R T) or
    [N*6, H, W, 3] and returns (logits [N*6, K] or None, layer4 features
    [N*6, h, w, C]) like ``cp360_tpu.models.resnet.resnet_apply``.  The CAM
    weight is ``cam_w``, the classifier's [C, K].
    """

    def __init__(self, stem: dict, stages: list, fc: dict, arch: str,
                 use_cube_pad: bool, compute_dtype: torch.dtype,
                 cube_conv_form: Optional[str] = None):
        super().__init__()
        if arch not in ARCHS:
            raise ValueError(f"unknown arch {arch!r} (one of {sorted(ARCHS)})")
        kind, depths = ARCHS[arch]
        if [len(s) for s in stages] != list(depths):
            raise ValueError(f"{arch} has stages of {depths} blocks, the weights "
                             f"{[len(s) for s in stages]}")
        self.arch = arch
        self.use_cube_pad = use_cube_pad
        self.compute_dtype = compute_dtype
        self.cube_conv_form = resolve_cube_conv_form(cube_conv_form, compute_dtype)
        self.conv1 = Conv(stem["conv1"])
        self.bn1 = BatchNorm(stem["bn1"])
        self.stages = nn.ModuleList([
            nn.ModuleList([
                Block(kind, blk["convs"], blk["bns"], 2 if (li > 0 and bi == 0) else 1,
                      use_cube_pad, self.cube_conv_form)
                for bi, blk in enumerate(stage)])
            for li, stage in enumerate(stages)])
        self.register_buffer("fc_w", fc["w"])  # [C, K] f32
        self.register_buffer("fc_b", fc["b"])

    @property
    def cam_w(self) -> torch.Tensor:
        return self.fc_w

    def forward(self, x: torch.Tensor, with_logits: bool = True
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        if x.ndim == 5:
            x = x.reshape(-1, *x.shape[2:])
        cd = self.compute_dtype
        # cast once at trunk entry: with bf16 compute every activation
        # (pads, BN, relu, residual adds) stays bf16, as in the JAX package
        x = x.to(cd)
        out = torch.relu(self.bn1(self.conv1(pad_faces(x, 3, self.use_cube_pad), 2, cd)))
        if self.use_cube_pad and out.shape[1] == out.shape[2] and out.shape[1] % 2 == 0:
            out = cp_ops.cube_pad_max_pool_3x3s2(out.reshape(-1, 6, *out.shape[1:]))
            out = out.reshape(-1, *out.shape[2:])
        else:
            out = layers.max_pool(pad_faces(out, 1, self.use_cube_pad), 3, 2)
        for stage in self.stages:
            for block in stage:
                out = block(out, cd)
        feats = out  # layer4 output — the CAM feature map
        if not with_logits:
            return None, feats
        pooled = layers.avg_pool(out, 7).flatten(1)
        return layers.linear(pooled, {"w": self.fc_w, "b": self.fc_b}), feats
