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
the JAX package does, to ``CP360_CUBE_CONV_FORM`` where it is set, else to
``pad`` under f32 compute and to ``halo`` under bf16.

Every conv runs as ``models/layers.py::conv_bn``: the batch norm after it
folded into the conv (``layers.fold``), then one epilogue pass
(``ops/conv_epilogue.py``) for the bias, the block's residual (into the
last conv of a block) and the ReLU.

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
from cp360_tpu_torch.ops.conv_epilogue import conv_epilogue

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
    """``None`` -> ``CP360_CUBE_CONV_FORM`` where set, else ``pad`` under
    f32 compute and ``halo`` under bf16 (the JAX package's default,
    ``cp360_tpu/models/resnet.py:162-171``)."""
    if form is None:
        return cp_ops.CUBE_CONV_FORM or (
            "pad" if compute_dtype in (None, torch.float32) else "halo")
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
        """The bottleneck's cube-padded conv2 -> bn2 -> ReLU: the conv with
        the folded kernel (and the halo strips' kernel, scaled by the same
        factors), strips and interior summed, then one epilogue pass."""
        w, g, shift, scale, _ = layers.fold(self.convs["conv2"], self.bns["bn2"], cd)
        w = w.permute(2, 3, 1, 0)
        if self.w_halo is not None and x.shape[1] == x.shape[2]:
            w_halo = self.w_halo
            if g is not None:
                strips = w_halo.shape[-1] // g.numel()
                w_halo = (w_halo * g.repeat(strips)).to(w_halo.dtype)
            out = cp_ops.cube_pad_conv3x3(x.reshape(-1, 6, *x.shape[1:]), w, self.stride, cd,
                                          "halo", w_halo)
            out = out.reshape(-1, *out.shape[2:])
        else:
            out = layers.conv2d(pad_faces(x, 1, self.use_cube_pad), w, stride=self.stride,
                                compute_dtype=cd)
        return conv_epilogue(out, shift, scale, act="relu")

    def forward(self, x, cd):
        """The block's last conv takes the residual (the downsample conv's
        output, no activation of its own, or the input) into its epilogue."""
        convs, bns = self.convs, self.bns
        if self.kind == "bottleneck":
            out = layers.conv_bn(x, convs["conv1"], bns["bn1"], 1, cd, act="relu")
            out = self._cube_conv(out, cd)
            conv, bn, pad = convs["conv3"], bns["bn3"], "VALID"
        else:  # BasicBlock: zero padding=1, whatever use_cube_pad says
            pad = ((1, 1), (1, 1))
            out = layers.conv_bn(x, convs["conv1"], bns["bn1"], self.stride, cd, pad, act="relu")
            conv, bn = convs["conv2"], bns["bn2"]
        res = x
        if "downsample" in convs:
            res = layers.conv_bn(x, convs["downsample"], bns["downsample"], self.stride, cd)
        return layers.conv_bn(out, conv, bn, 1, cd, pad, act="relu", residual=res)


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
        out = layers.conv_bn(pad_faces(x, 3, self.use_cube_pad), self.conv1, self.bn1, 2, cd,
                             act="relu")
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
