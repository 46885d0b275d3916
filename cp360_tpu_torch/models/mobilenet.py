"""Cube-padded MobileNetV2 backbone + CAM head (NHWC, PyTorch).

The forward of ``cp360_tpu/models/mobilenet.py::mobilenet_v2_apply``, in
torchvision's configuration: a cube-padded 3x3/s2 stem 3 -> 32, inverted
residual blocks (1x1 expand, cube-padded 3x3 depthwise run VALID with
``groups = C``, 1x1 project; ReLU6 after the expand and the depthwise conv;
a residual add where the stride is 1 and the widths match), a 1x1 head to
1280 and the classifier 1280 -> K through a global average pool.  224
faces give 7x7x1280 features; the CAM weight ``cam_w`` is the classifier's
[1280, K].  The stem is a strided conv, not a pool, so K3 is not on this
path.

Weights come from ``compat/jax_params.py::mobilenet_v2_from_params``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from cp360_tpu_torch.models import layers
from cp360_tpu_torch.models.layers import BatchNorm, Conv, pad_faces

# (expansion t, out channels c, repeats n, first stride s)
V2_CFG = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
          (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
LAST = 1280
STRIDES = tuple((t, s if i == 0 else 1) for t, c, n, s in V2_CFG for i in range(n))


class ConvBN(nn.Module):
    """Conv -> BN -> optional residual add -> optional ReLU6; a 3x3 is
    cube-padded (or zero-padded) and run VALID; all but the conv is one
    epilogue pass (``models/layers.py::conv_bn``)."""

    def __init__(self, w_oihw: torch.Tensor, bn: dict):
        super().__init__()
        self.conv = Conv(w_oihw)
        self.bn = BatchNorm(bn)

    def forward(self, x, cd, use_cube_pad, stride=1, groups=1, act=True, residual=None):
        if self.conv.w.shape[-1] == 3:
            x = pad_faces(x, 1, use_cube_pad)
        return layers.conv_bn(x, self.conv, self.bn, stride, cd, groups=groups,
                              act="relu6" if act else None, residual=residual)


class MobileNetV2(nn.Module):
    """``forward(x)`` takes [N, 6, H, W, 3] or [N*6, H, W, 3] faces and
    returns (logits [N*6, K] or None, head features [N*6, h, w, 1280])."""

    arch = "mobilenet_v2"

    def __init__(self, stem: dict, blocks: list, head: dict, fc: dict,
                 use_cube_pad: bool, compute_dtype: torch.dtype):
        super().__init__()
        if len(blocks) != len(STRIDES):
            raise ValueError(f"mobilenet_v2 has {len(STRIDES)} blocks, the weights "
                             f"{len(blocks)}")
        self.use_cube_pad = use_cube_pad
        self.compute_dtype = compute_dtype
        self.stem = ConvBN(stem["w"], stem["bn"])
        self.blocks = nn.ModuleList([
            nn.ModuleDict({k: ConvBN(v["w"], v["bn"]) for k, v in blk.items()})
            for blk in blocks])
        self.head = ConvBN(head["w"], head["bn"])
        self.register_buffer("cam_w", fc["w"])  # [C, K] f32
        self.register_buffer("cam_b", fc["b"])

    def forward(self, x: torch.Tensor, with_logits: bool = True
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        if x.ndim == 5:
            x = x.reshape(-1, *x.shape[2:])
        cd, cp = self.compute_dtype, self.use_cube_pad
        out = self.stem(x.to(cd), cd, cp, stride=2)
        for blk, (t, stride) in zip(self.blocks, STRIDES):
            inp = out
            if t != 1:
                out = blk["expand"](out, cd, cp)
            out = blk["dw"](out, cd, cp, stride=stride, groups=out.shape[-1])
            # torchvision's use_res_connect, added in the projection's epilogue
            res = inp if stride == 1 and inp.shape[-1] == blk["project"].conv.w.shape[0] else None
            out = blk["project"](out, cd, cp, act=False, residual=res)
        feats = self.head(out, cd, cp)
        if not with_logits:
            return None, feats
        pooled = feats.mean(dim=(1, 2))
        return layers.linear(pooled, {"w": self.cam_w, "b": self.cam_b}), feats
