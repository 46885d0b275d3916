"""Cube-padded VGG16-BN backbone + CAM head (NHWC, PyTorch).

The forward of ``cp360_tpu/models/vgg.py::vgg16_apply``: VGG16-BN
configuration "D" with every 3x3 conv preceded by cube padding and run
VALID, 2x2/s2 max pools (224 faces -> 7x7x512), then the CAM head the
reference's commented-out VGG call implies
(static_model/dataset_feat_extractor.py:50-52,164-167): ``camconv``, a
cube-padded 3x3 512 -> 1024 with bias and ReLU, feeding the ``classifier``
linear 1024 -> K through a global average pool.  The CAM weight
``cam_w`` is the classifier's [1024, K].  There is no stem pool here, so
K3 is not on this path.

Weights come from ``compat/jax_params.py::vgg16_from_params``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from cp360_tpu_torch.models import layers
from cp360_tpu_torch.models.layers import BatchNorm, Conv, pad_faces

# VGG-16 configuration "D": conv widths with 'M' pool markers.
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]


class VGG16(nn.Module):
    """``forward(x)`` takes [N, 6, H, W, 3] or [N*6, H, W, 3] faces and
    returns (logits [N*6, K] or None, camconv features [N*6, h, w, 1024])."""

    arch = "vgg16"

    def __init__(self, features: list, camconv: dict, classifier: dict,
                 use_cube_pad: bool, compute_dtype: torch.dtype):
        super().__init__()
        self.use_cube_pad = use_cube_pad
        self.compute_dtype = compute_dtype
        self.convs = nn.ModuleList([Conv(f["w"], f["b"]) for f in features])
        self.bns = nn.ModuleList([BatchNorm(f["bn"]) for f in features])
        self.camconv = Conv(camconv["w"], camconv["b"])
        self.register_buffer("cam_w", classifier["w"])  # [C, K] f32
        self.register_buffer("cam_b", classifier["b"])

    def forward(self, x: torch.Tensor, with_logits: bool = True
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        if x.ndim == 5:
            x = x.reshape(-1, *x.shape[2:])
        cd = self.compute_dtype
        out = x.to(cd)  # one entry cast: the trunk stays in the compute dtype
        ci = 0
        for v in VGG16_CFG:
            if v == "M":
                out = layers.max_pool(out, 2, 2)
                continue
            out = self.convs[ci](pad_faces(out, 1, self.use_cube_pad), 1, cd)
            out = torch.relu(self.bns[ci](out))
            ci += 1
        feats = torch.relu(self.camconv(pad_faces(out, 1, self.use_cube_pad), 1, cd))
        if not with_logits:
            return None, feats
        pooled = feats.mean(dim=(1, 2))
        return layers.linear(pooled, {"w": self.cam_w, "b": self.cam_b}), feats
