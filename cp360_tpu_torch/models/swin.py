"""Cube-padded Swin Transformer backbone + CAM head (NHWC, PyTorch).

Swin (Liu et al., "Swin Transformer: Hierarchical Vision Transformer using
Shifted Windows", arXiv 2103.14030; the settings of microsoft/Swin-Transformer
``configs/swin/swin_*_patch4_window7_224.yaml``) on each cube face:

- patch embed: a 4x4 stride-4 conv 3 -> C0 with its bias, then a LayerNorm
  (patch norm; no absolute position embedding);
- four stages of ``depths[i]`` blocks at width C_i with C_i / 32 heads,
  stages after the first entered through patch merging: the 2x2
  neighbours concatenated in the published order (x[0::2, 0::2],
  x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]), a LayerNorm over 4C and a
  linear 4C -> 2C without bias;
- block: ``x = x + proj(WA(LN1(x)))``, then ``x = x + fc2(GELU(fc1(LN2(x))))``
  with qkv C -> 3C and proj C -> C with biases, fc1 C -> 4C and fc2 4C ->
  C, GELU the exact erf form (drop path is the identity at inference);
  blocks alternate regular windows (even) and windows shifted by M//2
  (odd), M = 7, with a learned relative-position bias a head;
- head: a LayerNorm, the global mean and the classifier C -> K.

Cube padding is the paper's idea: every spatial padding becomes padding
from the neighbouring faces.  Swin's one spatial padding is at the image's
edge in a shifted layer, where the published code rolls the map round and
masks the wrapped slots.  Here a shifted layer's windows are the M x M
tiles of the face's token grid cube-padded by M - M//2 before and M//2
after on each axis (``ops/cube_window_attn.py``): the published window
boundaries, with each edge window whole, its out-of-face slots drawn from
the neighbouring faces, and no mask.  Regular layers are per face, as
published.  A stage whose grid is the window (stage 4 on 224 faces: 7x7)
is one window and, by the published rule, not shifted.  With
``use_cube_pad`` False a shifted layer is the published roll and mask on
each face.  Faces whose stage grids the window does not tile are refused
(:func:`stage_grids`): every grid a multiple of M, so faces of 224 * k px.

The CAM: the features are the head's LayerNorm at each position of the
last stage's map, and the CAM is ``models/cam.py::cam_scores`` of them.
The published head normalises each position before the mean, so the CAM's
mean over positions plus the bias is exactly the logits.

Numerics, as ``models/convnext.py``'s: the residual stream (the patch
embed's output, each merging's output and every block's sums) is held in
f32, and what the blocks compute from it in the compute dtype (bf16 on
the main path).  Every LayerNorm reads the f32 stream and writes the
compute dtype (``layers.Norm``: f32 inside ``F.layer_norm``, one
rounding).  qkv, proj, fc1, fc2 and the merging's linear are 1x1 convs
through ``models/layers.py::conv2d`` (cuDNN; bf16 operands, f32 sums).  The
qkv bias is added inside the window attention (``ops/cube_window_attn.py``,
the hand-written kernel on the card); proj's and fc2's biases and the
residual adds run in one epilogue pass each onto the f32 stream
(``ops/conv_epilogue.py``'s f32-residual form), fc1's bias and GELU in
another (its GELU form).

Parameters (:class:`SwinTransformer`'s ``params``; ``compat/swin_params.py``
makes them from a numpy tree): kernels OIHW in the compute dtype with
channels-last storage (``stem.w`` [C0, 3, 4, 4]; each block's ``w_qkv``
[3C, C, 1, 1], ``w_proj``, ``w1`` [4C, C, 1, 1], ``w2`` [C, 4C, 1, 1]; each
merging's ``w`` [2C, 4C, 1, 1]), LayerNorm scales and shifts (``ln*_w``,
``ln*_b``) in the compute dtype, biases, the relative-position tables
(``table`` [(2M-1)^2, heads]) and the classifier ``fc_w`` [C, K], ``fc_b`` in
f32.  The module holds the scales and shifts of the LayerNorms that read the
stream widened to f32.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from cp360_tpu_torch.models import layers
from cp360_tpu_torch.models.layers import Conv, Norm
from cp360_tpu_torch.ops.conv_epilogue import conv_epilogue
from cp360_tpu_torch.ops.cube_window_attn import cube_window_attn

# (embed width, depths, heads) of the published models (microsoft/Swin-Transformer)
ARCHS = {
    "swin_tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "swin_small": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "swin_base": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
    "swin_large": (192, (2, 2, 18, 2), (6, 12, 24, 48)),
}
WINDOW = 7
PATCH = 4
MLP_RATIO = 4
LN_EPS = 1e-5


def arch_name(embed: int, depths: Sequence[int], heads: Sequence[int]) -> str:
    """The published name of (embed, depths, heads), or "swin" for another."""
    for name, (e, d, h) in ARCHS.items():
        if (embed, tuple(depths), tuple(heads)) == (e, d, h):
            return name
    return "swin"


def stage_grids(face: int, window: int = WINDOW) -> List[Tuple[int, bool]]:
    """(token grid, whether its odd blocks shift) of each stage on faces of
    ``face`` px; raises, naming the face size, where the window does not
    tile a grid (a grid equal to the window is one window, unshifted)."""
    out, g = [], face // PATCH
    for i in range(4):
        if i:
            g //= 2
        if face % (PATCH * 8) or g < window or g % window:
            raise ValueError(
                f"Swin's {window}x{window} windows do not tile the stage-{i + 1} token grid "
                f"of {face} px faces ({face / PATCH / 2 ** i:g} tokens a side); faces of "
                f"{PATCH * 8 * window} * k px do")
        out.append((g, g > window))
    return out


class Block(nn.Module):
    """One Swin block on a face batch [N*6, S, S, C] of the f32 residual
    stream."""

    def __init__(self, p: dict, compute_dtype: torch.dtype):
        super().__init__()
        f32 = torch.float32
        self.norm1 = Norm(p["ln1_w"], p["ln1_b"], LN_EPS, f32, compute_dtype)
        self.qkv = Conv(p["w_qkv"], p["b_qkv"])
        self.register_buffer("table", p["table"])  # [(2M-1)^2, heads] f32
        self.proj = Conv(p["w_proj"], p["b_proj"])
        self.norm2 = Norm(p["ln2_w"], p["ln2_b"], LN_EPS, f32, compute_dtype)
        self.fc1 = Conv(p["w1"], p["b1"])
        self.fc2 = Conv(p["w2"], p["b2"])
        self.heads = int(p["table"].shape[1])

    def forward(self, x: torch.Tensor, shift: bool, use_cube_pad: bool,
                cd: torch.dtype) -> torch.Tensor:
        qkv = layers.conv2d(self.norm1(x), self.qkv.hwio, compute_dtype=cd)
        a = cube_window_attn(qkv, self.qkv.b, self.table, self.heads, WINDOW, shift,
                             use_cube_pad)
        out = layers.conv2d(a, self.proj.hwio, compute_dtype=cd)
        x = conv_epilogue(out, None, None, self.proj.b, x)  # f32, as x
        h = layers.conv_bn(self.norm2(x), self.fc1, None, 1, cd, act="gelu")
        out = layers.conv2d(h, self.fc2.hwio, compute_dtype=cd)
        return conv_epilogue(out, None, None, self.fc2.b, x)


class Merge(nn.Module):
    """Patch merging: [N*6, S, S, C] f32 -> [N*6, S/2, S/2, 2C] f32."""

    def __init__(self, p: dict, compute_dtype: torch.dtype):
        super().__init__()
        self.norm = Norm(p["ln_w"], p["ln_b"], LN_EPS, torch.float32, compute_dtype)
        self.reduction = Conv(p["w"])

    def forward(self, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        n, s, _, c = x.shape
        # channel block 2 * dc + dr holds x[dr::2, dc::2]: the published order
        x = x.reshape(n, s // 2, 2, s // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
        x = x.reshape(n, s // 2, s // 2, 4 * c)
        return layers.conv2d(self.norm(x), self.reduction.hwio, compute_dtype=cd).float()


class SwinTransformer(nn.Module):
    """``forward(x)`` takes [N, 6, H, W, 3] or [N*6, H, W, 3] faces and
    returns (logits [N*6, K] or None, CAM features [N*6, h, w, C]: the
    head's LayerNorm at each position of the last stage)."""

    def __init__(self, params: dict, use_cube_pad: bool, compute_dtype: torch.dtype):
        super().__init__()
        self.use_cube_pad = use_cube_pad
        self.compute_dtype = compute_dtype
        stem = params["stem"]
        self.stem = Conv(stem["w"], stem["b"])
        self.stem_norm = Norm(stem["ln_w"], stem["ln_b"], LN_EPS)
        self.merges = nn.ModuleList([Merge(m, compute_dtype) for m in params["merges"]])
        self.stages = nn.ModuleList([nn.ModuleList([Block(b, compute_dtype) for b in stage])
                                     for stage in params["stages"]])
        self.head_norm = Norm(params["head"]["ln_w"], params["head"]["ln_b"], LN_EPS,
                              torch.float32, compute_dtype)
        self.register_buffer("cam_w", params["fc_w"])  # [C, K] f32
        self.register_buffer("cam_b", params["fc_b"])
        self.depths = tuple(len(s) for s in params["stages"])
        self.heads = tuple(s[0].heads for s in self.stages)
        self.embed = int(stem["w"].shape[0])
        self.arch = arch_name(self.embed, self.depths, self.heads)

    def forward(self, x: torch.Tensor, with_logits: bool = True
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        if x.ndim == 5:
            x = x.reshape(-1, *x.shape[2:])
        cd, cp = self.compute_dtype, self.use_cube_pad
        grids = stage_grids(x.shape[1])
        out = layers.patch_embed(x, self.stem, self.stem_norm, PATCH, cd)  # the f32 stream
        for si, (stage, (_, shifts)) in enumerate(zip(self.stages, grids)):
            if si:
                out = self.merges[si - 1](out, cd)
            for bi, blk in enumerate(stage):
                out = blk(out, shifts and bi % 2 == 1, cp, cd)
        feats = self.head_norm(out)
        if not with_logits:
            return None, feats
        pooled = feats.float().mean(dim=(1, 2))
        return layers.linear(pooled, {"w": self.cam_w, "b": self.cam_b}), feats
