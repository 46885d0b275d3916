"""Cube-padded ConvNeXt backbone + CAM head (NHWC, PyTorch).

ConvNeXt (Liu et al., "A ConvNet for the 2020s", arXiv 2201.03545; the
settings of facebookresearch/ConvNeXt ``models/convnext.py``) on each cube
face:

- stem: a 4x4 stride-4 conv 3 -> dims[0] with its bias, then a LayerNorm
  over channels;
- four stages of ``depths[i]`` blocks at width ``dims[i]``, each stage after
  the first entered through a LayerNorm and a 2x2 stride-2 conv with its
  bias;
- block: ``x + gamma * (W2 @ GELU(W1 @ LN(dw7x7(x) + b_dw) + b1) + b2)``,
  W1 C -> 4C and W2 4C -> C per position, GELU the exact erf form, gamma
  the per-channel layer scale (drop path is the identity at inference);
- head: the global mean, a LayerNorm and the linear classifier C -> K.

The depthwise 7x7 conv is the only conv that pads, so it is the one that
is cube-padded (by 3); the stem and the downsampling convs tile each face
exactly and take each face alone.  A face must hold the pad at every stage
(stage 4 is S/32 wide: S >= 96).  With ``use_cube_pad`` False the pad is
zeros, as in the other families.

The CAM: the features are the head's LayerNorm applied at each position of
the last stage's map, and the CAM is ``models/cam.py::cam_scores`` of them,
as for every family.  The logits normalise the pooled features instead;
LayerNorm is not linear, so the mean of the CAM over positions is not
exactly the logits (the other families' CAMs average to theirs).

Numerics: the residual stream (the stem's output and every block's sum)
is held in f32, and everything the blocks compute from it in the compute
dtype (bf16 on the main path).  The depthwise conv is
``ops/cube_dwconv.py`` (the hand-written kernel on the card), which reads
the f32 stream and writes its sum and bias rounded once to the compute
dtype; each LayerNorm is ``F.layer_norm`` over the channels, computed in
f32 inside the op and rounded once to the compute dtype (the block's from
the depthwise conv's output, the downsampling convs' and the head's from
the f32 stream); W1, W2 and the patchify convs are convs through
``models/layers.py::conv2d`` (cuDNN) whose bias, GELU, layer scale and
residual run in one epilogue pass (``ops/conv_epilogue.py``: W1 takes b1
and GELU, W2 ``(y + b2) * gamma + x`` with x and the result in f32).
Why f32: rounded to bf16, the 36 sums of the stream carry an error that
the CAM window's min/max normalisation scales up on flat maps.  On the
card, against the float32 reference at ConvNeXt-B's widths on 224 faces
(24 maps of one seed of the benchmark's ``convnextb-stream``), the
reference with every value rounded to bf16, the stream's sums included,
read a largest map gap of 0.121 of the map's range; with the stream kept
in f32 and every other value rounded, 0.023.

gamma stays in the epilogue, not folded into W2 as
``models/layers.py::fold`` folds a batch norm's scale: the pass runs
anyway for b2 and the residual, so folding saves one f32 multiply a
value, and it would cost a pass over W2 at every forward (a fold made
once, at construction, would not see gamma changed in place).  Nor does
it change the precision: on the CPU, at the published widths and cut
depths on 96 px faces (``tests/test_torch_convnext.py``), with the stream
in bf16, the bf16 CAMs read 0.0109-0.0156 of their largest magnitude from
the f32 reference with gamma in the epilogue and 0.0102-0.0165 with
``W2 * gamma`` rounded once to bf16, over three seeds.

Parameters (:class:`ConvNeXt`'s ``params``; ``compat/convnext_params.py``
makes them from a numpy tree): conv kernels OIHW in the compute dtype with
channels-last storage (``stem.w`` [C0, 3, 4, 4], ``downsample[i].w``, each
block's ``w1`` [4C, C, 1, 1] and ``w2`` [C, 4C, 1, 1]), each block's
``dw_w`` [C, 7, 7] over [7, 7, C] storage, LayerNorm scales and shifts
(``ln_w``, ``ln_b``) in the compute dtype, biases (``b``, ``dw_b``, ``b1``,
``b2``), ``gamma`` and the classifier ``fc_w`` [C, K], ``fc_b`` in f32.
The module holds ``dw_w`` and the scales and shifts of the LayerNorms that
read the residual stream (the downsampling convs' and the head's) widened
to f32, the stream's dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cp360_tpu_torch.models import layers
from cp360_tpu_torch.models.layers import Conv
from cp360_tpu_torch.ops.conv_epilogue import conv_epilogue
from cp360_tpu_torch.ops.cube_dwconv import cube_dwconv

# (depths, dims) of the published models (facebookresearch/ConvNeXt)
ARCHS = {
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
}
LN_EPS = 1e-6
STEM = 4  # the stem's kernel and stride
DOWN = 2  # each downsampling conv's kernel and stride


def arch_name(depths: Sequence[int], dims: Sequence[int]) -> str:
    """The published name of (depths, dims), or "convnext" for another."""
    for name, (d, w) in ARCHS.items():
        if tuple(depths) == d and tuple(dims) == w:
            return name
    return "convnext"


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last (channel) axis, eps 1e-6: computed in f32
    inside ``F.layer_norm`` and rounded once to x's dtype."""
    return F.layer_norm(x, (x.shape[-1],), w, b, LN_EPS)


class _Norm(nn.Module):
    """A LayerNorm whose scale and shift are held in ``dtype`` (their own by
    default), the dtype of its input, and whose output is rounded to
    ``out_dtype`` (the input's by default)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor, dtype: Optional[torch.dtype] = None,
                 out_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.register_buffer("w", w if dtype is None else w.to(dtype))
        self.register_buffer("b", b if dtype is None else b.to(dtype))
        self.out_dtype = out_dtype

    def forward(self, x):
        y = layer_norm(x, self.w, self.b)
        return y if self.out_dtype is None else y.to(self.out_dtype)


class Block(nn.Module):
    """One ConvNeXt block on a face batch [N*6, S, S, C] of the f32
    residual stream."""

    def __init__(self, p: dict):
        super().__init__()
        # [C, 7, 7] in f32, the stream's dtype, over [7, 7, C] storage (exact: a widening)
        self.register_buffer("dw_w", p["dw_w"].float())
        self.register_buffer("dw_b", p["dw_b"])
        self.norm = _Norm(p["ln_w"], p["ln_b"])
        self.pw1 = Conv(p["w1"], p["b1"])
        self.pw2 = Conv(p["w2"], p["b2"])
        self.register_buffer("gamma", p["gamma"])

    def forward(self, x: torch.Tensor, use_cube_pad: bool, cd: torch.dtype) -> torch.Tensor:
        y = self.norm(cube_dwconv(x, self.dw_w, self.dw_b, use_cube_pad, out_dtype=cd))
        h = layers.conv_bn(y, self.pw1, None, 1, cd, act="gelu")
        out = layers.conv2d(h, self.pw2.hwio, compute_dtype=cd)
        return conv_epilogue(out, None, self.gamma, self.pw2.b, x)  # f32, as x


class ConvNeXt(nn.Module):
    """``forward(x)`` takes [N, 6, H, W, 3] or [N*6, H, W, 3] faces and
    returns (logits [N*6, K] or None, CAM features [N*6, h, w, C]: the
    head's LayerNorm at each position of the last stage)."""

    def __init__(self, params: dict, use_cube_pad: bool, compute_dtype: torch.dtype):
        super().__init__()
        self.use_cube_pad = use_cube_pad
        self.compute_dtype = compute_dtype
        stem = params["stem"]
        self.stem = Conv(stem["w"], stem["b"])
        self.stem_norm = _Norm(stem["ln_w"], stem["ln_b"])
        self.downs = nn.ModuleList([Conv(d["w"], d["b"]) for d in params["downsample"]])
        # the norms that read the f32 stream: theirs in f32, their outputs in the compute dtype
        self.down_norms = nn.ModuleList([_Norm(d["ln_w"], d["ln_b"], torch.float32,
                                               compute_dtype) for d in params["downsample"]])
        self.stages = nn.ModuleList([nn.ModuleList([Block(b) for b in stage])
                                     for stage in params["stages"]])
        self.head_norm = _Norm(params["head"]["ln_w"], params["head"]["ln_b"], torch.float32,
                               compute_dtype)
        self.register_buffer("cam_w", params["fc_w"])  # [C, K] f32
        self.register_buffer("cam_b", params["fc_b"])
        self.depths = tuple(len(s) for s in params["stages"])
        self.dims = tuple(int(s[0]["dw_w"].shape[0]) for s in params["stages"])
        self.arch = arch_name(self.depths, self.dims)

    def forward(self, x: torch.Tensor, with_logits: bool = True
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        if x.ndim == 5:
            x = x.reshape(-1, *x.shape[2:])
        cd, cp = self.compute_dtype, self.use_cube_pad
        out = layers.conv_bn(x.to(cd), self.stem, None, STEM, cd)
        out = self.stem_norm(out).float()  # the residual stream: f32
        for si, stage in enumerate(self.stages):
            if si:
                out = self.down_norms[si - 1](out)
                out = layers.conv_bn(out, self.downs[si - 1], None, DOWN, cd).float()
            for blk in stage:
                out = blk(out, cp, cd)
        feats = self.head_norm(out)
        if not with_logits:
            return None, feats
        pooled = self.head_norm(out.mean(dim=(1, 2)))
        return layers.linear(pooled, {"w": self.cam_w, "b": self.cam_b}), feats
