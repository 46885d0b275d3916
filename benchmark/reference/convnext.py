"""The cube-padded ConvNeXt backbone and its CAM in plain PyTorch, float32,
TF32 off (``model.exact_f32()``).

ConvNeXt is Liu et al., "A ConvNet for the 2020s" (arXiv 2201.03545), with
the settings of facebookresearch/ConvNeXt ``models/convnext.py``
(``convnext_base``: depths 3-3-27-3, widths 128-1024):

- stem: a 4x4 stride-4 conv 3 -> C0 with its bias, then a LayerNorm over
  channels (eps 1e-6);
- stages 2-4 entered through a LayerNorm and a 2x2 stride-2 conv with its
  bias;
- block: ``x + gamma * (W2 @ GELU(W1 @ LN(dw7x7(x) + b_dw) + b1) + b2)``,
  the depthwise 7x7 at padding 3, W1 C -> 4C and W2 4C -> C per position,
  GELU the exact erf form, gamma the layer scale; drop path is the
  identity at inference;
- head: the global mean, a LayerNorm and the classifier.

CP-360 (arXiv 1806.01320) runs a backbone on each cube face, every padded
conv cube-padded (``model.cube_pad``).  Here that is the depthwise 7x7, the
one conv that pads, padded by 3 from the neighbouring faces; the stem and
the downsampling convs tile each face exactly.  The CAM is
``model.cam_scores`` of the last stage's features.

Departures from the published description:

- The CAM's features are the head's LayerNorm applied at each position of
  the last stage's map.  The published head normalises the pooled
  features; LayerNorm is not linear, so the CAM's mean over positions is
  not exactly the logits.
- Every weight is random from a seed (``benchmark/lib/weights_convnext.py``):
  kernels and the classifier normal with std 0.02, biases normal with std
  0.05, LayerNorms at scale 1 and shift 0.
- The layer scale gamma is uniform in [0.1, 0.5], not the published 1e-6
  init, which would leave each block a millionth of its branch.

Weights come in the benchmark's layout (``lib/weights_convnext.py``).
``quant`` rounds what the program holds in its working precision, as
``model.conv`` does: each conv's operands and output, each LayerNorm's
output and each block's sum.  It imports nothing of the program under
test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.model import (IMAGENET_MEAN, IMAGENET_STD, Quant, _q, cam_scores,
                                       conv, cube_pad, equi_to_cube)

LN_EPS = 1e-6
DW_PAD = 3


def layer_norm(x: torch.Tensor, p: dict, quant: Quant = None) -> torch.Tensor:
    """LayerNorm over the channels (the last axis) with ``p``'s ln_w,
    ln_b."""
    out = F.layer_norm(x, (x.shape[-1],), p["ln_w"].float(), p["ln_b"].float(), LN_EPS)
    return _q(quant, out)


def dwconv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, quant: Quant = None,
           use_cube_pad: bool = True) -> torch.Tensor:
    """The depthwise 7x7 with its bias on [N, 6, S, S, C] cubes, padded by 3
    from the neighbouring faces (or with zeros)."""
    n, six, s, _, c = x.shape
    if use_cube_pad:
        xp = cube_pad(x, DW_PAD)
    else:
        xp = F.pad(x, (0, 0, DW_PAD, DW_PAD, DW_PAD, DW_PAD))
    xc = xp.reshape(n * six, s + 2 * DW_PAD, s + 2 * DW_PAD, c).permute(0, 3, 1, 2)
    out = F.conv2d(_q(quant, xc), _q(quant, w.float()[:, None]), groups=c)
    out = out.permute(0, 2, 3, 1) + b.float()
    return _q(quant, out.reshape(n, six, s, s, c))


def convnext_block(p: dict, x: torch.Tensor, quant: Quant = None,
                   use_cube_pad: bool = True) -> torch.Tensor:
    y = layer_norm(dwconv(x, p["dw_w"], p["dw_b"], quant, use_cube_pad), p, quant)
    h = _q(quant, F.gelu(conv(y, p["w1"], 1, 0, quant, p["b1"])))
    out = conv(h, p["w2"], 1, 0, quant, p["b2"])
    return _q(quant, x + p["gamma"].float() * out)


def convnext_trunk(bb: dict, faces01: torch.Tensor, quant: Quant = None,
                   use_cube_pad: bool = True) -> torch.Tensor:
    """Cube faces [N, 6, S, S, 3] in [0, 1] -> the last stage's map
    [N, 6, S/32, S/32, C]."""
    mean = torch.tensor(IMAGENET_MEAN, device=faces01.device)
    std = torch.tensor(IMAGENET_STD, device=faces01.device)
    x = (faces01 - mean) / std
    stem = bb["stem"]
    x = layer_norm(conv(x, stem["w"], 4, 0, quant, stem["b"]), stem, quant)
    for si, stage in enumerate(bb["stages"]):
        if si:
            d = bb["downsample"][si - 1]
            x = conv(layer_norm(x, d, quant), d["w"], 2, 0, quant, d["b"])
        for p in stage:
            x = convnext_block(p, x, quant, use_cube_pad)
    return x


def convnext_features(bb: dict, faces01: torch.Tensor, quant: Quant = None,
                      use_cube_pad: bool = True) -> torch.Tensor:
    """Cube faces -> the CAM's features: the head's LayerNorm at each
    position of the last stage's map."""
    return layer_norm(convnext_trunk(bb, faces01, quant, use_cube_pad), bb["head"], quant)


def logits(bb: dict, faces01: torch.Tensor) -> torch.Tensor:
    """The published head: [N, 6, K] from the pooled, normalised features."""
    pooled = layer_norm(convnext_trunk(bb, faces01).mean(dim=(2, 3)), bb["head"])
    return pooled @ bb["fc_w"].float() + bb["fc_b"].float()


def frames_to_scores(bb: dict, frames_u8: torch.Tensor, face_w: int, quant: Quant = None,
                     block: int = 8) -> torch.Tensor:
    """Decoded frames [N, H, 2H, 3] u8 -> CAM cubes [N, 6, h, w, K] f32, in
    blocks of ``block`` frames."""
    out = []
    for i in range(0, frames_u8.shape[0], block):
        faces = equi_to_cube(frames_u8[i:i + block], face_w) / 255.0
        out.append(cam_scores(bb, convnext_features(bb, faces, quant), quant))
    return torch.cat(out)
