"""The cube-padded VGG16-BN backbone and its CAM in plain PyTorch, float32,
TF32 off (``model.exact_f32()``).

The trunk is configuration "D" of Simonyan & Zisserman (arXiv 1409.1556)
with a batch norm after each conv, as torchvision's ``vgg16_bn``: 13 3x3
convs of widths 64-512, each with its bias, then batch norm and ReLU, and
a 2x2 stride-2 max pool after the 2nd, 4th, 7th, 10th and 13th.  CP-360
(arXiv 1806.01320) runs it on each cube face: every conv is preceded by a
cube pad of 1 and run VALID; a pool takes each face alone (224 faces ->
7x7x512).  Then the CAM head: ``camconv``, a cube-padded 3x3 conv to
1024 channels with bias and ReLU, and the class activation map through
the classifier's [1024, K] weight, shifted non-negative
(``model.cam_scores``).

Departures from the published description:

- The 1024-wide ``camconv`` head is the repository's reading of the
  reference code's commented-out call ``CAM('camconv',
  'classifier.weight')`` (static_model/dataset_feat_extractor.py:50-52,
  164-167), not a published checkpoint: the paper gives no width.
- Batch norms are at identity statistics (mean 0, variance 1), and every
  weight is random from a seed (``benchmark/lib/weights_vgg16.py``).

Weights come in the benchmark's layout: ``features``, 13 {w: OIHW kernel,
b: [C], bn: {scale, bias, mean, var}}; ``camconv`` {w, b}; ``fc_w``
[C, K], ``fc_b``.  ``quant`` rounds what the program holds in its working
precision, as ``model.conv`` and ``model.cam_scores`` do.  It imports
nothing of the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.model import (IMAGENET_MEAN, IMAGENET_STD, Quant, batch_norm,
                                       cam_scores, conv, equi_to_cube)

POOL_AFTER = (1, 3, 6, 9, 12)  # indices of the convs a 2x2/s2 max pool follows


def max_pool_2x2s2(x: torch.Tensor) -> torch.Tensor:
    """[N, 6, h, h, C] -> [N, 6, h/2, h/2, C], each face alone."""
    n, six, h, w, c = x.shape
    out = F.max_pool2d(x.reshape(n * six, h, w, c).permute(0, 3, 1, 2), 2, 2)
    return out.permute(0, 2, 3, 1).reshape(n, six, h // 2, w // 2, c)


def vgg16_features(bb: dict, faces01: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """Cube faces [N, 6, 224, 224, 3] in [0, 1] -> ``camconv`` features
    [N, 6, 7, 7, 1024]."""
    mean = torch.tensor(IMAGENET_MEAN, device=faces01.device)
    std = torch.tensor(IMAGENET_STD, device=faces01.device)
    x = (faces01 - mean) / std
    for i, layer in enumerate(bb["features"]):
        x = torch.relu(batch_norm(conv(x, layer["w"], 1, 1, quant, layer["b"]), layer["bn"]))
        if i in POOL_AFTER:
            x = max_pool_2x2s2(x)
    return torch.relu(conv(x, bb["camconv"]["w"], 1, 1, quant, bb["camconv"]["b"]))


def frames_to_scores(bb: dict, frames_u8: torch.Tensor, face_w: int, quant: Quant = None,
                     block: int = 8) -> torch.Tensor:
    """Decoded frames [N, H, 2H, 3] u8 -> CAM cubes [N, 6, h, w, K] f32, in
    blocks of ``block`` frames."""
    out = []
    for i in range(0, frames_u8.shape[0], block):
        faces = equi_to_cube(frames_u8[i:i + block], face_w) / 255.0
        out.append(cam_scores(bb, vgg16_features(bb, faces, quant), quant))
    return torch.cat(out)
