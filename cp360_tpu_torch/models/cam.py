"""Class Activation Mapping head (``cp360_tpu/models/cam.py:20-74``).

The reference (static_model/class_activation_model.py:13-85) captures
layer4 through a forward hook and multiplies it on the host with the
non-negative shifted classifier weight per face.  Here the ResNet returns
its feature map and the score cube is one f32 matmul on the device.
"""

from __future__ import annotations

import torch

from cp360_tpu_torch.models.resnet import ResNet


def shift_weight_nonneg(fc_w: torch.Tensor) -> torch.Tensor:
    """Shift the classifier weight so its minimum is >= 0.

    Reference: class_activation_model.py:51-52 — applied only when the min
    is negative, which the unconditional `w - min(min, 0)` reproduces.
    """
    return fc_w - torch.clamp(fc_w.min(), max=0.0)


def cam_scores(feats: torch.Tensor, fc_w: torch.Tensor) -> torch.Tensor:
    """Per-face class score maps.

    Args:
      feats: [B, h, w, C] layer4 features (B = N*6 faces).
      fc_w: [C, num_classes] classifier weight.

    Returns [B, h, w, num_classes] f32 score maps.
    """
    w = shift_weight_nonneg(fc_w.float())
    return torch.matmul(feats.float(), w)


def cam_forward(model: ResNet, cubes: torch.Tensor):
    """Cube faces -> (score cube, features).

    Args:
      cubes: [N, 6, H, W, 3] normalized cube faces.

    Returns:
      scores: [N, 6, h, w, num_classes] CAM score cube (f32).
      feats:  [N, 6, h, w, C] layer4 features.
    """
    n = cubes.shape[0]
    _, feats = model(cubes, with_logits=False)
    scores = cam_scores(feats, model.fc_w)
    h, w = feats.shape[1:3]
    return scores.reshape(n, 6, h, w, -1), feats.reshape(n, 6, h, w, -1)
