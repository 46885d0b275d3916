"""Stage-1 device steps: frame -> CAM cube + equirectangular saliency.

The counterparts of ``cp360_tpu/pipelines/extract.py::stage1_batch`` (:288,
the all-device step from u8 equirectangular frames) and
``stage1_batch_faces`` (:40, from faces sampled on the host).  Everything
between the decoded frame and the saliency map runs on the device:
equi->cube (the hand kernel of ops/equi_gather.py, with the /255 fused),
ImageNet normalization, the cube-padded ResNet CAM, cube->equi and the
squared channel max (dataset_feat_extractor.py:173-176).

:func:`host_equi_to_cube_u8` is the host remap of ``host_cube_remap: true``
(cv2, imported when called).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from cp360_tpu_torch.geometry import build_equi2cube_maps
from cp360_tpu_torch.models.cam import cam_forward
from cp360_tpu_torch.models.resnet import ResNet
from cp360_tpu_torch.ops import equi_gather
from cp360_tpu_torch.ops.resample import cube_to_equi

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _cam_and_saliency(model: ResNet, cubes01: torch.Tensor, out_dtype: torch.dtype):
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=cubes01.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=cubes01.device)
    cubes = (cubes01 - mean) / std
    scores, _ = cam_forward(model, cubes)
    equi_scores = cube_to_equi(scores)  # [N, 2h, 4w, K]
    sal = torch.amax(equi_scores, dim=-1) ** 2
    return scores.to(out_dtype), sal


def stage1_batch(model: ResNet, frames_u8: torch.Tensor, cube_dim: int = 224,
                 out_dtype: torch.dtype = torch.float32):
    """Device step for a batch of frames: u8 equi -> (CAM, saliency).

    Args:
      frames_u8: [N, H, 2H, 3] uint8 frames (the decoded, resized image; /255
        happens on the device, in f32, before sampling).

    Returns:
      scores: [N, 6, h, w, K] CAM score cubes in ``out_dtype`` (NHWC).
      sal:    [N, 2h, 4w] f32 equi saliency (channel max of the projected
              scores, squared).
    """
    cubes01 = equi_gather.equi_to_cube(frames_u8, cube_dim)  # [N, 6, cd, cd, 3]
    return _cam_and_saliency(model, cubes01, out_dtype)


def stage1_batch_faces(model: ResNet, faces_u8: torch.Tensor,
                       out_dtype: torch.dtype = torch.float16):
    """Device step from cube faces sampled on the host.

    Args:
      faces_u8: [N, 6, cd, cd, 3] uint8 cube faces (:func:`host_equi_to_cube_u8`).

    Returns (scores [N, 6, h, w, K] ``out_dtype``, sal [N, 2h, 4w] f32).
    """
    return _cam_and_saliency(model, faces_u8.float() / 255.0, out_dtype)


@lru_cache(maxsize=8)
def _equi2cube_maps_f32(cube_dim: int, h: int, w: int):
    in_x, in_y = build_equi2cube_maps(cube_dim, h, w)
    return (np.ascontiguousarray(in_x.astype(np.float32)),
            np.ascontiguousarray(in_y.astype(np.float32)))


def host_equi_to_cube_u8(frame_u8: np.ndarray, cube_dim: int) -> np.ndarray:
    """Host-side equi->cube of one [H, 2H, 3] u8 frame via cv2.remap (the
    same sampling maps as the device path; u8 output)."""
    import cv2

    h, w = frame_u8.shape[:2]
    in_x, in_y = _equi2cube_maps_f32(cube_dim, h, w)
    faces = np.empty((6, cube_dim, cube_dim, 3), np.uint8)
    for f in range(6):
        faces[f] = cv2.remap(frame_u8, in_x[f], in_y[f], cv2.INTER_LINEAR)
    return faces
