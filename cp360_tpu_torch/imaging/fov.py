"""Normal-field-of-view (NFoV) rendering and FoV outlines on equi frames.

The port of ``cp360_tpu/imaging/fov.py`` (a working form of the
reference's figure tool utils/fov_visual.py, which does not run as
shipped).  Host numpy, as in the JAX package: an offline visualisation
tool, not a device path, and no entry point calls it.  The spherical math
is the port's own ``geometry/sph.py``.
"""

from __future__ import annotations

import numpy as np

from cp360_tpu_torch.geometry import sph
from cp360_tpu_torch.ops.resample import remap_bilinear_numpy


def nfov_sample_coords(yaw: float, pitch: float, fov_deg: float, out_h: int, out_w: int,
                       equi_h: int, equi_w: int):
    """Equi pixel coordinates sampled by a perspective camera.

    Args:
      yaw: camera longitude (radians, + toward the right face).
      pitch: camera latitude (radians, + up).
      fov_deg: vertical field of view in degrees.

    Returns (xs, ys): float maps [out_h, out_w] into the equi image.
    """
    half = np.tan(np.deg2rad(fov_deg) / 2.0)
    xs = np.linspace(-half * out_w / out_h, half * out_w / out_h, out_w)
    ys = np.linspace(-half, half, out_h)
    gx, gy = np.meshgrid(xs, ys)

    # camera rays: x forward, y up, z right (the frame of sph.to_3dsphere);
    # roty(+a) turns toward -z, so yaw is negated for "+yaw looks right"
    rays = np.stack([np.ones_like(gx), -gy, gx], axis=-1)
    rot = sph.roty(-yaw) @ sph.rotz(pitch)
    r = rays @ rot.T

    theta = np.arctan2(r[..., 2], r[..., 0])
    phi = np.arcsin(np.clip(r[..., 1] / np.linalg.norm(r, axis=-1), -1, 1))

    # the inverse of sph.xy2angle's pixel-centre mapping
    xs_pix = (theta / np.pi + 1.0) * equi_w / 2.0 - 0.5
    ys_pix = (1.0 - 2.0 * phi / np.pi) * equi_h / 2.0 - 0.5
    return np.clip(xs_pix, 0, equi_w - 1), np.clip(ys_pix, 0, equi_h - 1)


def nfov_render(equi_img: np.ndarray, yaw: float, pitch: float, fov_deg: float = 65.5,
                out_h: int = 360, out_w: int = 640) -> np.ndarray:
    """Render a perspective crop [out_h, out_w, C] (f32) from an
    equirectangular image."""
    h, w = equi_img.shape[:2]
    xs, ys = nfov_sample_coords(yaw, pitch, fov_deg, out_h, out_w, h, w)
    return remap_bilinear_numpy(np.asarray(equi_img, np.float32), xs, ys)


def fov_boundary_mask(yaw: float, pitch: float, fov_deg: float, equi_h: int, equi_w: int,
                      out_h: int = 180, out_w: int = 320, thickness: int = 2) -> np.ndarray:
    """Boolean equi-image mask tracing the FoV's (warped) boundary."""
    xs, ys = nfov_sample_coords(yaw, pitch, fov_deg, out_h, out_w, equi_h, equi_w)
    mask = np.zeros((equi_h, equi_w), bool)
    border_x = np.concatenate([xs[0], xs[-1], xs[:, 0], xs[:, -1]])
    border_y = np.concatenate([ys[0], ys[-1], ys[:, 0], ys[:, -1]])
    xi = np.clip(np.round(border_x).astype(int), 0, equi_w - 1)
    yi = np.clip(np.round(border_y).astype(int), 0, equi_h - 1)
    for dy in range(-thickness, thickness + 1):
        for dx in range(-thickness, thickness + 1):
            mask[np.clip(yi + dy, 0, equi_h - 1), np.clip(xi + dx, 0, equi_w - 1)] = True
    return mask


def draw_fov_box(equi_img: np.ndarray, yaw: float, pitch: float, fov_deg: float = 65.5,
                 color=(255, 0, 0)) -> np.ndarray:
    """An FoV outline drawn on a copy of an equi image."""
    img = np.array(equi_img, copy=True)
    mask = fov_boundary_mask(yaw, pitch, fov_deg, img.shape[0], img.shape[1])
    img[mask] = color
    return img
