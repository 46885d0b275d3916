"""Equirectangular <-> cubemap sampling-map builders (host-side, NumPy).

These produce, once per resolution, the float sampling coordinates that the
runtime resamplers (cp360_tpu_torch/ops/resample.py and the equi->cube
kernel in ops/equi_gather.py) consume.  The math
mirrors the reference precompute exactly — including its documented quirks —
because the released checkpoint's accuracy numbers depend on these maps:

- equi->cube: reference utils/equi_to_cube.py:11-110.  Per-face perspective
  rays with 90° vfov, rotated by the face view, converted to equirectangular
  pixel coordinates through piecewise-linear acos/atan lookup tables, then a
  (+1) pixel offset and [1, size-1] clamping — both reference quirks we keep
  for artifact parity.
- cube->equi: reference utils/cube_to_equi.py:11-35.  For every output pixel
  a face id and float in-face coordinates in [0, w-1].
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from cp360_tpu_torch.geometry import sph

# Face view angles in degrees: (yaw, pitch, roll), order B D F L R T.
# Reference: utils/equi_to_cube.py:17-22.
_VIEWS_DEG = np.array(
    [
        [180.0, 0.0, 0.0],  # back
        [0.0, -90.0, 0.0],  # down
        [0.0, 0.0, 0.0],  # front
        [-90.0, 0.0, 0.0],  # left
        [90.0, 0.0, 0.0],  # right
        [0.0, 90.0, 0.0],  # top
    ]
)


@lru_cache(maxsize=8)
def build_equi2cube_maps(face_w: int, in_h: int, in_w: int, vfov_deg: float = 90.0):
    """Sampling maps for equirectangular -> 6 cube faces.

    Returns float64 arrays ``in_x, in_y`` of shape [6, face_w, face_w]: for
    each face pixel, the (column, row) float coordinates in the input
    equirectangular image at which to bilinearly sample.

    Coordinates include the reference's +1 pixel offset and are clamped to
    [1, size-1] (utils/equi_to_cube.py:100-108).
    """
    if in_h * 2 != in_w:
        raise ValueError(f"equi input must be Hx2H, got {in_h}x{in_w}")

    vfov = np.deg2rad(vfov_deg)
    views = np.deg2rad(_VIEWS_DEG)
    ow = oh = face_w

    top_left = np.array([-np.tan(vfov / 2) * (ow / oh), -np.tan(vfov / 2), 1.0])
    uv = np.array([-2 * top_left[0] / ow, -2 * top_left[1] / oh, 0.0])

    # Piecewise-linear inverse trig lookup tables (utils/equi_to_cube.py:49-57).
    res_acos = 2 * in_w
    res_atan = 2 * in_h
    step_acos = np.pi / res_acos
    step_atan = np.pi / res_atan
    lookup_acos = np.append(-np.cos(np.arange(res_acos) * step_acos), 1.0)
    lookup_atan = np.concatenate(
        [
            [np.tan(step_atan / 2 - np.pi / 2)],
            np.tan(np.arange(1, res_atan) * step_atan - np.pi / 2),
            [np.tan(-step_atan / 2 + np.pi / 2)],
        ]
    )
    idx_acos = np.arange(0.0, res_acos + 1)
    idx_atan = np.arange(0.0, res_atan + 1)

    xg, yg = np.meshgrid(np.arange(ow), np.arange(oh))
    xf = xg.flatten()
    yf = yg.flatten()

    in_x = np.zeros((6, oh * ow))
    in_y = np.zeros((6, oh * ow))

    for idx in range(6):
        yaw, pitch, roll = views[idx]
        transform = sph.roty(yaw) @ sph.rotx(pitch) @ sph.rotz(roll)

        points = np.stack(
            [
                top_left[0] + uv[0] * xf,
                top_left[1] + uv[1] * yf,
                np.full(xf.shape, top_left[2]),
            ],
            axis=0,
        )
        moved = transform @ points
        xp, yp, zp = moved[0], moved[1], moved[2]

        nxz = np.sqrt(xp**2 + zp**2)
        phi = np.zeros(xf.shape[0])
        theta = np.zeros(xf.shape[0])

        at_pole = nxz < 10e-10
        phi[at_pole & (yp > 0)] = np.pi / 2
        phi[at_pole & (yp <= 0)] = -np.pi / 2

        ok = ~at_pole
        phi[ok] = np.interp(yp[ok] / nxz[ok], lookup_atan, idx_atan) * step_atan - np.pi / 2
        theta[ok] = np.interp(-zp[ok] / nxz[ok], lookup_acos, idx_acos) * step_acos
        neg = ok & (xp < 0)
        theta[neg] = -theta[neg]

        # Pixel coordinates with the reference's +1 offset and clamping
        # (utils/equi_to_cube.py:100-108).
        ix = (theta / np.pi) * (in_w / 2) + (in_w / 2) + 1
        iy = (phi / (np.pi / 2)) * (in_h / 2) + (in_h / 2) + 1
        ix = np.clip(ix, 1, None)
        ix[ix >= in_w - 1] = in_w - 1
        iy = np.clip(iy, 1, None)
        iy[iy >= in_h - 1] = in_h - 1

        in_x[idx] = ix
        in_y[idx] = iy

    # The reference reshapes with (width, height); faces are square so this
    # equals (height, width) — we assert squareness to keep that identity.
    return in_x.reshape(6, oh, ow), in_y.reshape(6, oh, ow)


@lru_cache(maxsize=8)
def build_cube2equi_map(face_w: int):
    """Sampling map for 6 cube faces -> a (2w x 4w) equirectangular image.

    Returns:
      coords: float64 [2w, 4w, 2] — (x, y) in-face float pixel coordinates
              in [0, w-1] for every output pixel.
      face_map: int64 [2w, 4w] — which face each output pixel samples.

    Mirrors reference utils/cube_to_equi.py:11-35 (including pruned_inf
    epsilon nudging and the get_face overwrite order).
    """
    out_w = face_w * 4
    out_h = face_w * 2

    xx, yy = np.meshgrid(np.arange(out_w), np.arange(out_h))
    theta, phi = sph.xy2angle(xx, yy, out_w, out_h)
    theta = sph.pruned_inf(theta)
    phi = sph.pruned_inf(phi)

    x, y, z = sph.to_3dsphere(theta, phi, 1)
    face_map = sph.get_face(x, y, z)
    x_o, y_o = sph.face_to_cube_coord(face_map, x, y, z)

    coords = np.stack([x_o, y_o], axis=-1)
    coords = sph.norm_to_cube(coords, face_w)
    return coords, face_map
