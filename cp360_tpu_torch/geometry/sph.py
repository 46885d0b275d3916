"""Spherical / cubemap coordinate math (host-side precompute, pure NumPy).

Everything here runs once per resolution on the host to build gather maps;
nothing in this module touches torch.  Semantics mirror the reference
implementation (reference: utils/sph_utils.py:15-153) so that the released
checkpoint's numbers are reproducible, but the code is an independent
derivation.

Face order convention (shared with the on-disk artifacts of the reference,
reference: utils/sph_utils.py:15-20 and model/cube_pad.py:49):

    0 = B (back),  1 = D (down/bottom), 2 = F (front),
    3 = L (left),  4 = R (right),       5 = T (top)

World frame: x toward the front face, y up, z toward the right face.
Equirectangular images are H x 2H with longitude theta in [-pi, pi] mapped
across the width and latitude phi in [-pi/2, pi/2] down the height.
"""

from __future__ import annotations

import numpy as np

FACE_B = 0
FACE_D = 1
FACE_F = 2
FACE_L = 3
FACE_R = 4
FACE_T = 5
FACE_NAMES = ("back", "down", "front", "left", "right", "top")

_FLOAT_ERR = 10e-9  # same epsilon the reference uses (utils/sph_utils.py:71)


def rotx(ang: float) -> np.ndarray:
    """Rotation about the +x axis by `ang` radians."""
    c, s = np.cos(ang), np.sin(ang)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def roty(ang: float) -> np.ndarray:
    """Rotation about the +y axis by `ang` radians."""
    c, s = np.cos(ang), np.sin(ang)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def rotz(ang: float) -> np.ndarray:
    """Rotation about the +z axis by `ang` radians."""
    c, s = np.cos(ang), np.sin(ang)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def rotation_matrix(axis, theta: float) -> np.ndarray:
    """Axis-angle rotation matrix (Rodrigues via quaternion components).

    Matches reference utils/sph_utils.py:41-50.
    """
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.sqrt(axis @ axis)
    a = np.cos(theta / 2.0)
    b, c, d = -axis * np.sin(theta / 2.0)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    return np.array(
        [
            [aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)],
            [2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)],
            [2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc],
        ]
    )


def xy2angle(xx: np.ndarray, yy: np.ndarray, im_w: int, im_h: int):
    """Equirectangular pixel grid -> (theta, phi) at pixel centers.

    theta in (-pi, pi) across the width, phi in (-pi/2, pi/2) with +phi at
    the top row.  Matches reference utils/sph_utils.py:53-60.
    """
    nx = 2.0 * (xx + 0.5) / float(im_w) - 1.0
    ny = 1.0 - 2.0 * (yy + 0.5) / float(im_h)
    return nx * np.pi, ny * np.pi / 2.0


def to_3dsphere(theta: np.ndarray, phi: np.ndarray, radius: float):
    """(theta, phi) -> unit-sphere xyz (x front, y up, z right).

    Matches reference utils/sph_utils.py:63-67.
    """
    x = radius * np.cos(phi) * np.cos(theta)
    y = radius * np.sin(phi)
    z = radius * np.cos(phi) * np.sin(theta)
    return x, y, z


def pruned_inf(angle: np.ndarray) -> np.ndarray:
    """Nudge exactly-singular angles off the poles/seams by a tiny epsilon.

    Prevents divide-by-zero in the face projection.  Matches reference
    utils/sph_utils.py:70-77 (mutating semantics preserved by returning the
    modified copy).
    """
    angle = np.array(angle, copy=True)
    angle[angle == 0.0] = _FLOAT_ERR
    angle[angle == np.pi] = np.pi - _FLOAT_ERR
    angle[angle == -np.pi] = -np.pi + _FLOAT_ERR
    angle[angle == np.pi / 2] = np.pi / 2 - _FLOAT_ERR
    angle[angle == -np.pi / 2] = -np.pi / 2 + _FLOAT_ERR
    return angle


def get_face(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Assign each sphere point to the cube face with the largest |coord|.

    NOTE: the reference computes ``np.maximum(np.abs(x), np.abs(y), np.abs(z))``
    (utils/sph_utils.py:91) which is a *two*-argument maximum with `abs(z)`
    silently used as the out= buffer — i.e. max_arr = max(|x|, |y|) written
    into |z|'s storage.  Later assignment order means z-faces win ties last.
    We reproduce the *resulting* face map exactly by mirroring that argmax
    and the overwrite order (utils/sph_utils.py:97-102): each later
    assignment overwrites earlier ones.
    """
    eps = _FLOAT_ERR
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    # Reference quirk: max over |x|,|y| only (third arg of np.maximum is out=).
    max_arr = np.maximum(ax, ay)

    x_faces = (max_arr - ax) < eps
    y_faces = (max_arr - ay) < eps
    z_faces = (max_arr - az) < eps

    face_map = np.zeros(np.shape(x), dtype=np.int64)
    face_map[(x >= 0) & x_faces] = FACE_F
    face_map[(x <= 0) & x_faces] = FACE_B
    face_map[(y >= 0) & y_faces] = FACE_T
    face_map[(y <= 0) & y_faces] = FACE_D
    face_map[(z >= 0) & z_faces] = FACE_R
    face_map[(z <= 0) & z_faces] = FACE_L
    return face_map


def face_to_cube_coord(face_map: np.ndarray, x, y, z):
    """Project sphere points onto their assigned face, in [0,1]^2 face coords.

    Returns (x_oncube, y_oncube) with top-left origin on each face.
    Matches reference utils/sph_utils.py:114-146.
    """
    u = np.zeros(face_map.shape, dtype=np.float64)  # in-plane horizontal
    v = np.zeros(face_map.shape, dtype=np.float64)  # in-plane vertical (up +)
    w = np.zeros(face_map.shape, dtype=np.float64)  # axis toward the face

    sel = face_map == FACE_F
    u[sel], v[sel], w[sel] = z[sel], y[sel], x[sel]
    sel = face_map == FACE_B
    u[sel], v[sel], w[sel] = -z[sel], y[sel], x[sel]
    sel = face_map == FACE_T
    u[sel], v[sel], w[sel] = z[sel], -x[sel], y[sel]
    sel = face_map == FACE_D
    u[sel], v[sel], w[sel] = z[sel], x[sel], y[sel]
    sel = face_map == FACE_R
    u[sel], v[sel], w[sel] = -x[sel], y[sel], z[sel]
    sel = face_map == FACE_L
    u[sel], v[sel], w[sel] = x[sel], y[sel], z[sel]

    x_oncube = (u / np.abs(w) + 1.0) / 2.0
    y_oncube = (-v / np.abs(w) + 1.0) / 2.0
    return x_oncube, y_oncube


def norm_to_cube(coord01: np.ndarray, w: int) -> np.ndarray:
    """[0,1] face coordinates -> [0, w-1] pixel coordinates, clamped.

    Matches reference utils/sph_utils.py:149-153.
    """
    out = coord01 * (w - 1)
    return np.clip(out, 0.0, w - 1)
