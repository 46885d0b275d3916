"""Sampling maps and the cube-pad gather map (NumPy, float64), copied from
the published model's precompute (reference utils/equi_to_cube.py,
utils/cube_to_equi.py, utils/sph_utils.py, model/cube_pad.py), with its
quirks: the +1 pixel offset and clamping of the equi->cube maps, the
two-argument maximum of the face assignment, and corner replication of
the cube pad.  Face order B D F L R T.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

F_B, F_D, F_F, F_L, F_R, F_T = range(6)
_EPS = 10e-9
_VIEWS_DEG = np.array([[180.0, 0.0, 0.0], [0.0, -90.0, 0.0], [0.0, 0.0, 0.0],
                       [-90.0, 0.0, 0.0], [90.0, 0.0, 0.0], [0.0, 90.0, 0.0]])


def _rotx(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def _roty(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


@lru_cache(maxsize=8)
def equi2cube_maps(face_w: int, in_h: int, in_w: int):
    """(in_x, in_y) [6, fw, fw] float64: where each face pixel samples the
    equirectangular image (column, row), +1 offset and clamped."""
    vfov = np.pi / 2
    views = np.deg2rad(_VIEWS_DEG)
    top_left = np.array([-np.tan(vfov / 2), -np.tan(vfov / 2), 1.0])
    uv = np.array([-2 * top_left[0] / face_w, -2 * top_left[1] / face_w, 0.0])
    res_acos, res_atan = 2 * in_w, 2 * in_h
    step_acos, step_atan = np.pi / res_acos, np.pi / res_atan
    lookup_acos = np.append(-np.cos(np.arange(res_acos) * step_acos), 1.0)
    lookup_atan = np.concatenate([[np.tan(step_atan / 2 - np.pi / 2)],
                                  np.tan(np.arange(1, res_atan) * step_atan - np.pi / 2),
                                  [np.tan(-step_atan / 2 + np.pi / 2)]])
    idx_acos = np.arange(0.0, res_acos + 1)
    idx_atan = np.arange(0.0, res_atan + 1)
    xg, yg = np.meshgrid(np.arange(face_w), np.arange(face_w))
    xf, yf = xg.flatten(), yg.flatten()
    in_x = np.zeros((6, face_w * face_w))
    in_y = np.zeros((6, face_w * face_w))
    for f in range(6):
        yaw, pitch, roll = views[f]
        pts = np.stack([top_left[0] + uv[0] * xf, top_left[1] + uv[1] * yf,
                        np.full(xf.shape, top_left[2])])
        xp, yp, zp = _roty(yaw) @ _rotx(pitch) @ _rotz(roll) @ pts
        nxz = np.sqrt(xp ** 2 + zp ** 2)
        phi = np.zeros(xf.shape[0])
        theta = np.zeros(xf.shape[0])
        pole = nxz < 10e-10
        phi[pole & (yp > 0)] = np.pi / 2
        phi[pole & (yp <= 0)] = -np.pi / 2
        ok = ~pole
        phi[ok] = np.interp(yp[ok] / nxz[ok], lookup_atan, idx_atan) * step_atan - np.pi / 2
        theta[ok] = np.interp(-zp[ok] / nxz[ok], lookup_acos, idx_acos) * step_acos
        neg = ok & (xp < 0)
        theta[neg] = -theta[neg]
        ix = np.clip((theta / np.pi) * (in_w / 2) + (in_w / 2) + 1, 1, None)
        ix[ix >= in_w - 1] = in_w - 1
        iy = np.clip((phi / (np.pi / 2)) * (in_h / 2) + (in_h / 2) + 1, 1, None)
        iy[iy >= in_h - 1] = in_h - 1
        in_x[f], in_y[f] = ix, iy
    return in_x.reshape(6, face_w, face_w), in_y.reshape(6, face_w, face_w)


def _pruned(a):
    a = np.array(a, copy=True)
    for v, nudged in ((0.0, _EPS), (np.pi, np.pi - _EPS), (-np.pi, -np.pi + _EPS),
                      (np.pi / 2, np.pi / 2 - _EPS), (-np.pi / 2, -np.pi / 2 + _EPS)):
        a[a == v] = nudged
    return a


@lru_cache(maxsize=8)
def cube2equi_map(face_w: int):
    """(coords [2w, 4w, 2] in-face (x, y) in [0, w-1], face [2w, 4w])."""
    out_w, out_h = 4 * face_w, 2 * face_w
    xx, yy = np.meshgrid(np.arange(out_w), np.arange(out_h))
    theta = _pruned((2.0 * (xx + 0.5) / out_w - 1.0) * np.pi)
    phi = _pruned((1.0 - 2.0 * (yy + 0.5) / out_h) * np.pi / 2.0)
    x = np.cos(phi) * np.cos(theta)
    y = np.sin(phi)
    z = np.cos(phi) * np.sin(theta)
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    mx = np.maximum(ax, ay)  # the published two-argument maximum
    face = np.zeros(x.shape, np.int64)
    face[(x >= 0) & (mx - ax < _EPS)] = F_F
    face[(x <= 0) & (mx - ax < _EPS)] = F_B
    face[(y >= 0) & (mx - ay < _EPS)] = F_T
    face[(y <= 0) & (mx - ay < _EPS)] = F_D
    face[(z >= 0) & (mx - az < _EPS)] = F_R
    face[(z <= 0) & (mx - az < _EPS)] = F_L
    u, v, w = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    for f, (uu, vv, ww) in {F_F: (z, y, x), F_B: (-z, y, x), F_T: (z, -x, y),
                            F_D: (z, x, y), F_R: (-x, y, z), F_L: (x, y, z)}.items():
        s = face == f
        u[s], v[s], w[s] = uu[s], vv[s], ww[s]
    xo = (u / np.abs(w) + 1.0) / 2.0
    yo = (-v / np.abs(w) + 1.0) / 2.0
    coords = np.clip(np.stack([xo, yo], -1) * (face_w - 1), 0.0, face_w - 1)
    return coords, face


@lru_cache(maxsize=8)
def cube2equi_matrix(face_w: int) -> np.ndarray:
    """[2w*4w, 6*w*w] bilinear weights of each equi pixel on the flat faces."""
    coords, face = cube2equi_map(face_w)
    w = face_w
    xs, ys = coords[..., 0].reshape(-1), coords[..., 1].reshape(-1)
    base = face.reshape(-1) * w * w
    x0, y0 = np.floor(xs), np.floor(ys)
    fx, fy = xs - x0, ys - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    x1, y1 = np.clip(x0 + 1, 0, w - 1), np.clip(y0 + 1, 0, w - 1)
    x0, y0 = np.clip(x0, 0, w - 1), np.clip(y0, 0, w - 1)
    m = np.zeros((xs.size, 6 * w * w), np.float64)
    r = np.arange(xs.size)
    np.add.at(m, (r, base + y0 * w + x0), (1 - fx) * (1 - fy))
    np.add.at(m, (r, base + y0 * w + x1), fx * (1 - fy))
    np.add.at(m, (r, base + y1 * w + x0), (1 - fx) * fy)
    np.add.at(m, (r, base + y1 * w + x1), fx * fy)
    return m


@lru_cache(maxsize=32)
def cube_pad_map(h: int, p: int) -> np.ndarray:
    """int64 [6, h+2p, h+2p]: the flat [6*h*h] source of each padded pixel
    (model/cube_pad.py: neighbour strips, flipped or transposed, corners
    replicated from the top/down strips)."""
    idx = np.arange(6 * h * h).reshape(6, h, h)
    b, d, f, l, r, t = idx  # noqa: E741
    sw = np.swapaxes
    top = np.stack([t[:p][:, ::-1], f[-p:], t[-p:], sw(t[:, :p], 0, 1),
                    sw(t[:, -p:], 0, 1)[:, ::-1], b[:p][:, ::-1]])
    down = np.stack([d[-p:][:, ::-1], b[-p:][:, ::-1], d[:p], sw(d[:, :p], 0, 1)[:, ::-1],
                     sw(d[:, -p:], 0, 1), f[:p]])
    left = np.stack([r[:, -p:], sw(l[-p:], 0, 1)[::-1], l[:, -p:], b[:, -p:], f[:, -p:],
                     sw(l[:p], 0, 1)])
    right = np.stack([l[:, :p], sw(r[-p:], 0, 1), r[:, :p], f[:, :p], b[:, :p],
                      sw(r[:p], 0, 1)[::-1]])
    # equal pads: each corner block tiles the top/down strip's edge column
    c_tl = np.tile(top[:, :p, :1], (1, 1, p))
    c_tr = np.tile(top[:, -p:, -1:], (1, 1, p))
    c_dl = np.tile(down[:, :p, :1], (1, 1, p))
    c_dr = np.tile(down[:, -p:, -1:], (1, 1, p))
    lcol = np.concatenate([c_tl, left, c_dl], 1)
    mid = np.concatenate([top, idx, down], 1)
    rcol = np.concatenate([c_tr, right, c_dr], 1)
    return np.concatenate([lcol, mid, rcol], 2)
