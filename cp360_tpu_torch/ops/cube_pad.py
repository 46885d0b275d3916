"""Cube padding — the paper's core op — as one precomputed gather (torch).

Reference semantics: model/cube_pad.py:45-216.  Each of the 6 cube faces is
padded with pixel strips taken from its 4 neighbour faces (flipped or
transposed to match edge orientation), with the 4 corner blocks filled by
replicating the adjacent edge strip of the top/down plates.  Face order is
B D F L R T (back, down, front, left, right, top).

For a given (H, W, pads) the padded output is a fixed permutation with
replication of the input pixels.  :func:`build_cube_pad_index_map` computes
it once per shape as an int32 map ``src[6, H+pt+pd, W+pl+pr]`` into the
flattened [6*H*W] face-pixel axis, by running the neighbour-strip
slice/flip/transpose logic on an array of linear indices; the runtime op is
one ``index_select``.  The same map is the source table of the fused
cube-pad conv kernel (ops/cube_conv.py).

The map builder is the port's own NumPy copy of
``cp360_tpu/ops/cube_pad.py::build_cube_pad_index_map``; the tests hold the
two equal.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from cp360_tpu_torch.models import layers

Pads = Union[int, Sequence[int]]


def get_pad_size(lrtd_pad: Pads) -> Tuple[int, int, int, int]:
    """Normalize a pad spec to (left, right, top, down).

    Reference: model/cube_pad.py:12-20 (an int means uniform padding).
    """
    if isinstance(lrtd_pad, (int, np.integer)):
        return (int(lrtd_pad),) * 4
    p_l, p_r, p_t, p_d = (int(p) for p in lrtd_pad)
    return p_l, p_r, p_t, p_d


def _build_plates(faces: np.ndarray, p_l: int, p_r: int, p_t: int, p_d: int):
    """Neighbour-strip plates for each face of a [6, H, W] array.

    Returns top/down [6, p, W] and left/right [6, H, p] plates (None where
    the pad is 0).  Strip choices mirror reference model/cube_pad.py:114-162;
    `[::-1]` on an axis is the reference's flip(), swapaxes its permute.
    """
    b, d, f, l, r, t = faces  # noqa: E741 — face initials match the paper

    top = down = left = right = None
    if p_t:
        top = np.stack([
            t[:p_t, :][:, ::-1],  # back   <- top's top rows, W-flipped
            f[-p_t:, :],  # down   <- front's bottom rows
            t[-p_t:, :],  # front  <- top's bottom rows
            t[:, :p_t].swapaxes(0, 1),  # left <- top's left cols, transposed
            t[:, -p_t:].swapaxes(0, 1)[:, ::-1],  # right <- top's right cols, transposed + W-flip
            b[:p_t, :][:, ::-1],  # top    <- back's top rows, W-flipped
        ])
    if p_d:
        down = np.stack([
            d[-p_d:, :][:, ::-1],  # back  <- down's bottom rows, W-flipped
            b[-p_d:, :][:, ::-1],  # down  <- back's bottom rows, W-flipped
            d[:p_d, :],  # front <- down's top rows
            d[:, :p_d].swapaxes(0, 1)[:, ::-1],  # left <- down's left cols, transposed + W-flip
            d[:, -p_d:].swapaxes(0, 1),  # right <- down's right cols, transposed
            f[:p_d, :],  # top   <- front's top rows
        ])
    if p_l:
        left = np.stack([
            r[:, -p_l:],  # back  <- right's right cols
            l[-p_l:, :].swapaxes(0, 1)[::-1, :],  # down <- left's bottom rows, transposed + H-flip
            l[:, -p_l:],  # front <- left's right cols
            b[:, -p_l:],  # left  <- back's right cols
            f[:, -p_l:],  # right <- front's right cols
            l[:p_l, :].swapaxes(0, 1),  # top   <- left's top rows, transposed
        ])
    if p_r:
        right = np.stack([
            l[:, :p_r],  # back  <- left's left cols
            r[-p_r:, :].swapaxes(0, 1),  # down <- right's bottom rows, transposed
            r[:, :p_r],  # front <- right's left cols
            f[:, :p_r],  # left  <- front's left cols
            b[:, :p_r],  # right <- back's left cols
            r[:p_r, :].swapaxes(0, 1)[::-1, :],  # top <- right's top rows, transposed + H-flip
        ])
    return top, down, left, right


def _corner(feat_td: np.ndarray, feat_lr: np.ndarray) -> np.ndarray:
    """Corner block by edge replication (reference model/cube_pad.py:83-90).

    feat_td: [6, td_pad, 1] column slice of the top/down plate.
    feat_lr: [6, 1, lr_pad] row slice of the left/right plate.
    The larger pad dimension wins; on ties the td strip is column-tiled.
    """
    td_pad = feat_td.shape[1]
    lr_pad = feat_lr.shape[2]
    if td_pad > lr_pad:
        return np.tile(feat_lr, (1, td_pad, 1))
    return np.tile(feat_td, (1, 1, lr_pad))


@lru_cache(maxsize=64)
def build_cube_pad_index_map(h: int, w: int, lrtd_pad) -> np.ndarray:
    """int32 gather map [6, H+pt+pd, W+pl+pr] into the flat [6*H*W] axis."""
    p_l, p_r, p_t, p_d = get_pad_size(lrtd_pad)
    if (p_l or p_r or p_t or p_d) and h != w:
        # Transposed neighbour strips only line up on square faces.
        raise ValueError(f"cube padding requires square faces, got {h}x{w}")

    idx = np.arange(6 * h * w, dtype=np.int64).reshape(6, h, w)
    top, down, left, right = _build_plates(idx, p_l, p_r, p_t, p_d)

    # Corners (reference model/cube_pad.py:165-176).
    p_tr = _corner(top[:, -p_t:, -1:], right[:, :1, :p_r]) if (p_t and p_r) else None
    p_tl = _corner(top[:, :p_t, :1], left[:, :1, :p_l]) if (p_t and p_l) else None
    p_dr = _corner(down[:, -p_d:, -1:], right[:, -1:, -p_r:]) if (p_d and p_r) else None
    p_dl = _corner(down[:, :p_d, :1], left[:, -1:, -p_l:]) if (p_d and p_l) else None

    # Assemble (reference model/cube_pad.py:179-216): the middle column gets
    # the top/down plates; the left/right columns span the full padded
    # height with their corners.
    mid = idx
    if p_t:
        mid = np.concatenate([top, mid], axis=1)
    if p_d:
        mid = np.concatenate([mid, down], axis=1)

    cols = []
    if p_l:
        lcol = left
        if p_tl is not None:
            lcol = np.concatenate([p_tl, lcol], axis=1)
        if p_dl is not None:
            lcol = np.concatenate([lcol, p_dl], axis=1)
        cols.append(lcol)
    cols.append(mid)
    if p_r:
        rcol = right
        if p_tr is not None:
            rcol = np.concatenate([p_tr, rcol], axis=1)
        if p_dr is not None:
            rcol = np.concatenate([rcol, p_dr], axis=1)
        cols.append(rcol)

    out = np.concatenate(cols, axis=2)
    if out.shape != (6, h + p_t + p_d, w + p_l + p_r):
        raise AssertionError(f"index map has shape {out.shape}")
    return out.astype(np.int32)


@lru_cache(maxsize=64)
def _index_tensor(h: int, w: int, pads: Tuple[int, int, int, int],
                  device: torch.device) -> torch.Tensor:
    m = build_cube_pad_index_map(h, w, pads)
    return torch.from_numpy(m.reshape(-1).astype(np.int64)).to(device)


def _check_cube(x: torch.Tensor) -> None:
    if x.ndim != 5 or x.shape[1] != 6:
        raise ValueError(f"expected [N, 6, H, W, C] cube faces, got {tuple(x.shape)}")
    if x.shape[2] != x.shape[3]:
        raise ValueError(
            f"cube padding requires square faces, got {x.shape[2]}x{x.shape[3]}")


def cube_pad(x: torch.Tensor, lrtd_pad: Pads) -> torch.Tensor:
    """Cube-pad a batch of cubemaps, NHWC.

    Args:
      x: [N, 6, H, W, C] (or [6, H, W, C]) cube faces in B D F L R T order.
      lrtd_pad: int or (left, right, top, down) pads.

    Returns [N, 6, H+pt+pd, W+pl+pr, C]: one ``index_select`` off the
    cached index map.
    """
    squeeze = x.ndim == 4
    if squeeze:
        x = x[None]
    _check_cube(x)
    pads = get_pad_size(lrtd_pad)
    if pads == (0, 0, 0, 0):
        return x[0] if squeeze else x
    n, _, h, w, c = x.shape
    p_l, p_r, p_t, p_d = pads
    idx = _index_tensor(h, w, pads, x.device)
    out = x.reshape(n, 6 * h * w, c).index_select(1, idx)
    out = out.reshape(n, 6, h + p_t + p_d, w + p_l + p_r, c)
    return out[0] if squeeze else out


def zero_pad(x: torch.Tensor, lrtd_pad: Pads) -> torch.Tensor:
    """Zero-padding ablation baseline (config key ``cube_pad: false``).
    Same signature as :func:`cube_pad`; pads the two spatial axes."""
    p_l, p_r, p_t, p_d = get_pad_size(lrtd_pad)
    # F.pad lists pads from the LAST axis backwards: C, then W, then H
    return F.pad(x, (0, 0, p_l, p_r, p_t, p_d))


def cube_pad_max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """``max_pool(cube_pad(x, 1), 3, stride 2)`` — the ResNet stem pool.

    x: [N, 6, H, W, C] (H = W, even) -> [N, 6, H/2, W/2, C].  Replaces the
    reference's CubePadding(1) + nn.MaxPool2d(3, 2)
    (model/resnet_cubic.py:118-119,166-167).  The JAX package pools the
    unpadded faces and max-corrects row 0 / column 0 with the halo strips
    (``cp360_tpu/ops/cube_pad.py::cube_pad_max_pool_3x3s2``); max does not
    depend on how a window's cells are grouped, so this pad-then-pool form
    is bit-exact with it.
    """
    _check_cube(x)
    n, _, h, w, c = x.shape
    if h % 2:
        raise ValueError(f"the fused stem pool needs an even face size, got {h}")
    xp = cube_pad(x, 1).reshape(n * 6, h + 2, w + 2, c)
    out = layers.max_pool(xp, 3, 2)
    return out.reshape(n, 6, h // 2, w // 2, c)
