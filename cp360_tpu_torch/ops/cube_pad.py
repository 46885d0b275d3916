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
cube-pad conv kernel (ops/cube_conv.py) and of the halo strips of
:func:`cube_pad_conv3x3`.

The map builder is the port's own NumPy copy of
``cp360_tpu/ops/cube_pad.py::build_cube_pad_index_map``; the tests hold the
two equal.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


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


def cube_pad_nchw(x: torch.Tensor, lrtd_pad: Pads) -> torch.Tensor:
    """The reference module's call shape: [6N, C, H, W] face-major batches
    (model/cube_pad.py:28-42) -> padded [6N, C, H', W']
    (``cp360_tpu/ops/cube_pad.py:296``).  New code uses :func:`cube_pad`."""
    n6, c, h, w = x.shape
    if n6 % 6:
        raise ValueError(f"batch {n6} is not a multiple of 6 faces")
    out = cube_pad(x.reshape(n6 // 6, 6, c, h, w).permute(0, 1, 3, 4, 2), lrtd_pad)
    return out.permute(0, 1, 4, 2, 3).reshape(n6, c, *out.shape[2:4])


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
    (model/resnet_cubic.py:118-119,166-167).  A CUDA tensor launches K3
    (``ops/cube_pool.py``, ``csrc/cube_pool3x3s2.cu``); a CPU tensor runs
    its plain pad-then-pool form.  The JAX package pools the unpadded faces
    and max-corrects row 0 / column 0 with the halo strips
    (``cp360_tpu/ops/cube_pad.py::cube_pad_max_pool_3x3s2``); max does not
    depend on how a window's cells are grouped, so both are bit-exact with
    it.
    """
    from cp360_tpu_torch.ops import cube_pool  # imports this module

    return cube_pool.cube_pad_max_pool_3x3s2(x)


CUBE_CONV_FORMS = ("pad", "halo")


@lru_cache(maxsize=64)
def _halo_ring(h: int, stride: int, device: torch.device) -> torch.Tensor:
    """The halo strips of a pad-1 cube conv as one index into the flat
    [6*h*h] face-pixel axis, ordered (face, position, strip) so that the
    gather is a [6, h+2, strips] stack: the top row with its corners, the
    left column, and at stride 1 the bottom row and the right column.  The
    columns' two end positions point at their corner pixels; the caller
    zeroes them."""
    m = build_cube_pad_index_map(h, h, 1)  # [6, h+2, h+2]
    strips = [m[:, 0, :], m[:, :, 0]]
    if stride == 1:
        strips += [m[:, h + 1, :], m[:, :, h + 1]]
    ring = np.stack(strips, axis=2).reshape(-1).astype(np.int64)
    return torch.from_numpy(ring).to(device)


def halo_kernel(w: torch.Tensor, stride: int) -> torch.Tensor:
    """The halo strips' 1x3 kernels w[0, :], w[:, 0] and, at stride 1,
    w[2, :], w[:, 2], as one grouped HWIO kernel [1, 3, C, strips*Co]: a
    view of OIHW channels_last storage, as the backbones hold their
    kernels.  w: [3, 3, C, Co] HWIO."""
    o = w.permute(3, 0, 1, 2)  # [Co, 3, 3, C]
    taps = [o[:, 0:1], o[:, :, 0:1].transpose(1, 2), o[:, 2:3], o[:, :, 2:3].transpose(1, 2)]
    return torch.cat(taps[:4 if stride == 1 else 2]).permute(1, 2, 3, 0)


def cube_pad_conv3x3(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     compute_dtype=None, form: str = "pad",
                     w_halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv2d(cube_pad(x, 1), w, stride, VALID)``, the Bottleneck's cube
    conv (reference model/resnet_cubic.py:92-93), in one of two forms
    (``cp360_tpu/ops/cube_pad.py:617-713``).

    ``pad``: cube pad, then a VALID conv.

    ``halo``: one zero-padding conv over the raw faces (the interior is
    exact, since the zero taps add nothing), plus thin convs over the halo
    strips added onto the border ring:

      out[0, j]  += sum_b w[0, b] * halo_top[j*s + b]       (1x3, corners in)
      out[i, 0]  += sum_a w[a, 0] * halo_left[i*s + a - 1] (3x1, zero-ended)
      out[-1, j] += sum_b w[2, b] * halo_bottom[j + b]     (stride 1 only)
      out[i, -1] += sum_a w[a, 2] * halo_right[i + a - 1]  (stride 1 only)

    At stride 2 on even H the bottom row and right column of the padded
    input are never read, so only the top and left strips are gathered.
    The strips come off the pad-1 index map in one ``index_select``, and
    all the strip convs run as one grouped 1x3 conv (a group a strip).
    Each conv rounds at its store and the four adds run in the output
    dtype in the JAX package's order: the border ring's sum is
    reassociated, so ``halo`` matches ``pad`` to f32 reassociation error,
    or about one bf16 ulp.

    x: [N, 6, H, W, C] (H = W); w: [3, 3, C, Co] HWIO; ``w_halo``:
    ``halo_kernel(w, stride)``, made here when not given.  Returns
    [N, 6, H/stride, W/stride, Co].
    """
    from cp360_tpu_torch.models import layers  # imports this module

    if form not in CUBE_CONV_FORMS:
        raise ValueError(f"unknown cube-conv form {form!r} (one of {CUBE_CONV_FORMS})")
    _check_cube(x)
    n, _, h, wd, c = x.shape
    if tuple(w.shape[:2]) != (3, 3) or stride not in (1, 2) or (stride == 2 and h % 2):
        raise ValueError(f"cube_pad_conv3x3 takes a 3x3 kernel at stride 1, or 2 on even "
                         f"faces: kernel {tuple(w.shape)}, stride {stride}, faces {h}")
    if form == "pad":
        xp = cube_pad(x, 1).reshape(n * 6, h + 2, wd + 2, c)
        out = layers.conv2d(xp, w, stride=stride, compute_dtype=compute_dtype)
        return out.reshape(n, 6, *out.shape[1:])

    out = layers.conv2d(x.reshape(n * 6, h, wd, c), w, stride=stride,
                        padding=((1, 1), (1, 1)), compute_dtype=compute_dtype)
    g = 4 if stride == 1 else 2
    halo = x.reshape(n, 6 * h * wd, c).index_select(1, _halo_ring(h, stride, x.device))
    halo = halo.reshape(n * 6, h + 2, g, c)
    halo[:, ::h + 1, 1::2] = 0  # the columns' ends: their corners are the rows'
    if w_halo is None:
        w_halo = halo_kernel(w, stride)
    corr = layers.conv2d(halo.reshape(n * 6, 1, h + 2, g * c), w_halo,
                         stride=(1, stride), compute_dtype=compute_dtype, groups=g)
    corr = corr.reshape(n * 6, h // stride, g, -1)
    # add_ on views: ``out[...] += c`` would also run a __setitem__ a time
    out[:, 0].add_(corr[:, :, 0])
    out[:, :, 0].add_(corr[:, :, 1])
    if stride == 1:
        out[:, -1].add_(corr[:, :, 2])
        out[:, :, -1].add_(corr[:, :, 3])
    return out.reshape(n, 6, *out.shape[1:])
