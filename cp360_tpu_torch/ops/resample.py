"""Equirectangular <-> cubemap resampling (torch, NHWC).

The counterpart of ``cp360_tpu/ops/resample.py``.  Every projection
resample reads precomputed float coordinate maps (built once on the host,
geometry/equi_cube.py) and blends 4 bilinear taps:

- ``equi_to_cube`` reproduces ``cv2.remap(..., INTER_LINEAR)``
  (reference utils/equi_to_cube.py:112-129).  On a CPU tensor it is the
  plain torch gather below; on a CUDA tensor it launches the hand-written
  equi->cube kernel (ops/equi_gather.py).
- ``cube_to_equi`` reproduces the reference's differentiable path
  (utils/cube_to_equi.py:37-66): bilinear at the precomputed [0, w-1]
  in-face coordinates of the face the face map picks.  For faces up to
  20x20 (the CAM cubes) it is one product with a dense interpolation
  matrix; larger faces use the 4-tap gather.
- ``grid_sample``, ``warp_upsampled`` and ``resize_bilinear`` reproduce
  torch-0.3 ``grid_sample`` / ``upsample(mode='bilinear')`` (both
  align_corners=True, zero padding), as the training losses use them
  (temporal_model/train_temporal.py:132-143).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from cp360_tpu_torch.geometry import equi_cube


def _bilinear_gather(flat_src: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                     src_h: int, src_w: int, base=0) -> torch.Tensor:
    """Bilinear sample ``flat_src`` [..., src_h*src_w(+), C] at float coords.

    A torch port of ``cp360_tpu/ops/resample.py::_bilinear_gather``
    (:36-83): same floor, clamp and weight order.  xs/ys are f32 arrays of
    the output grid's shape S; ``base`` is an optional per-output-pixel flat
    offset (the cube face).  Returns [..., *S, C].  Integer sources are
    sampled in f32 and rounded back to their dtype.
    """
    src_dtype = flat_src.dtype
    integer_src = not (src_dtype.is_floating_point or src_dtype.is_complex)
    if integer_src:
        flat_src = flat_src.float()
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = (xs - x0).to(flat_src.dtype)
    fy = (ys - y0).to(flat_src.dtype)
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    x1 = torch.clamp(x0 + 1, 0, src_w - 1)
    y1 = torch.clamp(y0 + 1, 0, src_h - 1)
    x0 = torch.clamp(x0, 0, src_w - 1)
    y0 = torch.clamp(y0, 0, src_h - 1)

    def take(i):
        return flat_src.index_select(-2, (base + i).reshape(-1))

    g00 = take(y0 * src_w + x0)
    g01 = take(y0 * src_w + x1)
    g10 = take(y1 * src_w + x0)
    g11 = take(y1 * src_w + x1)
    w00 = ((1 - fx) * (1 - fy)).reshape(-1, 1)
    w01 = (fx * (1 - fy)).reshape(-1, 1)
    w10 = ((1 - fx) * fy).reshape(-1, 1)
    w11 = (fx * fy).reshape(-1, 1)
    out = g00 * w00 + g01 * w01 + g10 * w10 + g11 * w11
    if integer_src:
        out = torch.round(out).to(src_dtype)
    return out.reshape(*flat_src.shape[:-2], *xs.shape, flat_src.shape[-1])


@lru_cache(maxsize=8)
def equi2cube_maps(face_w: int, in_h: int, in_w: int, device: torch.device):
    """f32 (in_x, in_y) [6, fw, fw] sampling maps on ``device``, built once
    per geometry (the cast to f32 matches the JAX package's use)."""
    in_x, in_y = equi_cube.build_equi2cube_maps(face_w, in_h, in_w)
    return (torch.from_numpy(in_x.astype(np.float32)).to(device),
            torch.from_numpy(in_y.astype(np.float32)).to(device))


def equi_to_cube_plain(equi: torch.Tensor, face_w: int) -> torch.Tensor:
    """The plain torch equi->cube: [N, H, 2H, C] -> [N, 6, fw, fw, C]."""
    n, h, w, c = equi.shape
    xs, ys = equi2cube_maps(face_w, h, w, equi.device)
    return _bilinear_gather(equi.reshape(n, h * w, c), xs, ys, h, w)


def equi_to_cube(equi: torch.Tensor, face_w: int) -> torch.Tensor:
    """Equirectangular image(s) -> 6 cube faces, NHWC.

    Args:
      equi: [H, 2H, C] or [N, H, 2H, C].
      face_w: output face resolution (e.g. 224).

    Returns [6, fw, fw, C] (or [N, 6, ...]) in B D F L R T order.  A CUDA
    tensor goes through the equi->cube kernel (f32 input only there; the
    u8 frame entry with the fused /255 is ``equi_gather.equi_to_cube``).
    """
    squeeze = equi.ndim == 3
    if squeeze:
        equi = equi[None]
    if equi.is_cuda:
        if equi.dtype != torch.float32:
            raise TypeError(
                f"equi_to_cube on the card takes float32, got {equi.dtype}")
        from cp360_tpu_torch.ops import equi_gather

        out = equi_gather.equi_to_cube(equi, face_w)
    else:
        out = equi_to_cube_plain(equi, face_w)
    return out[0] if squeeze else out


@lru_cache(maxsize=8)
def build_cube2equi_matrix(face_w: int) -> np.ndarray:
    """Dense interpolation matrix M [2w*4w, 6*w*w], 4 nonzeros per row.

    Row p holds the bilinear corner weights of equi output pixel p against
    the flattened face pixels; coincident corners (clamped coords)
    accumulate, matching the gather form exactly.
    """
    coords, face_map = equi_cube.build_cube2equi_map(face_w)
    w = face_w
    xs = coords[..., 0].reshape(-1)
    ys = coords[..., 1].reshape(-1)
    base = (face_map.reshape(-1) * (w * w)).astype(np.int64)

    x0 = np.floor(xs)
    y0 = np.floor(ys)
    fx = xs - x0
    fy = ys - y0
    x0 = x0.astype(np.int64)
    y0 = y0.astype(np.int64)
    x1 = np.clip(x0 + 1, 0, w - 1)
    y1 = np.clip(y0 + 1, 0, w - 1)
    x0 = np.clip(x0, 0, w - 1)
    y0 = np.clip(y0, 0, w - 1)

    n_out = xs.size
    m = np.zeros((n_out, 6 * w * w), np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, base + y0 * w + x0), (1 - fx) * (1 - fy))
    np.add.at(m, (rows, base + y0 * w + x1), fx * (1 - fy))
    np.add.at(m, (rows, base + y1 * w + x0), (1 - fx) * fy)
    np.add.at(m, (rows, base + y1 * w + x1), fx * fy)
    return m


@lru_cache(maxsize=8)
def _cube2equi_matrix(face_w: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(build_cube2equi_matrix(face_w)).to(device)


@lru_cache(maxsize=8)
def _cube2equi_gather_maps(face_w: int, device: torch.device):
    coords, face_map = equi_cube.build_cube2equi_map(face_w)
    xs = torch.from_numpy(coords[..., 0].astype(np.float32)).to(device)
    ys = torch.from_numpy(coords[..., 1].astype(np.float32)).to(device)
    base = torch.from_numpy(face_map * (face_w * face_w)).to(device)
    return xs, ys, base


def cube_to_equi(faces: torch.Tensor) -> torch.Tensor:
    """6 cube faces -> equirectangular, NHWC.

    Args:
      faces: [6, w, w, C] or [N, 6, w, w, C] in B D F L R T order.

    Returns [2w, 4w, C] (or [N, 2w, 4w, C]) in the faces' dtype.
    """
    squeeze = faces.ndim == 4
    if squeeze:
        faces = faces[None]
    n, six, h, w, c = faces.shape
    if six != 6 or h != w:
        raise ValueError(f"expected [N,6,w,w,C], got {tuple(faces.shape)}")
    flat = faces.reshape(n, 6 * h * w, c)

    # Matmul form up to 20x20 faces (M is 192*w^4 bytes: 7 MB at w=14,
    # 30 MB at w=20); the gather beyond, as the JAX package splits it.
    if w <= 20:
        m = _cube2equi_matrix(w, faces.device)
        out = torch.matmul(m, flat.float()).to(faces.dtype)
        out = out.reshape(n, 2 * w, 4 * w, c)
        return out[0] if squeeze else out

    xs, ys, base = _cube2equi_gather_maps(w, faces.device)
    out = _bilinear_gather(flat, xs, ys, h, w, base=base)  # [N, 2w, 4w, C]
    return out[0] if squeeze else out


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """torch-0.3 ``nn.functional.grid_sample`` semantics, NHWC
    (``cp360_tpu/ops/resample.py:203-248``).

    Args:
      x: [N, H, W, C].
      grid: [N, Hg, Wg, 2] with (x, y) in [-1, 1], align_corners=True
        normalization; out-of-range corners contribute zeros.

    Returns [N, Hg, Wg, C].  Integer inputs are sampled in f32 and rounded
    back to their dtype.
    """
    src_dtype = x.dtype
    integer_src = not src_dtype.is_floating_point
    if integer_src:
        x = x.float()
    n, h, w, c = x.shape
    gx = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
    gy = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = (gx - x0).to(x.dtype)
    fy = (gy - y0).to(x.dtype)
    flat = x.reshape(n, h * w, c)

    def corner(yi, xi, wgt):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xc = torch.clamp(xi, 0, w - 1).long()
        yc = torch.clamp(yi, 0, h - 1).long()
        idx = (yc * w + xc).reshape(n, -1, 1).expand(-1, -1, c)
        vals = torch.gather(flat, 1, idx).reshape(n, *yi.shape[1:], c)
        return vals * (wgt * inb.to(x.dtype))[..., None]

    out = (corner(y0, x0, (1 - fx) * (1 - fy))
           + corner(y0, x0 + 1, fx * (1 - fy))
           + corner(y0 + 1, x0, (1 - fx) * fy)
           + corner(y0 + 1, x0 + 1, fx * fy))
    if integer_src:
        out = torch.round(out).to(src_dtype)
    return out


def warp_upsampled(p_lo: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``grid_sample(resize_bilinear(p_lo[..., None], H, W), grid)[..., 0]``
    without the upsample or the gather (``cp360_tpu/ops/resample.py:251-305``).

    The upsampled image is ``Ry @ p @ Rx^T`` with analytic hat rows
    ``R[r, a] = max(0, 1 - |r*s - a|)``, s = (n_coarse-1)/(n_fine-1), so a
    sample at (gy, gx) is the bilinear form ``d[pix] @ p @ e[pix]^T`` with
    d, e the fine-grid interpolation of two hat rows each; out-of-range fine
    rows/columns are masked as in :func:`grid_sample`.

    Args:
      p_lo: [N, ph, pw] low-res maps.
      grid: [N, H, W, 2] in [-1, 1], align-corners.

    Returns [N, H, W].
    """
    n, ph, pw = p_lo.shape
    out_h, out_w = grid.shape[1], grid.shape[2]
    gx = (grid[..., 0] + 1.0) * 0.5 * (out_w - 1)  # [N, H, W]
    gy = (grid[..., 1] + 1.0) * 0.5 * (out_h - 1)

    def axis_weights(g, n_fine, n_coarse):
        scale = (n_coarse - 1.0) / (n_fine - 1.0)
        ar = torch.arange(n_coarse, dtype=g.dtype, device=g.device)[None, :, None, None]
        g0 = torch.floor(g)
        f = g - g0

        def row_of_resize_matrix(yi):
            inb = (yi >= 0) & (yi <= n_fine - 1)
            wgt = torch.clamp(1.0 - torch.abs(yi[:, None] * scale - ar), min=0.0)
            return wgt * inb[:, None].to(g.dtype)

        return ((1.0 - f)[:, None] * row_of_resize_matrix(g0)
                + f[:, None] * row_of_resize_matrix(g0 + 1.0))

    d = axis_weights(gy, out_h, ph)  # [N, ph, H, W]
    e = axis_weights(gx, out_w, pw)  # [N, pw, H, W]
    b = torch.einsum("nbhw,nab->nahw", e, p_lo.float())
    return torch.sum(d * b, dim=1)


@lru_cache(maxsize=32)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """1-D align-corners bilinear interpolation matrix [n_out, n_in]."""
    pos = np.linspace(0.0, n_in - 1.0, n_out)
    i0 = np.floor(pos).astype(np.int64)
    f = pos - i0
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    m = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0), 1.0 - f)
    np.add.at(m, (rows, i1), f)
    return m


@lru_cache(maxsize=32)
def _resize_matrix_on(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_matrix(n_in, n_out)).to(device)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch-0.3 ``upsample(mode='bilinear')`` (align_corners=True), NHWC:
    [N, H, W, C] -> [N, out_h, out_w, C] in x's dtype, as two separable
    interpolation products in f32 (``cp360_tpu/ops/resample.py:322-340``)."""
    _, h, w, _ = x.shape
    ry = _resize_matrix_on(h, out_h, x.device)  # [out_h, h]
    rx = _resize_matrix_on(w, out_w, x.device)  # [out_w, w]
    out = torch.einsum("Oh,nhwc->nOwc", ry, x.float())
    out = torch.einsum("Pw,nhwc->nhPc", rx, out)
    return out.to(x.dtype)
