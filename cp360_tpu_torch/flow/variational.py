"""Variational optical flow with the DeepFlow/Brox energy, in plain PyTorch.

The port of ``cp360_tpu/flow/variational.py``.  DeepFlow (Weinzaepfel et
al., ICCV'13) minimizes the Brox'04 energy

    E(w) = ∫ Ψ(|I2(x+w) − I1(x)|²) + γ Ψ(|∇I2(x+w) − ∇I1(x)|²)
         + α Ψ(|∇u|² + |∇v|²),          Ψ(s²) = sqrt(s² + ε²)

coarse to fine with warping: outer warps re-linearize the data term at the
current flow, middle (fixed-point) iterations lag the non-linear Ψ′
factors, and inner Jacobi sweeps solve the resulting linear system with
each pixel's coupled 2×2 (du, dv) block solved in closed form.  The
DeepMatching term of DeepFlow is left out, as in the JAX package: at ≥24
fps consecutive frames move a few pixels, inside the pyramid's basin.

Every stencil is the JAX package's, in its operation order; the pair axis
is a leading batch axis [N, H, W].  Ψ′ is ``1 / sqrt``, never ``rsqrt``:
an approximate reciprocal square root feeds back through hundreds of lagged
sweeps, and the JAX package measured 4 px of divergence at the
moving-patch boundary from exactly that (``variational.py:72-79``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cp360_tpu_torch.flow.optical_flow import (
    _check_pairs,
    _grad,
    _median3,
    _postprocess_magnitude,
    _preprocess_pair,
    _pyramid,
    _solve_u8,
    _upsample2,
    _warp_valid,
)

_EPS2 = 1e-6  # Charbonnier ε² (ε = 1e-3, the Brox/DeepFlow standard)


def _psi_deriv(s2: torch.Tensor) -> torch.Tensor:
    """Ψ′(s²) = 1 / (2 sqrt(s² + ε²)) up to the constant 2, which every term
    of the Euler-Lagrange equation carries and so cancels.  A correctly
    rounded square root and an IEEE division: not ``torch.rsqrt``."""
    return torch.reciprocal(torch.sqrt(s2 + _EPS2))


def _shift_pad(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """x shifted so out[..., y, x] = x[..., y+dy, x+dx], out of bounds 0."""
    h, w = x.shape[-2:]
    up = F.pad(x, (1, 1, 1, 1))
    return up[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _edge_masks(h: int, w: int, device):
    """In-bounds masks of the 4-neighborhood (zero-Neumann border: an
    out-of-frame neighbor contributes no diffusion edge)."""
    masks = torch.ones((4, h, w), dtype=torch.float32, device=device)
    masks[0, 0, :] = 0.0
    masks[1, h - 1, :] = 0.0
    masks[2, :, 0] = 0.0
    masks[3, :, w - 1] = 0.0
    return tuple(masks)


def _level_solve(a, b, uv, alpha, gamma, fp_iters, solver_iters):
    """One warp linearization at uv [N, 2, H, W]: returns the flow increment
    [N, 2, H, W].  a, b: first frame and SECOND frame (unwarped) at this
    pyramid level."""
    u, v = uv[:, 0], uv[:, 1]
    bw, valid = _warp_valid(b, u, v)
    ax, ay = _grad(a)
    # derivatives of the warped image: differentiate after warping, so the
    # data and gradient terms see the same sample lattice
    bx, by = _grad(bw)
    ix = 0.5 * (ax + bx) * valid
    iy = 0.5 * (ay + by) * valid
    iz = (bw - a) * valid
    # gradient-constancy channel: residual of ∇I and its second derivatives
    ixx, ixy_a = _grad(ix)
    ixy_b, iyy = _grad(iy)
    ixy = 0.5 * (ixy_a + ixy_b)
    ixz = (bx - ax) * valid
    iyz = (by - ay) * valid

    h, w = a.shape[-2:]
    m_n, m_s, m_w, m_e = _edge_masks(h, w, a.device)
    duv = torch.zeros_like(uv)
    for _ in range(fp_iters):
        du, dv = duv[:, 0], duv[:, 1]
        # lagged nonlinearity: robust factors at the current increment
        r_d = iz + ix * du + iy * dv
        psi_d = _psi_deriv(r_d * r_d)
        r_gx = ixz + ixx * du + ixy * dv
        r_gy = iyz + ixy * du + iyy * dv
        psi_g = _psi_deriv(r_gx * r_gx + r_gy * r_gy)

        ux, uy = _grad(u + du)
        vx, vy = _grad(v + dv)
        psi_s = _psi_deriv(ux * ux + uy * uy + vx * vx + vy * vy)

        # diffusion edge weights: arithmetic mean of Ψ′_S across each edge
        w_n = 0.5 * (psi_s + _shift_pad(psi_s, -1, 0)) * m_n
        w_s = 0.5 * (psi_s + _shift_pad(psi_s, 1, 0)) * m_s
        w_w = 0.5 * (psi_s + _shift_pad(psi_s, 0, -1)) * m_w
        w_e = 0.5 * (psi_s + _shift_pad(psi_s, 0, 1)) * m_e
        sum_w = w_n + w_s + w_w + w_e

        # the 2x2 blocks, constant over this fixed-point iteration
        a11 = psi_d * ix * ix + gamma * psi_g * (ixx * ixx + ixy * ixy) + alpha * sum_w
        a22 = psi_d * iy * iy + gamma * psi_g * (ixy * ixy + iyy * iyy) + alpha * sum_w
        a12 = psi_d * ix * iy + gamma * psi_g * (ixx * ixy + ixy * iyy)
        c1 = -psi_d * ix * iz - gamma * psi_g * (ixx * ixz + ixy * iyz)
        c2 = -psi_d * iy * iz - gamma * psi_g * (ixy * ixz + iyy * iyz)
        det = a11 * a22 - a12 * a12  # >= alpha^2 sum_w^2 > 0 in the interior

        # the Jacobi sweeps on (du, dv) stacked: per element, the JAX
        # package's b1 = c1 + alpha (nb_u - sum_w u), du = (a22 b1 - a12 b2)
        # / det and dv = (a11 b2 - a12 b1) / det
        wts = [t[:, None] for t in (w_n, w_s, w_w, w_e)]
        c = torch.stack([c1, c2], 1)
        sum_w_uv = sum_w[:, None] * uv
        diag = torch.stack([a22, a11], 1)
        a12_, det_ = a12[:, None], det[:, None]
        for _ in range(solver_iters):
            up = F.pad(uv + duv, (1, 1, 1, 1))
            nb = (wts[0] * up[..., 0:h, 1:w + 1] + wts[1] * up[..., 2:h + 2, 1:w + 1]
                  + wts[2] * up[..., 1:h + 1, 0:w] + wts[3] * up[..., 1:h + 1, 2:w + 2])
            rhs = c + alpha * (nb - sum_w_uv)
            duv = (diag * rhs - a12_ * rhs.flip(1)) / det_
    return duv


@torch.no_grad()
def brox_flow_batch(
    prev_gray: torch.Tensor,
    cur_gray: torch.Tensor,
    alpha: float = 0.02,
    gamma: float = 0.5,
    levels: int = 5,
    n_warp: int = 3,
    fp_iters: int = 5,
    solver_iters: int = 25,
    presmooth: bool = True,
    median: bool = True,
) -> torch.Tensor:
    """Dense flow [N, H, W, 2] f32 (dx, dy) minimizing the DeepFlow/Brox
    energy between [N, H, W] grayscale pairs in [0, 1], on their device
    (``cp360_tpu/flow/variational.py:179,237``).

    Per pyramid level (coarse to fine, factor 2): ``n_warp`` outer warps ×
    ``fp_iters`` lagged-Ψ′ steps × ``solver_iters`` Jacobi sweeps, then a
    3x3 median.  ``alpha`` and ``gamma`` are the smoothness and
    gradient-constancy weights in [0, 1] intensity units.
    """
    _check_pairs(prev_gray, cur_gray)
    pyr = _pyramid(prev_gray, cur_gray, levels, presmooth)
    uv = torch.zeros((pyr[-1][0].shape[0], 2, *pyr[-1][0].shape[-2:]),
                     dtype=torch.float32, device=prev_gray.device)
    for li in range(levels - 1, -1, -1):
        a, b = pyr[li]
        if uv.shape[-2:] != a.shape[-2:]:
            uv = _upsample2(uv, *a.shape[-2:]) * 2.0
        for _ in range(n_warp):
            uv = uv + _level_solve(a, b, uv, alpha, gamma, fp_iters, solver_iters)
            if median:
                uv = _median3(uv)
    return uv.permute(0, 2, 3, 1).contiguous()


def brox_flow(prev_gray: torch.Tensor, cur_gray: torch.Tensor, **kw) -> torch.Tensor:
    """One [H, W] pair -> [H, W, 2]: :func:`brox_flow_batch` on a batch of
    one."""
    return brox_flow_batch(prev_gray[None], cur_gray[None], **kw)[0]


def calc_optical_flow_variational(
    prev_frame: np.ndarray, cur_frame: np.ndarray, res: Tuple[int, int] = (960, 480),
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop-in for ``calc_optical_flow`` with the variational solver on
    ``device`` (config ``flow_backend: variational``; the card by default,
    raises without one): the reference wrapper's pre- and post-processing
    around :func:`brox_flow_batch`."""
    from cp360_tpu_torch.serving.server import resolve_device

    dev = resolve_device(device)
    prev, cur = _preprocess_pair(prev_frame, cur_frame, res)
    flow = _solve_u8("variational", prev[None], cur[None], dev)[0].cpu().numpy()
    return _postprocess_magnitude(flow), flow
