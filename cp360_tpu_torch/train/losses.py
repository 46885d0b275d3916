"""Weakly-supervised training losses (torch, batched, differentiable).

The counterpart of ``cp360_tpu/train/losses.py:35-115`` (reference
temporal_model/train_temporal.py:103-167).  Three sum-MSE losses over
consecutive pairs of equirectangular saliency predictions, upsampled to
flow resolution:

- smooth (flow-warp): || p_{t+1} - detach(warp(p_t, flow_t)) ||^2
- temporal:           || p_{t+1} - detach(p_t) ||^2
- motion-mask:        || p_{t+1} - detach(p_{t+1} with static pixels
                         zeroed) ||^2   (static = |flow| < mm_th)

Reference quirks kept: the flow is scaled by fscale = flow_h / W before use;
the warp grid normalizes dx by width/2 and dy by height/2 (align-corners);
gradients flow only through p_{t+1} (warp, current frame and masked target
are detached, so neither is part of the autograd graph); the losses are
summed over pairs, batch and pixels.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from cp360_tpu_torch.ops.resample import resize_bilinear, warp_upsampled


def flow_warp_grid(flow: torch.Tensor) -> torch.Tensor:
    """Flow [B, H, W, 2] (dx, dy in pixels at HxW) -> grid_sample grid:
    the align-corners base grid in [-1, 1] plus the flow scaled by 2/width
    (x) and 2/height (y) (train_temporal.py:25-31,136-138)."""
    _, h, w, _ = flow.shape
    ys = torch.arange(h, dtype=torch.float32, device=flow.device) / (h - 1) * 2 - 1
    xs = torch.arange(w, dtype=torch.float32, device=flow.device) / (w - 1) * 2 - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy], dim=-1)[None]
    off = torch.stack([flow[..., 0] / w * 2.0, flow[..., 1] / h * 2.0], dim=-1)
    return base + off


def weak_supervision_losses(preds: torch.Tensor, flows: torch.Tensor,
                            mm_th: float = 0.15, flow_h: int = 480) -> Dict[str, torch.Tensor]:
    """The three losses.

    Args:
      preds: [P+1, B, h, w] channel-maxed equi predictions of consecutive
        steps (P pairs).
      flows: [P, B, H, W, 2] raw optical flow of each pair at the stored
        resolution.
      mm_th: motion-mask threshold on the scaled flow magnitude.

    Returns {'smooth', 'temporal', 'mask'}: sum-MSE scalars.
    """
    p1, b = preds.shape[:2]
    p = p1 - 1
    fh, fw = flows.shape[2], flows.shape[3]
    f2 = (flows * (flow_h / float(fw))).reshape(p * b, fh, fw, 2)

    nxt = resize_bilinear(preds[1:].reshape(p * b, *preds.shape[2:])[..., None], fh, fw)
    with torch.no_grad():
        cur_lo = preds[:-1].reshape(p * b, *preds.shape[2:])
        cur = resize_bilinear(cur_lo[..., None], fh, fw)
        warp = warp_upsampled(cur_lo, flow_warp_grid(f2))[..., None]
        static = (torch.sqrt(f2[..., 0] ** 2 + f2[..., 1] ** 2) < mm_th)[..., None]
        nxt_masked = torch.where(static, torch.zeros_like(nxt), nxt)

    return {"smooth": torch.sum((nxt - warp) ** 2),
            "temporal": torch.sum((nxt - cur) ** 2),
            "mask": torch.sum((nxt - nxt_masked) ** 2)}


def total_loss(losses: Dict[str, torch.Tensor], l_s: float, l_t: float,
               l_m: float) -> torch.Tensor:
    return l_s * losses["smooth"] + l_t * losses["temporal"] + l_m * losses["mask"]


def window_normalize(seq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Joint min/max normalization over the whole window (every axis):
    returns (normalized seq, min, max - min), as the reference's test and
    training protocols do (test_temporal.py:66-71, train_temporal.py:76-90)."""
    mn = torch.min(seq)
    rng = torch.max(seq - mn)
    return (seq - mn) / rng, mn, rng
