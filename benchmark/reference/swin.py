"""The cube-padded Swin Transformer backbone and its CAM in plain PyTorch,
float32, TF32 off (``model.exact_f32()``).

Swin is Liu et al., "Swin Transformer: Hierarchical Vision Transformer using
Shifted Windows" (arXiv 2103.14030), with the settings of
microsoft/Swin-Transformer ``configs/swin/swin_base_patch4_window7_224.yaml``
(``swin_base``: patch 4, embed 128, depths 2-2-18-2, heads 4-8-16-32, window
7, MLP ratio 4, qkv bias, patch norm, no absolute position embedding,
LayerNorm eps 1e-5).  The layers follow ``models/swin_transformer.py`` of
that repository one by one: ``PatchEmbed``, ``WindowAttention`` (q scaled
by head_dim^-0.5, the relative-position bias gathered by its
``relative_position_index``, the mask added per window, softmax, the
product with v, proj), ``SwinTransformerBlock`` (norm1, the cyclic shift,
``window_partition``, attention, ``window_reverse``, the residual; norm2
and the MLP with exact GELU and its residual), ``PatchMerging`` (x0..x3
concatenated, norm, reduction) at the end of stages 1-3, and the head's
norm, mean and classifier.  Drop path and dropout are the identity at
inference.

CP-360 (arXiv 1806.01320) runs a backbone on each cube face with every
spatial padding cube-padded (``model.cube_pad``).  Departures from the
published model:

- The shifted layers' windows are the 7x7 tiles of each face's token grid
  cube-padded by 4 before and 3 after on each axis (:func:`shift_pad_map`,
  from ``geometry.cube_pad_map``'s strips and the published cube pad's
  corner rule), where the published code rolls the map by -3 and masks the
  wrapped slots.  The window boundaries are the published ones; a window at
  a face's edge is whole, its out-of-face slots taken from the neighbouring
  faces, with no mask; only the own-face slots' outputs are kept.  The cube
  pad's corner slots replicate the strips' edges, so a corner window's keys
  hold some tokens twice.  Regular layers, and stage 4 (its 7x7 grid is one
  window: the published rule gives it no shift), are per face as
  published.  ``use_cube_pad`` False gives the published roll and mask on
  each face.
- The CAM's features are the head's LayerNorm at each position of the last
  stage's map (the published head normalises each position, then pools, so
  the CAM's mean plus the bias is the logits).
- Every weight is random from a seed (``benchmark/lib/weights_swin.py``):
  kernels normal with std 1/sqrt(fan in), the relative-position tables
  N(0, 1), biases N(0, 0.05), LayerNorms at (1, 0), the classifier N(0,
  0.02).

Weights come in the benchmark's layout (``lib/weights_swin.py``).
``quant`` rounds what the program holds in its working precision, as
``model.conv`` does: each linear's operands and output, each LayerNorm's
output, the softmax's weights and the attention's output; the residual
stream is float32 in the program and is not rounded.  ``mask_edges`` masks
a cube-padded window's out-of-face slots as planar Swin's mask does (a
check's control, not the model).  It imports nothing of the program under
test.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import geometry
from benchmark.reference.model import (IMAGENET_MEAN, IMAGENET_STD, Quant, _q, cam_scores,
                                       conv, equi_to_cube)

LN_EPS = 1e-5
WINDOW = 7
PATCH = 4
MASK = -100.0


def layer_norm(x: torch.Tensor, p: dict, key: str = "ln", quant: Quant = None) -> torch.Tensor:
    """LayerNorm over the channels (the last axis) with ``p``'s
    ``<key>_w``, ``<key>_b``."""
    out = F.layer_norm(x, (x.shape[-1],), p[f"{key}_w"].float(), p[f"{key}_b"].float(), LN_EPS)
    return _q(quant, out)


def linear(x: torch.Tensor, w_oihw: torch.Tensor, b, quant: Quant = None) -> torch.Tensor:
    """``nn.Linear`` with a [out, in, 1, 1] kernel; ``quant`` rounds the
    operands and the output."""
    out = F.linear(_q(quant, x), _q(quant, w_oihw.float()[:, :, 0, 0]))
    if b is not None:
        out = out + b.float()
    return _q(quant, out)


def window_partition(x: torch.Tensor, m: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * H/m * W/m, m * m, C] (the published function)."""
    b, h, w, c = x.shape
    x = x.view(b, h // m, m, w // m, m, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, m * m, c)


def window_reverse(windows: torch.Tensor, m: int, h: int, w: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`: -> [B, H, W, C]."""
    b = windows.shape[0] // (h * w // m // m)
    x = windows.view(b, h // m, w // m, m, m, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(m: int) -> torch.Tensor:
    """[m*m, m*m] (the published ``relative_position_index`` buffer)."""
    coords = torch.stack(torch.meshgrid(torch.arange(m), torch.arange(m), indexing="ij"))
    flat = coords.flatten(1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0) + (m - 1)
    return rel[:, :, 0] * (2 * m - 1) + rel[:, :, 1]


def shift_pad_map(h: int, m: int = WINDOW) -> np.ndarray:
    """int64 [6, h+m, h+m]: the cube pad of m - m//2 before and m//2 after on
    each axis, a flat source in [6*h*h] for each padded token.  The strips
    are ``geometry.cube_pad_map``'s at each side's pad; the corners follow
    the published cube pad (model/cube_pad.py:83-90): the edge of the
    strip with the smaller pad is replicated across the corner, the
    top/down strip's on a tie."""
    pb, pa = m - m // 2, m // 2
    before, after = geometry.cube_pad_map(h, pb), geometry.cube_pad_map(h, pa)
    top, left = before[:, :pb, pb:pb + h], before[:, pb:pb + h, :pb]
    down, right = after[:, pa + h:, pa:pa + h], after[:, pa:pa + h, pa + h:]
    out = np.empty((6, h + m, h + m), np.int64)
    out[:, pb:pb + h, pb:pb + h] = before[:, pb:pb + h, pb:pb + h]
    out[:, :pb, pb:pb + h], out[:, pb + h:, pb:pb + h] = top, down
    out[:, pb:pb + h, :pb], out[:, pb:pb + h, pb + h:] = left, right

    def corner(td, lr, rows, cols):  # td [6, rows, 1], lr [6, 1, cols]
        return np.tile(lr, (1, rows, 1)) if rows > cols else np.tile(td, (1, 1, cols))

    out[:, :pb, :pb] = corner(top[:, :, :1], left[:, :1, :], pb, pb)
    out[:, :pb, pb + h:] = corner(top[:, :, -1:], right[:, :1, :], pb, pa)
    out[:, pb + h:, :pb] = corner(down[:, :, :1], left[:, -1:, :], pa, pb)
    out[:, pb + h:, pb + h:] = corner(down[:, :, -1:], right[:, -1:, :], pa, pa)
    return out


def attention(p: dict, xw: torch.Tensor, heads: int, quant: Quant = None,
              mask=None) -> torch.Tensor:
    """``WindowAttention.forward`` on windows [B_, N, C]; ``mask`` [nW, N, N]
    or None."""
    b_, n, c = xw.shape
    d = c // heads
    qkv = linear(xw, p["w_qkv"], p["b_qkv"], quant).reshape(b_, n, 3, heads, d)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    attn = (q * d ** -0.5) @ k.transpose(-2, -1)
    m = int(round(n ** 0.5))
    table = p["table"].float()
    bias = table[relative_position_index(m).to(table.device).reshape(-1)].view(n, n, -1)
    attn = attn + bias.permute(2, 0, 1)[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.view(b_ // nw, nw, heads, n, n) + mask[None, :, None]).view(-1, heads, n, n)
    attn = _q(quant, attn.softmax(dim=-1))
    out = _q(quant, (attn @ v).transpose(1, 2).reshape(b_, n, c))
    return linear(out, p["w_proj"], p["b_proj"], quant)


def _roll_mask(s: int, m: int, device) -> torch.Tensor:
    """The published shifted layer's ``attn_mask`` [nW, N, N] on an s x s grid."""
    shift = m // 2
    img = torch.zeros((1, s, s, 1), device=device)
    cnt = 0
    for hs in (slice(0, -m), slice(-m, -shift), slice(-shift, None)):
        for ws in (slice(0, -m), slice(-m, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = window_partition(img, m).squeeze(-1)
    diff = win[:, None, :] - win[:, :, None]
    return diff.masked_fill(diff != 0, MASK).masked_fill(diff == 0, 0.0)


def _edge_mask(s: int, m: int, device) -> torch.Tensor:
    """[nW, N, N] of the cube-padded windows: -100 between an own-face slot
    and an out-of-face one (planar Swin's edge)."""
    pb = m - m // 2
    own = torch.zeros((1, s + m, s + m, 1), device=device)
    own[:, pb:pb + s, pb:pb + s] = 1
    win = window_partition(own, m).squeeze(-1)
    return torch.where(win[:, None, :] != win[:, :, None], MASK, 0.0)


def swin_block(p: dict, x: torch.Tensor, shift: bool, quant: Quant = None,
               use_cube_pad: bool = True, mask_edges: bool = False) -> torch.Tensor:
    """``SwinTransformerBlock.forward`` on cubes [N, 6, S, S, C] of the f32
    stream, windows shifted by 3 when ``shift``."""
    n, six, s, _, c = x.shape
    heads, m = p["table"].shape[1], WINDOW
    y = layer_norm(x, p, "ln1", quant).reshape(n * six, s, s, c)
    if not shift:
        out = window_reverse(attention(p, window_partition(y, m), heads, quant), m, s, s)
    elif use_cube_pad:
        pb, g = m - m // 2, s + m
        idx = torch.from_numpy(shift_pad_map(s, m).reshape(-1)).to(x.device)
        yp = y.reshape(n, six * s * s, c)[:, idx].reshape(n * six, g, g, c)
        mask = _edge_mask(s, m, x.device) if mask_edges else None
        out = attention(p, window_partition(yp, m), heads, quant, mask)
        out = window_reverse(out, m, g, g)[:, pb:pb + s, pb:pb + s]
    else:
        shifted = torch.roll(y, shifts=(-(m // 2), -(m // 2)), dims=(1, 2))
        out = attention(p, window_partition(shifted, m), heads, quant,
                        _roll_mask(s, m, x.device))
        out = torch.roll(window_reverse(out, m, s, s), shifts=(m // 2, m // 2), dims=(1, 2))
    x = x + out.reshape(n, six, s, s, c)
    h = _q(quant, F.gelu(linear(layer_norm(x, p, "ln2", quant), p["w1"], p["b1"], quant)))
    return x + linear(h, p["w2"], p["b2"], quant)


def patch_merging(p: dict, x: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """``PatchMerging.forward`` on cubes [N, 6, S, S, C] -> [N, 6, S/2, S/2, 2C]."""
    x0, x1 = x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2]
    x2, x3 = x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]
    x = layer_norm(torch.cat([x0, x1, x2, x3], -1), p, "ln", quant)
    return linear(x, p["w"], None, quant)


def swin_trunk(bb: dict, faces01: torch.Tensor, quant: Quant = None, use_cube_pad: bool = True,
               mask_edges: bool = False) -> torch.Tensor:
    """Cube faces [N, 6, S, S, 3] in [0, 1] -> the last stage's map
    [N, 6, S/32, S/32, C] (the f32 stream)."""
    mean = torch.tensor(IMAGENET_MEAN, device=faces01.device)
    std = torch.tensor(IMAGENET_STD, device=faces01.device)
    x = (faces01 - mean) / std
    stem = bb["stem"]
    x = layer_norm(conv(x, stem["w"], PATCH, 0, quant, stem["b"]), stem, "ln", quant)
    for si, stage in enumerate(bb["stages"]):
        if si:
            x = patch_merging(bb["merges"][si - 1], x, quant)
        shifts = x.shape[2] > WINDOW  # the published rule: a grid of one window is not shifted
        for bi, p in enumerate(stage):
            x = swin_block(p, x, shifts and bi % 2 == 1, quant, use_cube_pad, mask_edges)
    return x


def swin_features(bb: dict, faces01: torch.Tensor, quant: Quant = None,
                  use_cube_pad: bool = True, mask_edges: bool = False) -> torch.Tensor:
    """Cube faces -> the CAM's features: the head's LayerNorm at each
    position of the last stage's map."""
    x = swin_trunk(bb, faces01, quant, use_cube_pad, mask_edges)
    return layer_norm(x, bb["head"], "ln", quant)


def logits(bb: dict, faces01: torch.Tensor, use_cube_pad: bool = True) -> torch.Tensor:
    """The published head: [N, 6, K] from the normalised, pooled features."""
    pooled = swin_features(bb, faces01, use_cube_pad=use_cube_pad).mean(dim=(2, 3))
    return pooled @ bb["fc_w"].float() + bb["fc_b"].float()


def frames_to_scores(bb: dict, frames_u8: torch.Tensor, face_w: int, quant: Quant = None,
                     block: int = 8) -> torch.Tensor:
    """Decoded frames [N, H, 2H, 3] u8 -> CAM cubes [N, 6, h, w, K] f32, in
    blocks of ``block`` frames."""
    out = []
    for i in range(0, frames_u8.shape[0], block):
        faces = equi_to_cube(frames_u8[i:i + block], face_w) / 255.0
        out.append(cam_scores(bb, swin_features(bb, faces, quant), quant))
    return torch.cat(out)
