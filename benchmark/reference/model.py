"""The published model's math in plain PyTorch, float32, TF32 off.

Tensors are NHWC cube batches [N, 6, h, w, C] (faces B D F L R T), as the
published code lays out its cubes; every convolution permutes to NCHW for
``F.conv2d``.  Weights come in the benchmark's own layout
(``benchmark/lib/weights.py``): backbone kernels OIHW, ConvLSTM kernels
HWIO, batch norms as {scale, bias, mean, var}; each is widened to float32
here.

``quant`` (default: none) rounds what the program holds in its working
precision: both operands and the output of every convolution, the CAM's
features, the ConvLSTM's state and its projection.  The precision control of
the benchmark's checks passes a lower-precision rounding
(``quantize_fp8``); nothing else changes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference import geometry

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def exact_f32() -> None:
    """True float32 products: TF32 off for matmuls and cuDNN convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    """Float8 e4m3 with one scale per tensor (its largest magnitude to 448),
    back to float32."""
    s = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round_fp8(t)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g)


def quantize_fp8(t: torch.Tensor) -> torch.Tensor:
    """The precision one step below bfloat16: ``t`` rounded to float8, and
    in a backward pass its gradient too."""
    return _Fp8.apply(t)


def _q(quant: Quant, t: torch.Tensor) -> torch.Tensor:
    return t if quant is None else quant(t)


# ---- geometry -----------------------------------------------------------


def equi_to_cube(frames_u8: torch.Tensor, face_w: int) -> torch.Tensor:
    """[N, H, 2H, 3] u8 -> [N, 6, fw, fw, 3] f32 in [0, 255]: bilinear at the
    published maps' coordinates, border clamped."""
    n, h, w, c = frames_u8.shape
    in_x, in_y = geometry.equi2cube_maps(face_w, h, w)
    dev = frames_u8.device
    xs = torch.from_numpy(in_x).to(dev, torch.float32)
    ys = torch.from_numpy(in_y).to(dev, torch.float32)
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx, fy = (xs - x0)[..., None], (ys - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(0, w - 1), (y0 + 1).clamp(0, h - 1)
    x0, y0 = x0.clamp(0, w - 1), y0.clamp(0, h - 1)
    src = frames_u8.reshape(n, h * w, c).float()

    def tap(yi, xi):
        return src[:, (yi * w + xi).reshape(-1)].reshape(n, 6, face_w, face_w, c)

    return (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x1) * fx * (1 - fy)
            + tap(y1, x0) * (1 - fx) * fy + tap(y1, x1) * fx * fy)


def cube_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """[N, 6, h, h, C] -> [N, 6, h+2p, h+2p, C]."""
    n, _, h, _, c = x.shape
    idx = torch.from_numpy(geometry.cube_pad_map(h, p).reshape(-1)).to(x.device)
    return x.reshape(n, 6 * h * h, c)[:, idx].reshape(n, 6, h + 2 * p, h + 2 * p, c)


def cube_to_equi(x: torch.Tensor) -> torch.Tensor:
    """[N, 6, w, w, C] -> [N, 2w, 4w, C]."""
    n, _, w, _, c = x.shape
    m = torch.from_numpy(geometry.cube2equi_matrix(w)).to(x.device, torch.float32)
    return torch.matmul(m, x.reshape(n, 6 * w * w, c)).reshape(n, 2 * w, 4 * w, c)


# ---- layers ---------------------------------------------------------------


def conv(x: torch.Tensor, w_oihw: torch.Tensor, stride: int = 1, pad: int = 0,
         quant: Quant = None, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cube-padded ``pad`` (0: none) then a VALID conv (and ``bias``), NHWC
    cubes; ``quant`` rounds the input, the kernel and the output."""
    if pad:
        x = cube_pad(x, pad)
    n, six, h, w, c = x.shape
    xc = x.reshape(n * six, h, w, c).permute(0, 3, 1, 2)
    out = F.conv2d(_q(quant, xc), _q(quant, w_oihw.float()), stride=stride).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.float()
    return _q(quant, out.reshape(n, six, *out.shape[1:]))


def batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    inv = torch.rsqrt(p["var"].float() + BN_EPS) * p["scale"].float()
    return (x - p["mean"].float()) * inv + p["bias"].float()


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """Cube pad 1, then a 3x3 stride-2 VALID max pool."""
    xp = cube_pad(x, 1)
    n, six, h, w, c = xp.shape
    out = F.max_pool2d(xp.reshape(n * six, h, w, c).permute(0, 3, 1, 2), 3, 2)
    out = out.permute(0, 2, 3, 1)
    return out.reshape(n, six, *out.shape[1:])


# ---- stage 1: cube-padded ResNet and the class activation map ---------------


def resnet_features(bb: dict, faces01: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """ImageNet-normalized cube faces [N, 6, 224, 224, 3] in [0, 1] ->
    layer4 features [N, 6, 7, 7, C]."""
    mean = torch.tensor(IMAGENET_MEAN, device=faces01.device)
    std = torch.tensor(IMAGENET_STD, device=faces01.device)
    x = (faces01 - mean) / std
    x = torch.relu(batch_norm(conv(x, bb["conv1"], 2, 3, quant), bb["bn1"]))
    x = max_pool_3x3s2(x)
    for li, stage in enumerate(bb["stages"]):
        for bi, blk in enumerate(stage):
            s = 2 if (li > 0 and bi == 0) else 1
            out = torch.relu(batch_norm(conv(x, blk["conv1"], 1, 0, quant), blk["bn1"]))
            out = torch.relu(batch_norm(conv(out, blk["conv2"], s, 1, quant), blk["bn2"]))
            out = batch_norm(conv(out, blk["conv3"], 1, 0, quant), blk["bn3"])
            res = (batch_norm(conv(x, blk["downsample"], s, 0, quant), blk["bn_ds"])
                   if "downsample" in blk else x)
            x = torch.relu(out + res)
    return x


def cam_scores(bb: dict, feats: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """Per-face class maps with the non-negative shifted classifier weight."""
    w = bb["fc_w"].float()
    return torch.matmul(_q(quant, feats), w - torch.clamp(w.min(), max=0.0))


def frames_to_scores(bb: dict, frames_u8: torch.Tensor, face_w: int, quant: Quant = None,
                     block: int = 8) -> torch.Tensor:
    """Decoded frames [N, H, 2H, 3] u8 -> CAM cubes [N, 6, h, w, K] f32, in
    blocks of ``block`` frames."""
    out = []
    for i in range(0, frames_u8.shape[0], block):
        faces = equi_to_cube(frames_u8[i:i + block], face_w) / 255.0
        out.append(cam_scores(bb, resnet_features(bb, faces, quant), quant))
    return torch.cat(out)


# ---- stage 2: the cube-padded ConvLSTM -------------------------------------


def _hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    return w.float().permute(3, 2, 0, 1)


def clstm_step(cl: dict, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
               quant: Quant = None):
    """One step on [B, 6, h, w, C] cubes: three cube-padded 3x3 convs give
    the gates (input, forget, output, cell)."""
    def cv(name, inp):
        return conv(inp, _hwio_to_oihw(cl[name]["w"]), 1, 1, quant, cl[name]["b"])

    out = torch.relu(cv("conv1", torch.cat([x, h], dim=-1)))
    out = torch.relu(cv("conv2", out))
    i, f, o, g = torch.chunk(cv("gates", out), 4, dim=-1)
    c = _q(quant, torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g))
    return _q(quant, torch.sigmoid(o) * torch.tanh(c)), c


def clstm_rollout(cl: dict, seq: torch.Tensor, quant: Quant = None) -> List[torch.Tensor]:
    """[T, B, 6, h, w, C] normalized windows, state seeded with the first
    frame -> the T hidden states."""
    h = c = seq[0]
    hs = []
    for x in seq:
        h, c = clstm_step(cl, x, h, c, quant)
        hs.append(h)
    return hs


def window_saliency(cl: dict, windows: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """Raw CAM windows [B, T, 6, h, w, C] -> [B, 2h, 4w]: each window min/max
    normalized as a whole, rolled, its last hidden state projected and
    max-pooled over channels."""
    b = windows.shape[0]
    flat = windows.reshape(b, -1)
    mn = flat.amin(1).reshape(b, 1, 1, 1, 1, 1)
    mx = flat.amax(1).reshape(b, 1, 1, 1, 1, 1)
    norm = (windows - mn) / torch.where(mx > mn, mx - mn, torch.ones_like(mx))
    hs = clstm_rollout(cl, norm.movedim(1, 0), quant)
    return torch.amax(_q(quant, cube_to_equi(hs[-1])), dim=-1)


# ---- training: the weak-supervision losses and Adam -------------------------

PAIRS = 3  # consecutive prediction pairs in the losses


def _flow_grid(flow: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 2] pixel flow -> an align-corners grid_sample grid."""
    _, h, w, _ = flow.shape
    ys = torch.linspace(-1.0, 1.0, h, device=flow.device)
    xs = torch.linspace(-1.0, 1.0, w, device=flow.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx + flow[..., 0] / w * 2.0, gy + flow[..., 1] / h * 2.0], -1)


def train_loss(cl: dict, seq: torch.Tensor, flows: torch.Tensor, *, l_s: float, l_t: float,
               l_m: float, mm_th: float, flow_h: int, quant: Quant = None) -> torch.Tensor:
    """The published training objective (temporal_model/train_temporal.py)
    on a batch: seq [B, T, 6, h, w, C], flows [B, T, H, W, 2]; each window
    min/max normalized on its own; the last PAIRS+1 hidden states projected
    and max-pooled; smooth (flow-warp), temporal and motion-mask sum-MSE
    losses over consecutive pairs at the flows' resolution, the gradient
    through the later map of each pair only."""
    b = seq.shape[0]
    flat = seq.reshape(b, -1)
    mn = flat.amin(1).reshape(b, 1, 1, 1, 1, 1)
    rng = (seq - mn).reshape(b, -1).amax(1).reshape(b, 1, 1, 1, 1, 1)
    seqn = (seq - mn) / torch.where(rng > 0, rng, torch.ones_like(rng))
    hs = clstm_rollout(cl, seqn.movedim(1, 0), quant)[-(PAIRS + 1):]
    preds = torch.stack([torch.amax(_q(quant, cube_to_equi(h)), dim=-1)
                         for h in hs])  # [P+1, B, 2h, 4w]
    fh, fw = flows.shape[2], flows.shape[3]
    f2 = flows[:, 1:1 + PAIRS].movedim(1, 0).reshape(PAIRS * b, fh, fw, 2) * (flow_h / fw)

    def up(p):
        return F.interpolate(p.reshape(-1, 1, *p.shape[-2:]), size=(fh, fw), mode="bilinear",
                             align_corners=True)

    nxt = up(preds[1:])
    with torch.no_grad():
        cur = up(preds[:-1])
        warp = F.grid_sample(cur, _flow_grid(f2), mode="bilinear", padding_mode="zeros",
                             align_corners=True)
        static = (torch.sqrt(f2[..., 0] ** 2 + f2[..., 1] ** 2) < mm_th)[:, None]
        masked = torch.where(static, torch.zeros_like(nxt), nxt)
    return (l_s * torch.sum((nxt - warp) ** 2) + l_t * torch.sum((nxt - cur) ** 2)
            + l_m * torch.sum((nxt - masked) ** 2))


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected), in float32."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float):
        self.params, self.lr, self.t = list(params), lr, 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8))
