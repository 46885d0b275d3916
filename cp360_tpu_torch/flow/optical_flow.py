"""Optical flow: the host OpenCV path and a pyramidal Horn-Schunck solver on
the device, in plain PyTorch.

The port of ``cp360_tpu/flow/optical_flow.py``.  The reference wraps
OpenCV-contrib DeepFlow (utils/optical_flow.py:24-29); this module keeps:

1. :func:`calc_optical_flow`, the host path with the reference wrapper's
   pre- and post-processing (LANCZOS resize to ``res``, channel reversal +
   BGR2GRAY, min-max-normalized magnitude with values under mean - 1.5 std
   zeroed, utils/optical_flow.py:18-38): DeepFlow when this cv2 has
   ``cv2.optflow``, else Farneback, the reference's own commented-in-source
   alternative (utils/optical_flow.py:32);
2. :func:`horn_schunck_flow_batch`, a multi-scale Horn-Schunck solver with
   warping, on whatever device its tensors live on.

The JAX solvers are explicit shift / multiply-add stencils that XLA fuses;
none reaches a Pallas kernel.  Here they are the same stencils as eager
torch ops, in the JAX package's operation order, so each f32 value rounds
as it does there.  The pair axis is a leading batch axis [N, H, W] in place
of ``vmap``; a single pair is a batch of one.  Inside the solver the flow is
held as one [N, 2, H, W] tensor (u, v stacked), so each elementwise stencil
launches once for both components: the same per-element arithmetic.

cv2 and PIL are imported where they are used.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_FARNEBACK_PARAMS = dict(
    pyr_scale=0.5, levels=7, winsize=15, iterations=3, poly_n=5, poly_sigma=1.2, flags=0
)
DEVICE_BACKENDS = ("horn_schunck", "variational")
HOST_BACKENDS = ("farneback", "deepflow")
LINK_DTYPES = {"float16": torch.float16, "float32": torch.float32}


def _have_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def _preprocess_pair(
    prev_frame: np.ndarray, cur_frame: np.ndarray, res: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """The reference wrapper's preprocessing (utils/optical_flow.py:18-23),
    shared by every backend: LANCZOS resize to ``res`` = (width, height),
    channel reversal + BGR2GRAY (the deliberate BGR-as-RGB quirk), u8
    grayscale out.  Without cv2, PIL's luma of the reversed channels."""
    if _have_cv2():
        import cv2

        prev = cv2.resize(prev_frame[..., ::-1], res, interpolation=cv2.INTER_LANCZOS4)
        cur = cv2.resize(cur_frame[..., ::-1], res, interpolation=cv2.INTER_LANCZOS4)
        prev = cv2.cvtColor(prev, cv2.COLOR_BGR2GRAY)
        cur = cv2.cvtColor(cur, cv2.COLOR_BGR2GRAY)
    else:  # plain luma (the device backends only need "a grayscale")
        from PIL import Image

        prev = np.asarray(Image.fromarray(prev_frame[..., ::-1]).convert("L").resize(res))
        cur = np.asarray(Image.fromarray(cur_frame[..., ::-1]).convert("L").resize(res))
    return prev, cur


def _postprocess_magnitude(flow: np.ndarray) -> np.ndarray:
    absflow = np.sqrt(flow[:, :, 0] ** 2 + flow[:, :, 1] ** 2)
    absflow = absflow - absflow.min()
    mx = absflow.max()
    if mx > 0:
        absflow = absflow / mx
    absflow[absflow < (absflow.mean() - 1.5 * absflow.std())] = 0
    return absflow


def calc_optical_flow(
    prev_frame: np.ndarray, cur_frame: np.ndarray, res: Tuple[int, int] = (960, 480)
) -> Tuple[np.ndarray, np.ndarray]:
    """Flow between two BGR frames at ``res`` = (width, height), on the host.

    Returns (absflow [H, W], flow [H, W, 2] f32) like the reference wrapper
    (utils/optical_flow.py:7-39).  DeepFlow if this cv2 has contrib
    ``optflow``, else Farneback.
    """
    if not _have_cv2():
        raise RuntimeError("cv2 unavailable; use horn_schunck_flow_batch for the device path")
    import cv2

    prev, cur = _preprocess_pair(prev_frame, cur_frame, res)
    if hasattr(cv2, "optflow") and hasattr(cv2.optflow, "createOptFlow_DeepFlow"):
        df = cv2.optflow.createOptFlow_DeepFlow()
        flow = df.calc(prev, cur, np.zeros((*prev.shape, 2), np.float32))
    else:
        p = _FARNEBACK_PARAMS
        flow = cv2.calcOpticalFlowFarneback(
            prev, cur, None, p["pyr_scale"], p["levels"], p["winsize"],
            p["iterations"], p["poly_n"], p["poly_sigma"], p["flags"],
        )
    return _postprocess_magnitude(flow), flow


# ---------------------------------------------------------------------------
# Stencils on [..., H, W] (rows, columns last)
# ---------------------------------------------------------------------------


def _pad_edge(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """Edge (replicate) padding of the last two dims, any leading dims."""
    lead = x.shape[:-2]
    flat = x.reshape(-1, *x.shape[-2:])
    out = F.pad(flat, (left, right, top, bottom), mode="replicate")
    return out.reshape(*lead, *out.shape[-2:])


def _avg_neighbors(u: torch.Tensor) -> torch.Tensor:
    """Weighted neighborhood average (Horn-Schunck Laplacian surrogate):
    1/6 edge neighbors + 1/12 diagonal neighbors, edges clamped."""
    h, w = u.shape[-2:]
    up = _pad_edge(u, 1, 1, 1, 1)

    def s(dy, dx):
        return up[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    edge = s(-1, 0) + s(1, 0) + s(0, -1) + s(0, 1)
    diag = s(-1, -1) + s(-1, 1) + s(1, -1) + s(1, 1)
    return edge * (1 / 6) + diag * (1 / 12)


def _binom5_axis(img: torch.Tensor, axis: int) -> torch.Tensor:
    """[1, 4, 6, 4, 1]/16 along ``axis`` (-2 rows, -1 columns), edges
    clamped (shift/add form)."""
    h, w = img.shape[-2:]
    if axis == -2:
        up = _pad_edge(img, 2, 2, 0, 0)

        def s(d):
            return up[..., 2 + d:2 + d + h, :]
    else:
        up = _pad_edge(img, 0, 0, 2, 2)

        def s(d):
            return up[..., 2 + d:2 + d + w]

    return (s(-2) + s(2)) * (1 / 16) + (s(-1) + s(1)) * (4 / 16) + s(0) * (6 / 16)


def _gauss5(img: torch.Tensor) -> torch.Tensor:
    """5x5 binomial pre-smoothing (stabilizes the derivative estimates)."""
    return _binom5_axis(_binom5_axis(img, -2), -1)


def _median3(u: torch.Tensor) -> torch.Tensor:
    """3x3 median filter, edges clamped: the exact middle of the 9 values
    (the classic MedianFilter step of warping-based flow)."""
    h, w = u.shape[-2:]
    up = _pad_edge(u, 1, 1, 1, 1)
    stack = torch.stack([up[..., dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)])
    return torch.median(stack, dim=0).values


def _grad(img: torch.Tensor):
    """Central differences with wrap-around at the borders (``roll``, as
    the JAX package computes them)."""
    ix = (torch.roll(img, -1, -1) - torch.roll(img, 1, -1)) * 0.5
    iy = (torch.roll(img, -1, -2) - torch.roll(img, 1, -2)) * 0.5
    return ix, iy


def _warp_valid(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Warp [N, H, W] ``img`` by (u, v) with border-clamped bilinear
    sampling, and the in-bounds mask.

    Zero padding here (as grid_sample's default does) poisons the data
    term: pixels whose sample leaves the frame see a large spurious
    brightness difference that the smoothness term diffuses inward; so
    out-of-frame samples carry zero data weight instead."""
    n, h, w = img.shape
    gy = torch.arange(h, dtype=torch.float32, device=img.device).reshape(h, 1)
    gx = torch.arange(w, dtype=torch.float32, device=img.device).reshape(1, w)
    sx = gx + u
    sy = gy + v
    valid = ((sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)).float()
    sx = torch.clamp(sx, 0.0, w - 1.0)
    sy = torch.clamp(sy, 0.0, h - 1.0)
    x0f = torch.floor(sx)
    y0f = torch.floor(sy)
    fx = sx - x0f
    fy = sy - y0f
    x0 = x0f.long()
    y0 = y0f.long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    flat = img.reshape(n, h * w)

    def g(yi, xi):
        return torch.gather(flat, 1, (yi * w + xi).reshape(n, h * w)).reshape(n, h, w)

    out = (g(y0, x0) * (1 - fx) * (1 - fy) + g(y0, x1) * fx * (1 - fy)
           + g(y1, x0) * (1 - fx) * fy + g(y1, x1) * fx * fy)
    return out, valid


def _f32_square(x: float) -> float:
    """x * x rounded to f32, as the JAX solvers square their traced f32
    ``alpha`` (alpha ** 2 in double would round differently)."""
    return float(np.float32(x) * np.float32(x))


def _hs_increment(a, bw, valid, uv0, alpha, iters):
    """Jacobi iterations for the TOTAL flow [N, 2, H, W] with the data term
    linearized at uv0: bw is the second frame pre-warped by uv0,
    derivatives average both frames, out-of-frame samples carry zero data
    weight."""
    ax, ay = _grad(a)
    bx, by = _grad(bw)
    ix = 0.5 * (ax + bx) * valid
    iy = 0.5 * (ay + by) * valid
    it = (bw - a) * valid
    den = (_f32_square(alpha) + ix * ix + iy * iy)[:, None]
    ixy = torch.stack([ix, iy], 1)
    uv = uv0
    for _ in range(iters):
        bar = _avg_neighbors(uv)
        d = bar - uv0
        num = ix * d[:, 0] + iy * d[:, 1] + it
        uv = bar - ixy * num[:, None] / den
    return uv


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean, odd last rows and columns cropped first.  The four values
    add in row-major order, one after another, as XLA on the CPU sums the
    JAX package's mean at most shapes; written out, so the card sums in
    the same order."""
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    x = img[..., :h - h % 2, :w - w % 2].reshape(*lead, h // 2, 2, w // 2, 2)
    return (x[..., 0, :, 0] + x[..., 0, :, 1] + x[..., 1, :, 0] + x[..., 1, :, 1]) * 0.25


def _up2_axis(x: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    """2x bilinear upsample along ``axis`` (-2 rows, -1 columns; box-center
    convention: output k samples input position (k - 0.5) / 2), shift /
    interleave form; n_out = 2n + 1 (odd pyramid levels) repeats the edge."""
    n = x.shape[axis]
    up = _pad_edge(x, 1, 1, 0, 0) if axis == -2 else _pad_edge(x, 0, 0, 1, 1)

    def s(d):
        return up.narrow(axis, 1 + d, n)

    even = x * 0.75 + s(-1) * 0.25  # out[2i]
    odd = x * 0.75 + s(1) * 0.25  # out[2i + 1]
    inter = torch.stack([even, odd], dim=axis)
    shape = list(x.shape)
    shape[axis] = 2 * n
    inter = inter.reshape(shape)
    if n_out == 2 * n:
        return inter
    if n_out > 2 * n:  # odd source level: replicate the last edge rows
        last = inter.narrow(axis, 2 * n - 1, 1)
        reps = [1] * inter.ndim
        reps[axis] = n_out - 2 * n
        return torch.cat([inter, last.repeat(reps)], dim=axis)
    return inter.narrow(axis, 0, n_out)


def _upsample2(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    return _up2_axis(_up2_axis(img, -2, out_h), -1, out_w)


def _pyramid(prev_gray: torch.Tensor, cur_gray: torch.Tensor, levels: int, presmooth: bool):
    i1 = prev_gray.float()
    i2 = cur_gray.float()
    if presmooth:
        i1, i2 = _gauss5(i1), _gauss5(i2)
    pyr = [(i1, i2)]
    for _ in range(levels - 1):
        i1 = _downsample2(i1)
        i2 = _downsample2(i2)
        pyr.append((i1, i2))
    return pyr


def _check_pairs(prev_gray: torch.Tensor, cur_gray: torch.Tensor) -> None:
    if prev_gray.ndim != 3 or prev_gray.shape != cur_gray.shape:
        raise ValueError(f"pairs must be two [N, H, W] batches of one shape, got "
                         f"{tuple(prev_gray.shape)} and {tuple(cur_gray.shape)}")
    if prev_gray.device != cur_gray.device:
        raise ValueError(f"pairs on different devices: {prev_gray.device}, {cur_gray.device}")


@torch.no_grad()
def horn_schunck_flow_batch(
    prev_gray: torch.Tensor,
    cur_gray: torch.Tensor,
    alpha: float = 0.1,
    levels: int = 5,
    iters: int = 100,
    n_warp: int = 2,
    presmooth: bool = True,
    median: bool = True,
) -> torch.Tensor:
    """Dense flow [N, H, W, 2] f32 (dx, dy) between [N, H, W] grayscale
    pairs, on their device (``cp360_tpu/flow/optical_flow.py:258,313``).

    Coarse-to-fine Horn-Schunck with warping: per level, ``n_warp`` rounds
    of (warp frame 2 by the current flow -> Jacobi-solve the linearized data
    term for the total flow -> 3x3 median filter), the result 2x upsampled
    (values doubled) as the next level's init.

    ``alpha`` is the smoothness weight in intensity units: ~0.1 suits
    [0, 1]-scaled images.
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
            bw, valid = _warp_valid(b, uv[:, 0], uv[:, 1])
            uv = _hs_increment(a, bw, valid, uv, alpha, iters)
            if median:
                uv = _median3(uv)
    return uv.permute(0, 2, 3, 1).contiguous()


def horn_schunck_flow(prev_gray: torch.Tensor, cur_gray: torch.Tensor, **kw) -> torch.Tensor:
    """One [H, W] pair -> [H, W, 2]: :func:`horn_schunck_flow_batch` on a
    batch of one."""
    return horn_schunck_flow_batch(prev_gray[None], cur_gray[None], **kw)[0]


# ---------------------------------------------------------------------------
# Wrappers: frames in, flows out
# ---------------------------------------------------------------------------


def u8_to_unit(x_u8: torch.Tensor) -> torch.Tensor:
    """u8 -> f32 / 255, an IEEE division on every device (the divisor is a
    tensor: torch on CUDA turns a division by a Python scalar into a
    product with its reciprocal, which can differ by one ulp)."""
    return x_u8.float() / torch.full((), 255.0, device=x_u8.device)


def _batch_solver(backend: str):
    if backend == "horn_schunck":
        return horn_schunck_flow_batch
    if backend == "variational":
        from cp360_tpu_torch.flow.variational import brox_flow_batch

        return brox_flow_batch
    raise ValueError(f"no device batch solver for flow backend {backend!r}")


def _solve_u8(backend: str, prev_u8, cur_u8, device: torch.device) -> torch.Tensor:
    prev = torch.as_tensor(prev_u8).to(device)
    cur = torch.as_tensor(cur_u8).to(device)
    return _batch_solver(backend)(u8_to_unit(prev), u8_to_unit(cur))


def calc_optical_flow_device(
    prev_frame: np.ndarray, cur_frame: np.ndarray, res: Tuple[int, int] = (960, 480),
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Device drop-in for :func:`calc_optical_flow` (config ``flow_backend:
    horn_schunck``): the host does the resize and grayscale, the
    Horn-Schunck solver runs on ``device`` (the card by default; raises
    without one)."""
    from cp360_tpu_torch.serving.server import resolve_device

    dev = resolve_device(device)
    prev, cur = _preprocess_pair(prev_frame, cur_frame, res)
    flow = _solve_u8("horn_schunck", prev[None], cur[None], dev)[0].cpu().numpy()
    return _postprocess_magnitude(flow), flow


def calc_optical_flow_batched(pairs, res: Tuple[int, int] = (960, 480),
                              backend: str = "horn_schunck", device="cuda"):
    """Flow over a list of (prev_bgr, cur_bgr) pairs: a device backend
    solves the stacked grayscale pairs in one batch on ``device``; a host
    backend loops over the pairs.  Returns a list of (absflow [H, W],
    flow [H, W, 2]) in pair order, the per-pair wrapper's results."""
    if backend in HOST_BACKENDS:
        return [calc_optical_flow(p, c, res) for p, c in pairs]
    from cp360_tpu_torch.serving.server import resolve_device

    _batch_solver(backend)  # an unknown backend raises before any work
    dev = resolve_device(device)
    grays = [_preprocess_pair(p, c, res) for p, c in pairs]
    flows = _solve_u8(backend, np.stack([g[0] for g in grays]),
                      np.stack([g[1] for g in grays]), dev).cpu().numpy()
    return [(_postprocess_magnitude(f), f) for f in flows]


def get_batch_solver_u8(backend: str, link_dtype: str = "float32", device="cuda"):
    """The extraction's batch solver: ([N, H, W] u8, [N, H, W] u8) -> [N, H, W,
    2] flow on ``device`` in ``link_dtype`` (float16 or float32).

    The u8 pairs cross to the device (4x fewer bytes than f32), /255 and the
    solve run there, and the result is cast to the link dtype on the device,
    so with float16 the copy back halves too.  Cached per (backend, dtype,
    device)."""
    from cp360_tpu_torch.serving.server import resolve_device

    return _batch_solver_u8_cached(backend, link_dtype, resolve_device(device))


@lru_cache(maxsize=8)
def _batch_solver_u8_cached(backend: str, link_dtype: str, device: torch.device):
    _batch_solver(backend)
    if link_dtype not in LINK_DTYPES:
        raise ValueError(f"flow_link_dtype={link_dtype!r} must be 'float16' or 'float32'")
    dt = LINK_DTYPES[link_dtype]

    def fn(prev_u8, cur_u8) -> torch.Tensor:
        return _solve_u8(backend, prev_u8, cur_u8, device).to(dt)

    return fn


def get_flow_fn(backend: str = "farneback"):
    """Per-pair flow by backend: 'farneback' (host cv2), 'horn_schunck'
    (device), 'variational' (device, the DeepFlow/Brox energy,
    flow/variational.py), 'deepflow' (host cv2-contrib, where present)."""
    if backend == "horn_schunck":
        return calc_optical_flow_device
    if backend == "variational":
        from cp360_tpu_torch.flow.variational import calc_optical_flow_variational

        return calc_optical_flow_variational
    if backend in HOST_BACKENDS:
        return calc_optical_flow
    raise ValueError(f"unknown flow backend {backend!r}")
