"""Saliency evaluation metrics — bit-faithful to the reference protocol.

The port's copy of ``cp360_tpu/metrics/saliency.py`` (reference
utils/eval_saliency.py:14-190), pure numpy.  These four functions define
the published numbers (AUC-Judd 0.898 / CC 0.494 / AUC-Borji 0.874,
README.md:24), so their quirks are reproduced deliberately:

- **The 240x120 resize is bilinear, not Lanczos.**  The reference calls
  ``cv2.resize(map, (240, 120), cv2.INTER_LANCZOS4)``, but cv2.resize's
  third positional argument is ``dst``, not ``interpolation``: the call
  resizes bilinearly.  cv2 is imported when a map needs resizing, if it is
  installed; without it :func:`_resize_bilinear_np` computes cv2's
  INTER_LINEAR in numpy (the tests hold both branches equal).
- Fixations are GT pixels above mean+2*std of the *continuous* GT map
  (eval_saliency.py:49,123), not a binary fixation list.
- AUC-Borji clips saliency above mean+2*std to 1.0 before normalizing
  (eval_saliency.py:37-40); AUC-Judd jitters by randn/1e7 instead
  (eval_saliency.py:106-109).
- The random draws replay the reference's ``np.random`` stream: Judd's
  ``randn`` over the whole 120x240 map, then Borji's
  ``randint((n_fix, 100))`` splits, per frame in that order.
- Trapezoidal integration with 0/1 endpoint padding.

AUC-Judd uses a sort + searchsorted instead of the reference's
O(Nfix * Npixels) threshold loop; AUC-Borji vectorizes each split's
threshold sweep.  Same results.
"""

from __future__ import annotations

import importlib.util

import numpy as np

_HAVE_CV2 = importlib.util.find_spec("cv2") is not None

_EVAL_W, _EVAL_H = 240, 120


def _trapz(y, x):
    f = getattr(np, "trapezoid", None) or np.trapz
    return f(y, x)


def resize_eval(m: np.ndarray) -> np.ndarray:
    """Resize a map to the 240x120 evaluation grid (bilinear; see module doc)."""
    m = np.asarray(m, dtype=np.float32)
    if m.shape == (_EVAL_H, _EVAL_W):
        return m.copy()
    if _HAVE_CV2:
        import cv2

        return cv2.resize(m, (_EVAL_W, _EVAL_H), interpolation=cv2.INTER_LINEAR)
    return _resize_bilinear_np(m, _EVAL_H, _EVAL_W)


def _resize_bilinear_np(m: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2 INTER_LINEAR-compatible bilinear resize (half-pixel centers)."""
    in_h, in_w = m.shape
    sy, sx = in_h / out_h, in_w / out_w
    ys = (np.arange(out_h) + 0.5) * sy - 0.5
    xs = (np.arange(out_w) + 0.5) * sx - 0.5
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    fy = ys - y0
    fx = xs - x0
    y0c = np.clip(y0, 0, in_h - 1)
    y1c = np.clip(y0 + 1, 0, in_h - 1)
    x0c = np.clip(x0, 0, in_w - 1)
    x1c = np.clip(x0 + 1, 0, in_w - 1)
    fy = np.clip(fy, 0.0, 1.0)[:, None]
    fx = np.clip(fx, 0.0, 1.0)[None, :]
    a = m[np.ix_(y0c, x0c)]
    b = m[np.ix_(y0c, x1c)]
    c = m[np.ix_(y1c, x0c)]
    d = m[np.ix_(y1c, x1c)]
    return (
        a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + c * fy * (1 - fx) + d * fy * fx
    ).astype(np.float32)


def _check_fixations(fixation_map: np.ndarray) -> None:
    if not np.any(fixation_map):
        raise ValueError("fixation map is empty")


def auc_judd(saliency_map, fixation_map, jitter: bool = True, rng=None) -> float:
    """AUC-Judd (reference eval_saliency.py:90-146)."""
    _check_fixations(fixation_map)
    rng = np.random if rng is None else rng
    s = resize_eval(saliency_map).astype(np.float64)
    f = resize_eval(fixation_map).astype(np.float64)

    if jitter:
        s = s + rng.randn(*s.shape) / 1e7
    smin, smax = s.min(), s.max()
    s = (s - smin) / (smax - smin)

    sth = s[f > f.mean() + 2 * f.std()]
    n_fix = sth.size
    n_pix = s.size
    if n_fix == 0:
        return float("nan")

    thresholds = np.sort(sth)[::-1]
    # sum(S >= t) via a sorted copy of S (ascending) — equals the reference's
    # per-threshold full-array comparison.
    s_sorted = np.sort(s, axis=None)
    above = n_pix - np.searchsorted(s_sorted, thresholds, side="left")

    tp = np.empty(n_fix + 2)
    fp = np.empty(n_fix + 2)
    tp[0], tp[-1] = 0.0, 1.0
    fp[0], fp[-1] = 0.0, 1.0
    i = np.arange(n_fix)
    tp[1:-1] = i / n_fix
    fp[1:-1] = (above - i) / (n_pix - n_fix)
    return float(_trapz(tp, fp))


def auc_borji(
    saliency_map, fixation_map, n_splits: int = 100, step_size: float = 0.01, rng=None
) -> float:
    """AUC-Borji (reference eval_saliency.py:14-87)."""
    _check_fixations(fixation_map)
    rng = np.random if rng is None else rng
    s = resize_eval(saliency_map).astype(np.float64)
    f = resize_eval(fixation_map).astype(np.float64)

    s[s > s.mean() + 2 * s.std()] = 1.0
    smin, smax = s.min(), s.max()
    s = (s - smin) / (smax - smin)

    s_flat = s.ravel()
    f_flat = f.ravel()
    sth = s_flat[f_flat > f_flat.mean() + 2 * f_flat.std()]
    n_fix = sth.size
    n_pix = s_flat.size
    if n_fix == 0:
        return float("nan")

    rr = rng.randint(0, high=n_pix, size=(n_fix, n_splits))
    randfix = s_flat[rr]

    aucs = []
    for ss in range(n_splits):
        curfix = randfix[:, ss]
        hi = max(sth.max(), curfix.max() if curfix.size else 0.0)
        thresholds = np.arange(0.0, hi, step_size)[::-1]
        tp = np.empty(thresholds.size + 2)
        fp = np.empty(thresholds.size + 2)
        tp[0], tp[-1] = 0.0, 1.0
        fp[0], fp[-1] = 0.0, 1.0
        tp[1:-1] = (sth[None, :] >= thresholds[:, None]).sum(1) / float(n_fix)
        fp[1:-1] = (curfix[None, :] >= thresholds[:, None]).sum(1) / float(n_fix)
        aucs.append(_trapz(tp, fp))
    return float(np.mean(aucs))


def corr_coeff(map1, map2) -> float:
    """Pearson correlation after z-scoring (reference eval_saliency.py:149-176)."""
    a = resize_eval(map1).astype(np.float64)
    b = resize_eval(map2).astype(np.float64)
    a = (a - a.mean()) / a.std()
    b = (b - b.mean()) / b.std()
    num = np.sum((a - a.mean()) * (b - b.mean()))
    den = np.sqrt(np.sum((a - a.mean()) ** 2) * np.sum((b - b.mean()) ** 2))
    return float(num / den)


def similarity(map1, map2) -> float:
    """Histogram intersection of sum-normalized maps (eval_saliency.py:179-190)."""
    a = resize_eval(map1).astype(np.float64)
    b = resize_eval(map2).astype(np.float64)
    a = (a - a.min()) / (a.max() - a.min())
    a = a / a.sum()
    b = (b - b.min()) / (b.max() - b.min())
    b = b / b.sum()
    return float(np.minimum(a, b).sum())

