"""Heatmap overlay (host-side, PIL/numpy), for ``-oi`` and ``--overlay``.

The port's copy of ``jet_colormap`` and ``overlay`` from
``cp360_tpu/imaging/overlay.py`` (reference utils/utils.py:9-25): a
jet-colorized heatmap, bicubically resized onto the frame, 50% alpha blend.
PIL is imported when an overlay is drawn, matplotlib (for the exact 'jet'
table) when it is installed, with a piecewise-linear jet otherwise.
"""

from __future__ import annotations

import numpy as np


def jet_colormap(values01: np.ndarray) -> np.ndarray:
    """Matplotlib-'jet' RGB uint8 for values in [0, 1]."""
    try:
        import matplotlib.pyplot as plt

        return plt.get_cmap("jet")(values01, bytes=True)[..., :3]
    except ImportError:  # matplotlib-free jet
        v = np.clip(values01, 0.0, 1.0)
        r = np.clip(1.5 - np.abs(4 * v - 3), 0, 1)
        g = np.clip(1.5 - np.abs(4 * v - 2), 0, 1)
        b = np.clip(1.5 - np.abs(4 * v - 1), 0, 1)
        return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def overlay(img, heatmap, alpha: float = 0.5):
    """Blend a heatmap over an image (reference utils/utils.py:9-25).

    img: PIL image or [H, W, 3] uint8 array; heatmap: PIL image or 2-D
    array (min/max normalized, jet-colored).  Returns a PIL image."""
    from PIL import Image

    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    if isinstance(heatmap, np.ndarray):
        hm = heatmap - np.min(heatmap)
        mx = np.max(hm)
        if mx > 0:
            hm = hm / mx
        heatmap = Image.fromarray(jet_colormap(hm), mode="RGB")
    resample = getattr(Image, "BICUBIC", None) or Image.Resampling.BICUBIC
    heatmap = heatmap.resize((img.size[0], img.size[1]), resample=resample)
    return Image.blend(img.convert("RGB"), heatmap, alpha)
