"""Stage-2 window inference (``cp360_tpu/pipelines/temporal.py:36-81``).

Protocol parity with the reference (temporal_model/test_temporal.py:19-115):
each window of ``seq_len`` CAM cubes is jointly min/max normalized; hidden
and cell state are seeded with the window's first normalized frame; the
ConvLSTM rolls over all ``seq_len`` frames; the prediction is the channel
max of the equi-projected final hidden state.  Independent windows ride the
batch axis of one rollout.
"""

from __future__ import annotations

import torch

from cp360_tpu_torch.models.clstm import ConvLSTM, clstm_rollout
from cp360_tpu_torch.ops.resample import cube_to_equi


def _normalize_windows(windows: torch.Tensor):
    """Joint per-window min/max normalization -> time-major face-flattened
    sequence [T, B*6, h, w, C] (the published protocol's input form)."""
    windows = windows.float()
    b, t = windows.shape[0], windows.shape[1]
    flat = windows.reshape(b, -1)
    mn = flat.amin(dim=1).reshape(b, 1, 1, 1, 1, 1)
    mx = flat.amax(dim=1).reshape(b, 1, 1, 1, 1, 1)
    # Deliberate divergence, kept from the JAX package: the reference NaNs
    # on a constant window (test_temporal.py:66-71 divides by max-min == 0);
    # here a constant window normalizes to zeros so outputs stay finite.
    denom = torch.where(mx > mn, mx - mn, torch.ones_like(mx))
    norm = (windows - mn) / denom
    return norm.movedim(1, 0).reshape(t, b * 6, *windows.shape[3:]), b


def _project_hidden(h_final: torch.Tensor, b: int) -> torch.Tensor:
    """Final hidden cube -> channel-max equi map [B, 2h, 4w]
    (test_temporal.py:82-85)."""
    cubes = h_final.reshape(b, 6, *h_final.shape[1:])
    equi = cube_to_equi(cubes)  # [B, 2h, 4w, C]
    return torch.amax(equi, dim=-1)


def window_infer(cell: ConvLSTM, windows: torch.Tensor) -> torch.Tensor:
    """Batched window inference.

    Args:
      windows: [B, T, 6, h, w, C] raw (un-normalized) CAM cubes (any float
        dtype; the normalization runs in f32).

    Returns [B, 2h, 4w] equi saliency predictions (f32).
    """
    x, b = _normalize_windows(windows)
    h0 = c0 = x[0]
    _, h_final, _ = clstm_rollout(cell, x, h0, c0)
    return _project_hidden(h_final, b)
