"""Stage-2 temporal inference + evaluation over stage-1 artifacts.

The port of ``cp360_tpu/pipelines/temporal.py``.  Protocol parity with the reference
(temporal_model/test_temporal.py:19-115): sliding windows of ``seq_len``
CAM cubes at stride 1; each window is jointly min/max normalized; hidden
and cell state are seeded with the window's first normalized frame; the
ConvLSTM rolls over all ``seq_len`` frames; the prediction is the channel
max of the equi-projected final hidden state, saved as
{window_end:05}.npy and scored against the GT fixation map with AUC-Judd,
AUC-Borji, CC and SIM.  Independent windows ride the batch axis of one
rollout, and each artifact frame crosses to the device once per batch of
windows (:func:`window_infer_from_frames` gathers the windows there).

Scale-out: :func:`infer_video` splits each batch of windows over a
``parallel/mesh.py::LocalReplicas`` (one ConvLSTM copy per local device),
and :func:`window_infer_pipelined` runs the recurrence's time steps as
pipeline stages over a device list (``parallel/pipeline.py``).
"""

from __future__ import annotations

import os
import re
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from cp360_tpu_torch.metrics import saliency as M
from cp360_tpu_torch.models.clstm import ConvLSTM, clstm_rollout
from cp360_tpu_torch.ops.quantize import dequantize_cam, quantize_cam_np
from cp360_tpu_torch.ops.resample import cube_to_equi
from cp360_tpu_torch.parallel.mesh import LocalReplicas, check_divisible
from cp360_tpu_torch.parallel.pipeline import pipelined_rollout

PREFETCH_DEPTH = 3  # batches of artifacts read ahead of the device


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


def _window_index(positions: torch.Tensor, seq_len: int) -> torch.Tensor:
    return positions[:, None] + torch.arange(seq_len, device=positions.device)[None, :]


def window_infer_from_frames(cell: ConvLSTM, frames: torch.Tensor,
                             positions: torch.Tensor, seq_len: int = 5) -> torch.Tensor:
    """Window inference with the windows gathered on the device.

    Stride-1 windows share seq_len-1 of their frames, so the frames cross
    to the device once and the windows are sliced out there.

    Args:
      frames: [F, 6, h, w, C] consecutive CAM frames (any float dtype).
      positions: [B] int64 window starts into ``frames`` (+ seq_len <= F).

    Returns [B, 2h, 4w] predictions, equal to :func:`window_infer` on the
    stacked windows.
    """
    return window_infer(cell, frames[_window_index(positions, seq_len)])


def window_infer_from_frames_q(cell: ConvLSTM, q: torch.Tensor, scales: torch.Tensor,
                               positions: torch.Tensor, seq_len: int = 5) -> torch.Tensor:
    """:func:`window_infer_from_frames` fed by the int8 transfer codec:
    (q int8 [F, 6, h, w, C], scales [F, 6, 1, 1, C]); the gather runs on
    int8 and the windows dequantize on the device."""
    idx = _window_index(positions, seq_len)
    return window_infer(cell, dequantize_cam(q[idx], scales[idx]))


def window_infer_pipelined(cell: ConvLSTM, windows: torch.Tensor, devices: Sequence,
                           n_micro: int) -> torch.Tensor:
    """:func:`window_infer` with the recurrence pipelined over ``devices``:
    stage p runs time steps [p*T/P, (p+1)*T/P) and the windows flow
    through the stages as ``n_micro`` microbatches (microbatch m is in
    stage p while m+1 is in stage p-1).  Equal to :func:`window_infer`
    (the same ops in the same order on each microbatch); needs
    T % len(devices) == 0 and n_micro | B.  Returns [B, 2h, 4w] on
    ``windows``' device."""
    x, b = _normalize_windows(windows)
    _, h_final, _ = pipelined_rollout(cell, x, x[0], x[0], devices, n_micro)
    return _project_hidden(h_final, b)


def window_infer_from_frames_pipelined(cell: ConvLSTM, frames: torch.Tensor,
                                       positions: torch.Tensor, devices: Sequence,
                                       n_micro: int, seq_len: int = 5) -> torch.Tensor:
    """Pipelined form of :func:`window_infer_from_frames` (the same window
    gather on the device, the recurrence pipelined over ``devices``)."""
    return window_infer_pipelined(cell, frames[_window_index(positions, seq_len)],
                                  devices, n_micro)


def video_windows(feat_dir: str) -> List[int]:
    """Sorted artifact frame indices of a video's cube_feat directory.

    Window start positions are 0 .. N - seq_len - 1 in this sorted list,
    mirroring the reference loop bounds (test_temporal.py:57-63).  Strict
    NNNN.npy names only: a crashed writer's ``.tmp`` or a stray file must
    never appear as a frame and shift later windows off their GT ids.
    """
    return sorted(int(m.group(1)) for m in
                  (re.match(r"(\d+)\.npy$", f) for f in os.listdir(feat_dir)) if m)


def _cell_device(cell: ConvLSTM) -> torch.device:
    return next(iter([*cell.buffers(), *cell.parameters()])).device


def infer_video(cell: Union[ConvLSTM, LocalReplicas], feat_dir: str, seq_len: int,
                batch_windows: int = 64, transfer_codec: str = "none") -> Dict[int, np.ndarray]:
    """All window predictions for one video, on the cell's device, or split
    over the devices of a :class:`LocalReplicas` of the cell (each replica
    runs 1/N of every batch's windows; the frames go whole to each device,
    since overlapping windows share them).

    Returns {window position idx: prediction [2h, 4w] f32}; idx follows the
    reference's enumeration over the sorted frame list, and the saved/eval
    frame id is idx + seq_len - 1 (test_temporal.py:86-88,101-102).

    Batches of ``batch_windows`` windows are read from disk by an IO
    thread up to ``PREFETCH_DEPTH`` batches ahead of the device; each
    batch's frames ([F, 6, h, w, C], F = windows + seq_len - 1, in the
    artifact dtype) cross to the device once, from pinned memory on a
    card.  ``transfer_codec="int8"`` quantizes the frames on the IO thread
    (per face x channel, ops/quantize.py, f16 scales) so half the bytes
    cross and the device dequantizes.  The tail batch runs only its valid
    windows (with replicas, padded with its last window to a multiple of
    their count).
    """
    if transfer_codec not in ("none", "int8"):
        raise ValueError(f"transfer_codec={transfer_codec!r} is not one of 'none', 'int8'")
    replicas = cell if isinstance(cell, LocalReplicas) else None
    if replicas is not None:
        check_divisible(batch_windows, len(replicas), f"batch_windows={batch_windows}",
                        "so window positions shard evenly")
        device = replicas.device
    else:
        device = _cell_device(cell)
    pin = device.type == "cuda"
    frame_ids = video_windows(feat_dir)
    n = len(frame_ids)
    n_windows = max(0, n - seq_len)
    out: Dict[int, np.ndarray] = {}
    if n_windows == 0:
        return out

    def prepare(b0: int):
        """Read (and with int8, quantize) one batch's frames on the IO
        thread: [F, 6, h, w, C] NHWC host tensors, pinned on a card."""
        b1 = min(b0 + batch_windows, n_windows)
        paths = [os.path.join(feat_dir, f"{frame_ids[p]:06}.npy")
                 for p in range(b0, b1 + seq_len - 1)]
        frames = np.ascontiguousarray(
            np.stack([np.load(p) for p in paths]).transpose(0, 1, 3, 4, 2))
        arrays = quantize_cam_np(frames, np.float16) if transfer_codec == "int8" else (frames,)
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if pin:
            host = [t.pin_memory() for t in host]
        return b0, b1 - b0, host

    def flush(pending) -> None:
        b0, valid, preds_dev, _ = pending
        preds = preds_dev.cpu().numpy()
        for k in range(valid):
            out[b0 + k] = preds[k]

    starts = list(range(0, n_windows, batch_windows))
    with ThreadPoolExecutor(max_workers=2) as io_pool, torch.no_grad():
        prep_q: deque = deque(io_pool.submit(prepare, s) for s in starts[:PREFETCH_DEPTH])
        next_s = len(prep_q)
        pending = None  # (b0, valid, preds on the device, host tensors in flight)
        for _ in starts:
            b0, valid, host = prep_q.popleft().result()
            if next_s < len(starts):
                prep_q.append(io_pool.submit(prepare, starts[next_s]))
                next_s += 1
            dev = [t.to(device, non_blocking=True) for t in host]
            infer = (window_infer_from_frames_q if transfer_codec == "int8"
                     else window_infer_from_frames)
            if replicas is not None:
                n_pos = -(-valid // len(replicas)) * len(replicas)
                positions = torch.clamp(torch.arange(n_pos, device=device), max=valid - 1)
                preds = replicas.run(lambda m, *a: infer(m, *a, seq_len=seq_len),
                                     split=(positions,), shared=dev)
            else:
                preds = infer(cell, *dev, torch.arange(valid, device=device), seq_len)
            # the previous batch's copy to the host waits while this one
            # is queued on the device
            if pending is not None:
                flush(pending)
            pending = (b0, valid, preds, host)
        flush(pending)
    return out


def evaluate_video(preds: Dict[int, np.ndarray], gt_dir: str, seq_len: int,
                   rng=None) -> Dict[str, np.ndarray]:
    """Score window predictions against GT fixation maps; the GT file of
    window idx is {idx + seq_len - 1:05}.npy (test_temporal.py:101-102).
    The metrics draw from ``rng`` (default ``np.random``) in the
    reference's order: per frame Judd, then Borji."""
    auc, aucb, cc, sim = [], [], [], []
    for idx in sorted(preds):
        gt_path = os.path.join(gt_dir, f"{idx + seq_len - 1:05}.npy")
        if not os.path.exists(gt_path):
            continue
        gt = np.load(gt_path)
        p = preds[idx]
        auc.append(M.auc_judd(p, gt, rng=rng))
        aucb.append(M.auc_borji(p, gt, rng=rng))
        cc.append(M.corr_coeff(p, gt))
        sim.append(M.similarity(p, gt))
    return {"AUC": np.asarray(auc), "AUCB": np.asarray(aucb),
            "CC": np.asarray(cc), "SIM": np.asarray(sim)}


def aggregate(per_video: Dict[str, Dict[str, np.ndarray]],
              frame_counts: Dict[str, int]) -> Dict[str, float]:
    """Frame-count-weighted mean of per-video means (test_temporal.py:180-184)."""
    vids = list(per_video)
    total = sum(frame_counts[v] for v in vids)
    return {key: float(sum(np.mean(per_video[v][key]) * frame_counts[v] / total
                           for v in vids))
            for key in ("AUC", "AUCB", "CC", "SIM")}
