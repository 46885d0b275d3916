"""Streaming end-to-end pipeline: video frames -> temporal saliency, no disk.

The port of ``cp360_tpu/pipelines/stream.py``.  The reference is two
offline stages coupled through ``.npy`` artifacts; this pipeline fuses
them for deployment: decoded frames are cube-sampled on a pool of host
threads (``host_faces_for_upload``, rgb8 or yuv420), go through the
stage-1 CAM step in device batches, and the f16 CAM cubes stay on the
device, where a carry of the last ``seq_len - 1`` real frames bridges the
batches.  Every complete window runs the stage-2 protocol (joint min/max
normalization, state seeded with the first frame) and only the [2h, 4w]
saliency maps come back.

Yields (frame_id, saliency [2h, 4w]) with the offline pipeline's saved/GT
numbering.  One deliberate difference from the offline loop: its bound
skips the final complete window (``idx >= len(seq) - num_subseq``,
test_temporal.py:61-62); the stream emits it, so the offline maps are a
strict prefix of the stream's.

With ``pipeline_stages`` P > 1 each batch's windows go through the
pipelined window inference (``pipelines/temporal.py::
window_infer_from_frames_pipelined``): the seq_len time steps run as P
stages over P devices of the model's kind, the windows as
gcd(windows, ``pipeline_microbatches``) microbatches.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
import math
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from cp360_tpu_torch.config import Config
from cp360_tpu_torch.models.cam import Backbone
from cp360_tpu_torch.models.clstm import ConvLSTM
from cp360_tpu_torch.pipelines.extract import (
    _model_device, _resize_frame, _to_device, host_faces_for_upload, stage1_batch_faces,
    stage1_batch_faces_yuv)
from cp360_tpu_torch.parallel.pipeline import make_pipe_devices
from cp360_tpu_torch.pipelines.temporal import (
    window_infer_from_frames, window_infer_from_frames_pipelined)

REMAP_WORKERS = 4  # host threads cube-sampling decoded frames (cv2 drops the GIL)


def stream_video_saliency(model: Backbone, cell: ConvLSTM, vid_path: str, cfg: Config,
                          stage1_batch: int = 8, max_frames: Optional[int] = None,
                          start_output: int = 0) -> Iterator[Tuple[int, np.ndarray]]:
    """Stream temporal saliency maps for a video, on the device of ``model``
    (any backbone family) and ``cell`` (``compat/jax_params.py`` builds
    them from the JAX package's param trees, ``backbone_from_params`` for
    the backbone).

    Equivalent to extract_features (with ``host_cube_remap``, f16 feats) ->
    test_temporal on the same video, with the CAM cubes never leaving the
    device.  ``start_output`` resumes mid-video: maps with id <
    start_output are not produced, and every frame the remaining windows do
    not read skips the remap and the device (decode skips with
    ``cap.grab``).  Windows are independent (per-window normalization and
    state seeding, test_temporal.py:66-79), so the resumed suffix equals
    the same ids of a run from the start.

    The video is opened here, so a missing file raises at the call, not at
    the first ``next``.
    """
    import cv2

    pipe_devices = None
    if cfg.pipeline_stages > 1:
        if cfg.seq_len % cfg.pipeline_stages:
            raise ValueError(f"pipeline_stages={cfg.pipeline_stages} must divide "
                             f"seq_len={cfg.seq_len} (each stage runs seq_len/stages steps)")
        pipe_devices = make_pipe_devices(cfg.pipeline_stages, _model_device(model))
    if cfg.upload_format not in ("rgb8", "yuv420"):
        raise ValueError(f"upload_format={cfg.upload_format!r} is not one of 'rgb8', 'yuv420'")
    cap = cv2.VideoCapture(vid_path)
    if not cap.isOpened():
        raise FileNotFoundError(
            f"cannot open video {vid_path!r} (missing file or unsupported codec)")
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if max_frames is not None:
        total = min(total, max_frames)
    return _stream_frames(model, cell, cfg, stage1_batch, cap, total, start_output,
                          pipe_devices)


def _stream_frames(model: Backbone, cell: ConvLSTM, cfg: Config, stage1_batch: int, cap,
                   total: int, start_output: int, pipe_devices=None):
    seq_len = cfg.seq_len
    keep = seq_len - 1
    yuv = cfg.upload_format == "yuv420"
    device = _model_device(model)
    pin = device.type == "cuda"
    carry = None  # device [<= seq_len-1, 6, h, w, C] f16: the trailing real CAM frames
    carry_cnts: list = []
    staged = None  # the last batch's host staging, alive until its copy has run

    def process(batch):
        """[(cnt, faces future)] -> [(id, saliency)] of the batch's real
        windows; the carry moves on."""
        nonlocal carry, carry_cnts, staged
        items = [f.result() for _, f in batch]
        # the tail batch is padded to stage1_batch with its last frame, so
        # every stage-1 batch has one shape; pad frames reach no returned window
        pad = stage1_batch - len(items)
        items += [items[-1]] * pad
        parts = list(zip(*items)) if yuv else [items]  # yuv: (Y, UV) per frame
        xs, hosts = zip(*(_to_device(part, device, pin) for part in parts))
        step = stage1_batch_faces_yuv if yuv else stage1_batch_faces
        with torch.no_grad():
            scores, _ = step(model, *xs, out_dtype=torch.float16)  # [B, 6, h, w, C]
            cnts = [c for c, _ in batch] + [batch[-1][0]] * pad
            frames = scores if carry is None else torch.cat([carry, scores])
            all_cnts = cnts if carry is None else carry_cnts + cnts
            n_real = frames.shape[0] - pad
            real_windows = n_real - seq_len + 1
            out = []
            if real_windows > 0:
                # every position, pad windows included: one window-batch
                # shape after the first batch
                positions = torch.arange(frames.shape[0] - seq_len + 1, device=device)
                if pipe_devices is not None:
                    n_micro = max(1, math.gcd(len(positions), cfg.pipeline_microbatches))
                    preds = window_infer_from_frames_pipelined(
                        cell, frames, positions, pipe_devices, n_micro, seq_len)
                else:
                    preds = window_infer_from_frames(cell, frames, positions, seq_len)
                preds = preds.cpu().numpy()
                # the offline numbering ({position + seq_len - 1:05},
                # test_temporal.py:86-88): artifact counters start at 2
                out = [(all_cnts[k + seq_len - 1] - 2, preds[k]) for k in range(real_windows)]
        staged = hosts  # a batch without windows has not waited for its copy
        carry = frames[:n_real][-keep:]  # trailing REAL frames only
        carry_cnts = all_cnts[:n_real][-keep:]
        return out

    # resume: map m comes from the window whose last frame counter is m + 2,
    # so its first counter is m + 3 - seq_len and every earlier frame feeds
    # written windows only.  prev must hold the frame processed at that
    # counter (video index cnt - 2, the 2-frame lag), so grab through
    # index skip_to - 1.
    skip_to = max(0, start_output + 3 - seq_len - 2)
    remap_pool = ThreadPoolExecutor(max_workers=REMAP_WORKERS)
    try:
        prev = None
        fbatch = []
        for i in range(total):
            if i < skip_to:
                if not cap.grab():  # decode-skip: no retrieve, no remap
                    break
                continue
            ok, frame = cap.read()
            if not ok:
                break
            if i == skip_to:
                prev = frame
                continue
            cnt = i + 1  # reference numbering
            fbatch.append((cnt, remap_pool.submit(host_faces_for_upload,
                                                  _resize_frame(prev, cfg), cfg.cube_dim, yuv)))
            prev = frame
            if len(fbatch) == stage1_batch:
                yield from process(fbatch)
                fbatch = []
        if fbatch:
            yield from process(fbatch)
    finally:
        # an abandoned generator or an exception must not leak the capture
        cap.release()
        remap_pool.shutdown(wait=True, cancel_futures=True)
