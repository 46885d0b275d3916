"""In-training validation: stage-2 inference + saliency metrics.

The port of ``cp360_tpu/train/validate.py``.  The reference never
evaluates during training (quality is measured by a separate test_temporal
run), so this is off by default (``eval_every_epochs: 0``).  When enabled
it composes the offline pieces: ``infer_video`` over the artifacts under
``eval_dir`` and ``evaluate_video``/``aggregate`` against the GT under
``label_path``, the protocol of the temporal test CLI, on the current
weights.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def validation_videos(cfg) -> List[str]:
    """Video ids under ``cfg.eval_dir`` that have stage-1 artifacts, in
    sorted order, optionally restricted to a builtin split and capped."""
    root = cfg.eval_dir
    if not root or not os.path.isdir(root):
        return []
    vids = sorted(v for v in os.listdir(root) if os.path.isdir(os.path.join(root, v, "cube_feat")))
    if cfg.eval_split:
        from cp360_tpu_torch.data.dataset import builtin_split

        keep = set(builtin_split(cfg.eval_split))
        vids = [v for v in vids if v in keep]
    if cfg.eval_max_videos > 0:
        vids = vids[:cfg.eval_max_videos]
    return vids


def run_validation(params: dict, cfg, device="cuda", log_fn=print,
                   rng_seed: Optional[int] = 0) -> Optional[Dict[str, float]]:
    """Score ConvLSTM params (a host param tree) on the validation artifacts.

    A serving cell is built from ``params`` on ``device`` in
    ``cfg.compute_dtype`` and freed afterwards; a trainable model elsewhere
    is not read.  The metrics draw from one ``RandomState(rng_seed)`` for
    the whole pass, Judd then Borji per frame, videos in sorted order.

    Returns the frame-count-weighted aggregate {AUC, AUCB, CC, SIM, videos,
    windows, seconds} (the published protocol's weighting,
    test_temporal.py:180-187), or None when no video under ``eval_dir``
    has both artifacts and GT.
    """
    from cp360_tpu_torch.compat.jax_params import clstm_from_params
    from cp360_tpu_torch.pipelines.temporal import (
        aggregate, evaluate_video, infer_video, video_windows)

    vids = validation_videos(cfg)
    if not vids:
        log_fn(f"validation: no videos with artifacts under eval_dir={cfg.eval_dir!r}; skipping")
        return None

    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    cell = clstm_from_params(params, dtype, cfg.cube_pad, cfg.clstm_conv_impl, device)
    rng = np.random.RandomState(rng_seed) if rng_seed is not None else None
    per_video, frame_counts = {}, {}
    t0 = time.time()
    n_windows = 0
    try:
        for vid in vids:
            feat_dir = os.path.join(cfg.eval_dir, vid, "cube_feat")
            gt_dir = os.path.join(cfg.label_path, vid + ".mp4")
            if not os.path.isdir(gt_dir):
                continue
            preds = infer_video(cell, feat_dir, cfg.seq_len, batch_windows=cfg.eval_batch_windows,
                                transfer_codec=cfg.transfer_codec)
            res = evaluate_video(preds, gt_dir, cfg.seq_len, rng=rng)
            if not len(res["AUC"]):
                continue
            per_video[vid] = res
            frame_counts[vid] = len(video_windows(feat_dir))
            n_windows += len(preds)
    finally:
        del cell
    if not per_video:
        log_fn("validation: no video had matching GT frames; skipping")
        return None
    agg = aggregate(per_video, frame_counts)
    return {**{k: float(v) for k, v in agg.items()}, "videos": len(per_video),
            "windows": n_windows, "seconds": round(time.time() - t0, 1)}
