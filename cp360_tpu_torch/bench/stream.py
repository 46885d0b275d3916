"""Streaming frames/s on one card: the port of ``tools/bench_stream.py``.

    python -m cp360_tpu_torch.bench.stream [batch=8] [--device cuda] [--out FILE]

Video frame -> temporal saliency on seeded decoded u8 960x1920 frames,
with ``pipelines/stream.py``'s steps but a loop of its own: 4 host threads
cube-sample the frames (``host_faces_for_upload``, 4:2:0 planes with
``STREAM_UPLOAD=yuv420``, default, or u8 faces with ``rgb8``), each batch
is packed and uploaded (``extract.stage_batch``: pinned on a card,
``non_blocking``) and goes through stage 1 (``extract.stage1_uploaded``:
resnet50, bf16, f16 CAMs kept on the card), the last 4 CAM frames carry
over to the next batch, every complete window runs through the ConvLSTM
1000/1000 (bf16) and only the maps are copied back.  Against
``stream_video_saliency`` it leaves out the video decode and its thread
(the frames are made in memory before timing, and every remap is submitted
at once) and the tail pad (only whole batches run).  Both window shapes
are warmed before timing (6 batches are measured).  ``value`` is frames/s
over the measured batches (host clock), ``spread`` over their per-batch
times.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch

from cp360_tpu_torch.bench import common
from cp360_tpu_torch.pipelines import extract
from cp360_tpu_torch.pipelines.temporal import window_infer_from_frames

METRIC = "stream_frames_per_sec"
N_ITERS = 6
SEQ_LEN = 5


def measure(model, cell, frames: Sequence[np.ndarray], batch: int, *, device: torch.device,
            yuv: bool = True, cube_dim: int = 224):
    """``frames``: the decoded u8 frames, ``batch`` a stage-1 batch, the first
    two batches warm up.  Returns the result line."""
    pin = device.type == "cuda"
    pool = ThreadPoolExecutor(max_workers=4)
    futs = [pool.submit(extract.host_faces_for_upload, f, cube_dim, yuv) for f in frames]
    n_batches = len(frames) // batch
    carry, times = None, []
    try:
        t_prev = time.perf_counter()
        for it in range(n_batches):
            items = [f.result() for f in futs[it * batch:(it + 1) * batch]]
            xs = [h.to(device, non_blocking=True) for h in extract.stage_batch(items, batch, pin)]
            with torch.no_grad():
                scores, _ = extract.stage1_uploaded(model, *xs, out_dtype=torch.float16)
                fd = scores if carry is None else torch.cat([carry, scores])
                n_windows = fd.shape[0] - SEQ_LEN + 1
                if n_windows > 0:
                    positions = torch.arange(n_windows, device=device)
                    preds = window_infer_from_frames(cell, fd, positions, SEQ_LEN).cpu().numpy()
                    if not np.isfinite(preds).all():
                        raise FloatingPointError(f"non-finite maps in batch {it}")
            carry = fd[-(SEQ_LEN - 1):]
            now = time.perf_counter()
            if it > 1:  # both window shapes ran in batches 0 and 1
                times.append(now - t_prev)
            t_prev = now
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    if not times:
        raise ValueError(f"{len(frames)} frames make no measured batch of {batch} "
                         "after the two warm-up batches")
    return {"metric": METRIC, "value": round(batch * len(times) / sum(times), 1),
            **common.spread(batch, times),
            "unit": "frames/s (video -> temporal saliency, both stages fused, 1 card)",
            "upload": "yuv420" if yuv else "rgb8"}


def seeded_frames(n: int, h: int = 960, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    return [(rng.rand(h, 2 * h, 3) * 255).astype(np.uint8) for _ in range(n)]


def main(argv=None) -> int:
    from cp360_tpu_torch.bench.stage1 import resnet50
    from cp360_tpu_torch.bench.stage2 import clstm

    args = common.parse_args(__doc__, argv, ("batch",))
    batch = int(args.batch or 8)
    yuv = os.environ.get("STREAM_UPLOAD", "yuv420") == "yuv420"
    return common.run(METRIC, args, lambda device: [measure(
        resnet50(device), clstm(device), seeded_frames(batch * (N_ITERS + 2)), batch,
        device=device, yuv=yuv)])


if __name__ == "__main__":
    raise SystemExit(main())
