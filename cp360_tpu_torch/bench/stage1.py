"""Stage-1 frames/s on one card: the port of ``bench.py``'s measurement.

    python -m cp360_tpu_torch.bench.stage1 [--device cuda] [--out FILE]

Measures the extraction's stage-1 step end to end per frame, with
``pipelines/extract.py::extract_frames``'s steps for the host remap
(``host_cube_remap: true``) but a loop of its own: u8 960x1920 frames are
cube-sampled to 224 faces on 4 host threads (``host_faces_for_upload``),
packed as 4:2:0 planes (``BENCH_UPLOAD=yuv420``, default) or sent as u8
faces (``rgb8``), stacked into host staging memory and copied to the card
as the extraction copies them (``extract.stage_batch``: pinned on a card,
``non_blocking``), up to ``BENCH_DEPTH`` (4) batches ahead of the step, on
the calling thread (the extraction packs on a thread of its own); the step
is ``extract.stage1_uploaded`` (``stage1_batch_faces[_yuv]``: resnet50
with seeded weights, bf16, cube padding, f16 CAMs) with the int8 transfer
codec (``BENCH_CODEC=int8``, default, or ``none``); outputs stay on the
card ``BENCH_FETCH_DEPTH`` (1) batches before they are copied back and,
with int8, dequantized on the host to the f16 artifact, inside the timing.
It leaves out the video decode, the flow and the writes, and every batch
is whole (no tail pad).  Each iteration has a distinct batch of
``BENCH_BATCH`` (16) seeded frames; ``BENCH_WARMUP`` (2) batches warm up
(the kernels' build, cuDNN's search), ``BENCH_BATCHES`` (8) are measured.

The final line is ``bench.py``'s: ``value`` the median frames/s (host
clock), ``spread`` and ``spread_iqr`` over the fetch-gated iterations,
``vs_baseline`` against the torch-CPU reference rate of
``BENCH_BASELINE.json`` (read only), and ``device_fps``: the step alone on
``BENCH_DEVICE_ITERS`` (10) device-resident yuv420 batches run back to back,
timed by CUDA events (``BENCH_DEVICE=0`` skips it; rgb8 has none, as in
``bench.py``).  ``bench.py``'s worker subprocesses and retry ladder, link
probe, compile-cache guard and scanned-versus-dispatched device modes serve
the TPU host and have no counterpart here.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch

from cp360_tpu_torch.bench import common
from cp360_tpu_torch.ops.quantize import dequantize_cam_np
from cp360_tpu_torch.pipelines import extract

METRIC = "stage1_frames_per_sec"
UNIT = "frames/s (equi 960x1920 -> CAM cube + saliency, 1 card)"
CUBE_DIM = 224
GATE_S = 0.010  # a copy back that took less than this had already landed


def measure(model, frames: Sequence[np.ndarray], *, device: torch.device, n_warm: int,
            yuv: bool = True, codec: str = "int8", depth: int = 4, fetch_depth: int = 1,
            device_iters: int = 10, cube_dim: int = CUBE_DIM):
    """The pipelined stage 1 over ``frames`` (one [B, H, 2H, 3] u8 batch per
    iteration; the first ``n_warm`` warm up).  Returns (the result line,
    the host outputs of the last batch: (CAMs [B, 6, h, w, K] f16, saliency
    [B, 2h, 4w] f32))."""
    pin = device.type == "cuda"
    batch = frames[0].shape[0]
    pool = ThreadPoolExecutor(max_workers=4)

    def remap(i):
        return [pool.submit(extract.host_faces_for_upload, f, cube_dim, yuv) for f in frames[i]]

    def upload(futs):
        hosts = extract.stage_batch([f.result() for f in futs], batch, pin)
        return hosts, [h.to(device, non_blocking=True) for h in hosts]

    def run(staged):
        with torch.no_grad():
            return extract.stage1_uploaded(model, *staged[1], out_dtype=torch.float16,
                                           codec=codec)

    def fetch(out):
        host = [t.cpu().numpy() for t in out]
        if codec == "int8":
            return dequantize_cam_np(host[0], host[1], np.float16), host[2]
        return host[0], host[1]

    n_total = len(frames)
    try:
        out = None
        for i in range(n_warm):
            out = run(upload(remap(i)))
        if out is not None:
            fetch(out)
        uploads: deque = deque()
        next_i = n_warm
        while next_i < n_total and len(uploads) <= depth:
            uploads.append(upload(remap(next_i)))
            next_i += 1
        times: List[float] = []
        gated: List[bool] = []
        pendings: deque = deque()
        last = None
        t_prev = time.perf_counter()
        for i in range(n_warm, n_total):
            staged = uploads.popleft()
            if next_i < n_total:
                uploads.append(upload(remap(next_i)))
                next_i += 1
            pendings.append(run(staged))
            t_fetch = time.perf_counter()
            if len(pendings) > fetch_depth:
                last = fetch(pendings.popleft())
            now = time.perf_counter()
            if i >= n_warm + fetch_depth:  # the first fetch_depth have no fetch gate
                times.append(now - t_prev)
                gated.append(now - t_fetch >= GATE_S)
            t_prev = now
        while pendings:
            last = fetch(pendings.popleft())
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    if not times:
        raise ValueError(f"{n_total} batches leave no measured iteration after {n_warm} "
                         f"warm-ups and a fetch depth of {fetch_depth}")
    result = {"metric": METRIC, **common.rate_summary(batch, times, gated), "unit": UNIT}
    base = common.baseline("BENCH_BASELINE.json", "torch_cpu_fps")
    result["vs_baseline"] = round(result["value"] / base, 2) if base else None
    if yuv and device_iters > 0:
        device_fps = measure_device(model, batch, device, device_iters, codec, cube_dim)
        result["device_fps"] = round(device_fps, 1)
        if base:
            result["device_vs_baseline"] = round(device_fps / base, 1)
    return result, last


def measure_device(model, batch: int, device: torch.device, n_iters: int, codec: str,
                   cube_dim: int = CUBE_DIM) -> float:
    """frames/s of the yuv420 step alone: ``n_iters`` distinct u8 planes
    made on the device, the calls back to back (CUDA events)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(42)

    def plane(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=device,
                             dtype=torch.int32).to(torch.uint8)

    planes = [(plane(batch, 6, cube_dim, cube_dim),
               plane(batch, 6, cube_dim // 2, cube_dim // 2, 2)) for _ in range(n_iters)]

    def call(i):
        with torch.no_grad():
            extract.stage1_uploaded(model, *planes[i % n_iters], out_dtype=torch.float16,
                                    codec=codec)

    ms = common.timed_ms(call, device, n_iters, warmup=1)
    return batch * n_iters / (sum(ms) * 1e-3)


def seeded_frames(n_batches: int, batch: int, h: int = 960, seed: int = 0) -> List[np.ndarray]:
    """Distinct u8 frame batches, as ``bench.py`` makes them."""
    rng = np.random.RandomState(seed)
    return [(rng.rand(batch, h, 2 * h, 3) * 255).astype(np.uint8) for _ in range(n_batches)]


def resnet50(device: torch.device, form=None):
    """resnet50 from the seeded numpy init, bf16, cube padding."""
    from cp360_tpu_torch.compat import jax_params

    return jax_params.backbone_from_params(jax_params.init_resnet_params(0, "resnet50"),
                                           "resnet50", True, torch.bfloat16, device,
                                           cube_conv_form=form)


def main(argv=None) -> int:
    args = common.parse_args(__doc__, argv)
    env = os.environ

    def run(device):
        batch = int(env.get("BENCH_BATCH", "16"))
        n_warm = int(env.get("BENCH_WARMUP", "2"))
        n_meas = int(env.get("BENCH_BATCHES", "8"))
        yuv = env.get("BENCH_UPLOAD", "yuv420") == "yuv420"
        device_iters = (int(env.get("BENCH_DEVICE_ITERS", "10"))
                        if env.get("BENCH_DEVICE", "1") != "0" else 0)
        line, _ = measure(resnet50(device), seeded_frames(n_warm + n_meas, batch),
                          device=device, n_warm=n_warm, yuv=yuv,
                          codec=env.get("BENCH_CODEC", "int8"),
                          depth=int(env.get("BENCH_DEPTH", "4")),
                          fetch_depth=max(1, int(env.get("BENCH_FETCH_DEPTH", "1"))),
                          device_iters=device_iters)
        return [line]

    return common.run(METRIC, args, run)


if __name__ == "__main__":
    raise SystemExit(main())
