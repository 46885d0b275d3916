"""Streaming clips to saliency maps through ``pipelines/stream.py::
stream_video_saliency``, the deployers' entry point.

Mix keys: ``clips`` seeded clips of ``frames`` frames at the configuration's
frame size, written in set-up into the run's temporary directory with
``fourcc`` at ``fps``: a seeded natural-spectrum panorama panning
``pan_px`` columns a frame (a camera turning); ``stage1_batch`` frames a
device batch; ``check_maps`` maps drawn from the seed for the check.

The window streams the clips in turn, each from its start, until the time
is up, and counts the maps yielded; the rate is maps over the seconds up to
the last one counted (the maps of one device batch come out together, and
the batch that crosses the end of the window is counted whole).  The check
recomputes the drawn maps with the plain reference from the same clip
files (decoded again, every frame of each map's window) and the same
weights, and compares each map's largest gap, as a share of the
reference map's range.
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np
import torch

from benchmark.harness import Check, Run
from benchmark.lib import k1, port, weights
from benchmark.reference import model as ref

BURST_S = 0.002  # maps yielded closer together than this came from one batch


def panorama(gen: torch.Generator, h: int, w: int, device) -> torch.Tensor:
    """[h, w, 3] u8: noise at four scales, bicubic-upsampled and summed."""
    import torch.nn.functional as F

    img = torch.zeros((1, 3, h, w), device=device)
    for scale in (4, 8, 16, 32):
        small = torch.rand((1, 3, h // scale + 2, w // scale + 2), generator=gen,
                           device=device)
        img += F.interpolate(small, size=(h, w), mode="bicubic", align_corners=False) * scale
    img = (img - img.amin()) / (img.amax() - img.amin()) * 255.0
    return img[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)


def write_clips(run: Run) -> List[str]:
    import cv2

    mix = run.traffic
    rows, cols = run.config["config"]["equi_w"], run.config["config"]["equi_h"]
    gen = torch.Generator(device=run.device)
    gen.manual_seed(run.seed + 7)
    bases = [panorama(gen, rows, cols, run.device).cpu().numpy() for _ in range(mix["clips"])]
    paths = [str(run.tmp / f"clip{i}.avi") for i in range(mix["clips"])]

    def write(i):
        vw = cv2.VideoWriter(paths[i], cv2.VideoWriter_fourcc(*mix["fourcc"]), mix["fps"],
                             (cols, rows))
        if not vw.isOpened():
            raise RuntimeError(f"cv2 cannot write a {mix['fourcc']} clip")
        try:
            for t in range(mix["frames"]):
                vw.write(np.roll(bases[i], mix["pan_px"] * t, axis=1))
        finally:
            vw.release()
        with open(paths[i], "rb") as f:  # on disk before the window: no writeback in it
            os.fsync(f.fileno())

    with ThreadPoolExecutor(max_workers=len(paths)) as pool:
        list(pool.map(write, range(len(paths))))
    return paths


class State:
    pass


def setup(run: Run) -> State:
    from cp360_tpu_torch.pipelines.stream import stream_video_saliency

    st = State()
    st.cfg = port.program_config(run.config)
    w = weights.for_config(run.config, run.seed, run.device)
    st.model = port.resnet(run.config, w["bb"])
    st.cell = port.clstm(run.config, w["cl"])
    del w
    run.note("weights made, modules built")
    st.clips = write_clips(run)
    st.batch = run.traffic["stage1_batch"]
    run.note("clips written")
    # the two window-batch shapes: a clip's first batch, then every later one
    for _ in stream_video_saliency(st.model, st.cell, st.clips[0], st.cfg,
                                   stage1_batch=st.batch, max_frames=2 * st.batch + 1):
        pass
    if run.trace:
        k1.record_calls(run)
    st.maps = []  # (clip, frame id, map)
    return st


def window(run: Run, st: State) -> dict:
    from cp360_tpu_torch.pipelines.stream import stream_video_saliency

    t0 = time.perf_counter()
    end = t0 + run.seconds
    t_last = t0
    k, closing = 0, False
    while not closing:
        ci = k % len(st.clips)
        k += 1
        gen = stream_video_saliency(st.model, st.cell, st.clips[ci], st.cfg,
                                    stage1_batch=st.batch)
        try:
            for fid, sal in gen:
                now = time.perf_counter()
                if closing and now - t_last > BURST_S:
                    break  # the first map of the next batch: not counted
                st.maps.append((ci, fid, sal))
                t_last = now
                run.tick()
                if now >= end:
                    closing = True
        finally:
            gen.close()
    run.window_s = t_last - t0
    n = len(st.maps)
    run.counters["maps"] = n
    bad = sum(1 for _, _, s in st.maps if not np.isfinite(s).all())
    return {"metrics": {"stream_frames_per_s": n / run.window_s}, "attempted": n,
            "failed": bad}


def release(run: Run, st: State) -> None:
    st.model = st.cell = None


def decode_frames(path: str, wanted) -> dict:
    """{video index: decoded frame} for the indices in ``wanted``."""
    import cv2

    cap = cv2.VideoCapture(path)
    out, last = {}, max(wanted)
    try:
        for i in range(last + 1):
            ok, frame = cap.read()
            if not ok:
                raise RuntimeError(f"{path}: frame {i} does not decode")
            if i in wanted:
                out[i] = frame
    finally:
        cap.release()
    return out


def check(run: Run, st: State) -> List[Check]:
    if run.control not in ("none", "fp8"):
        raise ValueError(f"--control {run.control} is not this cell's (none, fp8)")
    ref.exact_f32()
    cfg = run.config["config"]
    seq_len = cfg.get("seq_len", 5)
    rng = np.random.default_rng(run.seed)
    pick = rng.choice(len(st.maps), size=min(run.traffic["check_maps"], len(st.maps)),
                      replace=False)
    sample = [st.maps[i] for i in sorted(pick)]
    need = {}
    for ci, fid, _ in sample:  # map fid ends the window of frames fid-4 .. fid
        need.setdefault(ci, set()).update(range(fid - seq_len + 1, fid + 1))
    w = weights.for_config(run.config, run.seed, run.device)
    fp8 = run.control == "fp8"
    passes = [("want", None)] + ([("got", ref.quantize_fp8)] if fp8 else [])
    gaps = []
    with torch.no_grad():
        scores = {}
        for ci, idx in need.items():
            frames = decode_frames(st.clips[ci], idx)
            keys = sorted(frames)
            x = torch.from_numpy(np.stack([frames[i] for i in keys])).to(run.device)
            for tag, quant in passes:
                s = ref.frames_to_scores(w["bb"], x, cfg["cube_dim"], quant)
                scores.update({(tag, ci, i): s[j] for j, i in enumerate(keys)})
        for ci, fid, sal in sample:
            maps = {}
            for tag, quant in passes:
                win = torch.stack([scores[(tag, ci, i)]
                                   for i in range(fid - seq_len + 1, fid + 1)])
                maps[tag] = ref.window_saliency(w["cl"], win[None], quant)[0]
            want = maps["want"]
            got = maps["got"] if fp8 else torch.from_numpy(sal).to(run.device)
            span = float(want.max() - want.min())
            gaps.append(float((got - want).abs().max()) / max(span, 1e-30))
    print(f"stream check: {len(sample)} maps, gaps median {np.median(gaps):.4g} "
          f"max {max(gaps):.4g}", file=sys.stderr, flush=True)
    return [Check("map_gap", max(gaps), run.cell["limits"]["map_gap"])]
