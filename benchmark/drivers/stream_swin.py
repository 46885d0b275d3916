"""Streaming clips to saliency maps through ``pipelines/stream.py::
stream_video_saliency`` with the cube-padded Swin Transformer backbone
(``models/swin.py::SwinTransformer``).

The mix's keys, the clips, the window and the release are
``drivers/stream.py``'s, imported.  Set-up builds the backbone through the
port's own constructor from ``lib/weights_swin.py``'s tensors; the check
is ``drivers/stream.py``'s, with ``reference/swin.py`` in the reference's
place: the same maps drawn from the seed, each map's largest gap as a
share of the reference map's range, and the same float8 control.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np
import torch

from benchmark.drivers.stream import State, decode_frames, release, window, write_clips
from benchmark.harness import Check, Run
from benchmark.lib import k1, port, weights_swin
from benchmark.lib.weights import DTYPES
from benchmark.reference import model as ref
from benchmark.reference import swin as ref_swin

__all__ = ["setup", "window", "release", "check"]


def setup(run: Run) -> State:
    # first, so that a program without the family fails at once
    from cp360_tpu_torch.models.swin import SwinTransformer
    from cp360_tpu_torch.pipelines.stream import stream_video_saliency

    cfg = run.config["config"]
    st = State()
    st.cfg = port.program_config(run.config)
    w = weights_swin.for_config(run.config, run.seed, run.device)
    st.model = SwinTransformer(w["bb"], cfg.get("cube_pad", True),
                               DTYPES[cfg.get("compute_dtype", "bfloat16")]).eval()
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
    w = weights_swin.for_config(run.config, run.seed, run.device)
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
                s = ref_swin.frames_to_scores(w["bb"], x, cfg["cube_dim"], quant)
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
