"""Streaming CLI: one 360° video -> temporal saliency maps, no artifacts, on
one GPU.

    python -m cp360_tpu_torch.cli.stream_saliency --video v.mp4 \
        --backbone BB.npz|BB.pth --clstm CLSTM.npz|CLSTM.pth --out outdir [--arch ARCH] \
        [--max-frames N] [--stage1-batch 8] [--overlay] [--resume] \
        [--supervise [STALL_S]] [--device cuda|cpu] [--config config.yaml] \
        [--set FIELD=VALUE ...]

The port of ``cp360_tpu/cli/stream_saliency.py``.  It runs the fused
streaming pipeline (pipelines/stream.py: the CAM cubes stay on the device
between the stages) and writes one ``{frame:05}.npy`` map per complete
window, numbered as the offline pipeline numbers its maps, so
``eval_saliency`` scores either.  ``--overlay`` also writes
``<out>/overlay/{frame:05}.jpg``; ``--resume`` continues at the first
missing map; ``--supervise`` runs the job as a child that is restarted
with ``--resume`` when it stalls or crashes.  ``--arch`` picks the
backbone (resnet18/34/50/101/152, vgg16, mobilenet_v2).  Weights are the
JAX package's ``.npz`` or torch ``.pth`` files (compat/torch_weights.py).
The stream runs on the card; without one it exits unless the CPU is asked
for (``--device cpu``, ``CP360_PLATFORM=cpu`` or ``use_gpu: false``;
utils/platform.py).  ``--set pipeline_stages=P`` pipelines each window
batch's recurrence over P devices (it must divide ``seq_len``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    import torch

    from cp360_tpu_torch.compat import jax_params
    from cp360_tpu_torch.compat.torch_weights import load_clstm, load_params
    from cp360_tpu_torch.config import (add_config_overrides, config_from_args,
                                        warn_ignored_args)
    from cp360_tpu_torch.serving.server import resolve_device
    from cp360_tpu_torch.utils.platform import entry_device

    # allow_abbrev=False: an abbreviated --supervise would survive
    # strip_supervise_flag and nest supervisors in the child
    parser = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    parser.add_argument("--video", type=str, required=True)
    parser.add_argument("--backbone", type=str, required=True, help=".npz or .pth backbone weights")
    parser.add_argument("--clstm", type=str, required=True, help=".npz or .pth ConvLSTM weights")
    parser.add_argument("--out", type=str, required=True, help="output dir for saliency .npy")
    parser.add_argument("--arch", type=str, default="resnet50")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--stage1-batch", type=int, default=8)
    parser.add_argument("--overlay", action="store_true",
                        help="also write jet-overlay jpgs under <out>/overlay/ ({frame:05}.jpg, "
                             "the maps' numbering)")
    parser.add_argument("--resume", action="store_true",
                        help="continue at the first missing map: frames that feed only written "
                             "windows skip the remap and the device (windows are independent, "
                             "so the suffix is the same)")
    parser.add_argument("--supervise", nargs="?", type=float, const=420.0, default=None,
                        metavar="STALL_S",
                        help="run under a restart-on-stall supervisor (utils/supervise.py); the "
                             "child is relaunched with --resume")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda or cpu (default: CP360_PLATFORM, then use_gpu, then cuda)")
    add_config_overrides(parser)
    args, unknown = parser.parse_known_args(argv)
    warn_ignored_args(unknown)
    cfg = config_from_args(args)
    if not jax_params.is_backbone(args.arch):
        raise ValueError(f"unknown --arch {args.arch!r} (one of {jax_params.PORT_BACKBONES})")
    if args.supervise is not None:
        from cp360_tpu_torch.utils.supervise import run_supervised

        raise SystemExit(run_supervised("cp360_tpu_torch.cli.stream_saliency", argv,
                                        [args.out], args.supervise, resume=True))
    device = resolve_device(entry_device(args.device, cfg))  # before loading weights: fail fast

    from cp360_tpu_torch.pipelines.stream import stream_video_saliency
    from cp360_tpu_torch.utils.atomic import atomic_save

    os.makedirs(args.out, exist_ok=True)
    start_output = 0
    if args.resume:
        # the first missing map of the contiguous prefix (ids start at
        # seq_len - 1, the offline numbering); maps after it from a cut
        # batch are rewritten with the same content
        start_output = cfg.seq_len - 1
        while os.path.exists(os.path.join(args.out, f"{start_output:05}.npy")):
            start_output += 1
        if start_output > cfg.seq_len - 1:
            print(f"resume: maps before {start_output:05} exist; continuing there")
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    model = jax_params.backbone_from_params(load_params(args.backbone, args.arch), args.arch,
                                            cfg.cube_pad, dtype, device)
    cell = jax_params.clstm_from_params(load_clstm(args.clstm), dtype, cfg.cube_pad,
                                        cfg.clstm_conv_impl, device)
    stream = stream_video_saliency(model, cell, args.video, cfg, stage1_batch=args.stage1_batch,
                                   max_frames=args.max_frames, start_output=start_output)
    ocap = None
    if args.overlay:
        import cv2

        ocap = cv2.VideoCapture(args.video)
        odir = os.path.join(args.out, "overlay")
        os.makedirs(odir, exist_ok=True)
        opos = 0  # video index of the next ocap.read()
    n = 0
    try:
        for frame_id, sal in stream:
            # atomic: --resume takes an existing map as complete
            atomic_save(os.path.join(args.out, f"{frame_id:05}.npy"), sal)
            if ocap is not None:
                # map id P is the saliency of video frame P; ids ascend, so a
                # second sequential reader keeps in step with the stream
                frame_bgr = None
                while opos <= frame_id:
                    ok, frame_bgr = ocap.read()
                    opos += 1
                    if not ok:
                        frame_bgr = None
                        break
                if frame_bgr is not None:
                    write_overlay(frame_bgr, sal, cfg, os.path.join(odir, f"{frame_id:05}.jpg"))
            n += 1
    finally:
        if ocap is not None:
            ocap.release()
    print(f"{args.video}: {n} saliency maps -> {args.out}"
          + (" (+overlays)" if args.overlay else ""))
    return n


def write_overlay(frame_bgr: np.ndarray, sal: np.ndarray, cfg, path: str) -> None:
    """The offline look: the working-size frame (BGR-as-RGB, as the
    reference) under the jet map of saliency squared."""
    from cp360_tpu_torch.imaging.overlay import overlay
    from cp360_tpu_torch.pipelines.extract import _atomic_pil_save, _resize_frame

    _atomic_pil_save(overlay(_resize_frame(frame_bgr, cfg), np.asarray(sal) ** 2), path)


if __name__ == "__main__":
    main()
