"""Stage-2 CLI: temporal inference + evaluation against Wild-360 GT, on one
GPU.

    python -m cp360_tpu_torch.cli.test_temporal --model CLSTM.npz \
        --dir output/static_resnet50 [--overlay] [--batch-windows 64] [--resume] \
        [--device cuda|cpu] [--config config.yaml] [--set FIELD=VALUE ...]

The port of ``cp360_tpu/cli/test_temporal.py`` (reference driver
temporal_model/test_temporal.py: --model, --dir, --overlay).  For each
test_25 video under ``--dir`` (``<vid>/cube_feat/NNNNNN.npy``) it writes
the window predictions to ``<output_path>/temporal/<vid>/NNNNN.npy``,
scores them against ``<label_path>/<vid>.mp4/NNNNN.npy`` and writes the
reference-compatible ``<basename of --dir>_result.txt`` (in the working
directory) with the frame-weighted aggregate.  ``--model`` is a ``.npz``
(the JAX package's format; convert the reference's ``.pth`` with the JAX
package's cp360-convert); a bare name is looked up under
``checkpoint_path``.  ``--resume`` skips videos
whose ``_done.npz`` marker says maps, overlays and metrics completed, and
their cached metrics still enter the aggregate.  Inference runs on the
card; without one it exits unless ``--device cpu`` is given.  Not ported,
and refused: ``--data-parallel`` and ``--supervise``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    import torch

    from cp360_tpu_torch.compat.jax_params import clstm_from_params, load_npz
    from cp360_tpu_torch.config import add_config_overrides, config_from_args
    from cp360_tpu_torch.data.dataset import builtin_split
    from cp360_tpu_torch.pipelines.temporal import aggregate
    from cp360_tpu_torch.serving.server import resolve_device

    parser = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    parser.add_argument("--model", type=str, required=True, help="CLSTM .npz")
    parser.add_argument("--dir", type=str, required=True, help="stage-1 artifact root")
    parser.add_argument("--overlay", action="store_true", help="write overlay jpgs")
    parser.add_argument("--batch-windows", type=int, default=64)
    parser.add_argument("--resume", action="store_true",
                        help="skip videos whose maps + metrics were already completed "
                             "(per-video _done.npz markers); their cached metrics still "
                             "enter the aggregate")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--data-parallel", type=int, default=None, help="not ported")
    parser.add_argument("--supervise", nargs="?", type=float, const=420.0, default=None,
                        metavar="STALL_S", help="not ported")
    add_config_overrides(parser)
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        print(f"WARNING: ignoring unrecognized arguments: {' '.join(unknown)} "
              "(config fields go through --set FIELD=VALUE)")
    cfg = config_from_args(args)
    if args.supervise is not None or args.data_parallel:
        raise NotImplementedError(
            "--supervise and --data-parallel are not ported to cp360_tpu_torch yet "
            '(the port infers on one card); see ROADMAP.md, "trainer options" and '
            '"parallel"')
    if cfg.transfer_codec not in ("none", "int8"):
        raise ValueError(f"transfer_codec={cfg.transfer_codec!r} is not one of "
                         "'none', 'int8'")
    if not args.model.endswith(".npz"):
        raise SystemExit(f"{args.model}: the port reads .npz checkpoints only "
                         "(convert .pth with the JAX package's cp360-convert)")
    device = resolve_device(args.device)  # before loading weights: fail fast

    model_path = args.model
    if not os.path.exists(model_path):
        model_path = os.path.join(cfg.checkpoint_path, args.model)
    compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    cell = clstm_from_params(load_npz(model_path), compute_dtype, cfg.cube_pad,
                             cfg.clstm_conv_impl, device)

    vids = [v for v in builtin_split("test_25")
            if os.path.isdir(os.path.join(args.dir, v, "cube_feat"))]
    outdir = os.path.join(cfg.output_path, "temporal")
    os.makedirs(outdir, exist_ok=True)
    per_video, frame_counts = {}, {}
    infer_all(args, cfg, cell, vids, outdir, per_video, frame_counts)
    if per_video:
        agg = aggregate(per_video, frame_counts)
        print("========== AUC: {AUC}\tCC: {CC}\tAUCB: {AUCB}\tSIM: {SIM}".format(**agg))
        # reference-compatible result file (test_temporal.py:186-187)
        with open(f"{args.dir.split('/')[-1]}_result.txt", "w") as f:
            print(f"total result:{agg['CC']}, {agg['AUC']}, {agg['AUCB']}", file=f)
        return agg
    return None


def infer_all(args, cfg, cell, vids, outdir, per_video, frame_counts) -> None:
    """Per-video inference and evaluation; fills the two dicts in place."""
    from cp360_tpu_torch.pipelines.temporal import evaluate_video, infer_video, video_windows
    from cp360_tpu_torch.utils.atomic import atomic_savez

    for i, vid in enumerate(vids):
        marker = os.path.join(outdir, vid, "_done.npz")
        if args.resume and os.path.exists(marker):
            # the marker is written only after maps, overlays and metrics
            # completed, so skipping is exact.  A marker that no longer
            # matches the run (GT appeared after a run without it;
            # --overlay added) or is unreadable falls through to a
            # recompute.
            d = load_marker(marker)
            if d is not None:
                gt_now = os.path.isdir(os.path.join(cfg.label_path, vid + ".mp4"))
                overlay_ok = not args.overlay or d.get("overlay", False)
                if overlay_ok and (d["has_gt"] or not gt_now):
                    if d["has_gt"]:
                        per_video[vid] = {k: d[k] for k in ("AUC", "AUCB", "CC", "SIM")}
                        frame_counts[vid] = int(d["frames"])
                    print(f"resume: {vid} complete — skipping [{i + 1}/{len(vids)}]")
                    continue
                print(f"resume: {vid} marker predates "
                      f"{'GT' if not d['has_gt'] else '--overlay'} — recomputing")
        print(f"Extracting video {vid}[{i + 1}/{len(vids)}]")
        feat_dir = os.path.join(args.dir, vid, "cube_feat")
        preds = infer_video(cell, feat_dir, cfg.seq_len, batch_windows=args.batch_windows,
                            transfer_codec=cfg.transfer_codec)

        vdir = os.path.join(outdir, vid)
        os.makedirs(vdir, exist_ok=True)
        for idx, p in preds.items():
            np.save(os.path.join(vdir, f"{idx + cfg.seq_len - 1:05}.npy"), p)

        if args.overlay:
            from PIL import Image

            from cp360_tpu_torch.imaging.overlay import overlay

            odir = os.path.join(vdir, "overlay")
            os.makedirs(odir, exist_ok=True)
            for idx, p in preds.items():
                img_path = os.path.join(args.dir, vid, "img", f"{idx + cfg.seq_len - 1:06}.jpg")
                if os.path.exists(img_path):
                    with Image.open(img_path) as img:
                        overlay(img, p ** 2).save(
                            os.path.join(odir, f"{idx + cfg.seq_len - 1:06}.jpg"))

        gt_dir = os.path.join(cfg.label_path, vid + ".mp4")
        if os.path.isdir(gt_dir):
            res = evaluate_video(preds, gt_dir, cfg.seq_len)
            per_video[vid] = res
            frame_counts[vid] = len(video_windows(feat_dir))
            for key in ("AUCB", "AUC", "CC"):
                print(f"[{vid}]\t{key}:{np.mean(res[key])}")
            atomic_savez(marker, has_gt=True, overlay=args.overlay, frames=frame_counts[vid],
                         **{k: np.asarray(res[k]) for k in ("AUC", "AUCB", "CC", "SIM")})
        else:
            atomic_savez(marker, has_gt=False, overlay=args.overlay)


def load_marker(marker: str):
    """The marker's contents as a dict, or None if it cannot be read (a
    truncated file must recompute, not crash --resume)."""
    import zipfile

    try:
        with np.load(marker) as d:
            return {k: (bool(d[k]) if k in ("has_gt", "overlay") else d[k]) for k in d.files}
    except (OSError, ValueError, EOFError, KeyError, zipfile.BadZipFile):
        return None


if __name__ == "__main__":
    main()
