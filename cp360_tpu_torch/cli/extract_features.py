"""Stage-1 CLI: extract CAM cubes (and overlay images) from Wild-360 videos.

    python -m cp360_tpu_torch.cli.extract_features --config config.yaml \
        --out static -of [-oi] [-om] [--mode ARCH] [--weights W.npz|W.pth] \
        [--max-frames N] [--data-parallel N] [--device cuda|cpu] \
        [--set FIELD=VALUE ...]

The port of ``cp360_tpu/cli/extract_features.py`` (reference driver
static_model/dataset_feat_extractor.py: flags -oi/-of/-om, --out, --mode;
videos ``<data_vid_path>/{test,train}/<vid>.mp4`` from the built-in
test_25/train_60 splits, chosen by ``test_mode``/``train_mode``).
Artifacts go to ``<output_path>/<out>_<mode>/<vid>/``; a rerun resumes
where the artifacts stop.  ``--mode`` picks the backbone: resnet18, 34,
50, 101 or 152, vgg16 or mobilenet_v2.  Weights are the JAX package's
``.npz`` or a torchvision-layout ``.pth`` (compat/torch_weights.py
``load_params``); without ``--weights`` the backbone is randomly
initialized from a seed (demo only).  ``-om`` with ``opt_flow: true``
writes the optical flow (``flow_backend``; the device backends solve on
the extraction's device); ``host_cube_remap: true`` with ``upload_format:
yuv420`` uploads 4:2:0 planes.  ``--supervise`` runs the extraction as a
child that is restarted when it stalls or crashes (a rerun resumes).
Extraction runs on the card; without one it exits unless the CPU is asked
for (``--device cpu``, ``CP360_PLATFORM=cpu`` or ``use_gpu: false``;
utils/platform.py).  ``--data-parallel N`` (``mesh_data``) splits every
frame batch over N local devices in this process.  Under the launcher
(``cli/launch.py``) the videos are striped over the ranks, each on its own
card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def main(argv=None):
    import torch

    from cp360_tpu_torch.compat import jax_params
    from cp360_tpu_torch.compat.torch_weights import load_params
    from cp360_tpu_torch.config import (add_config_overrides, config_from_args,
                                        warn_ignored_args)
    from cp360_tpu_torch.data.dataset import builtin_split
    from cp360_tpu_torch.parallel import mesh as pmesh
    from cp360_tpu_torch.pipelines.extract import check_extract_config, extract_video
    from cp360_tpu_torch.serving.server import resolve_device
    from cp360_tpu_torch.utils.platform import entry_device

    parser = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    parser.add_argument("--out", type=str, default="static", help="output dir name")
    parser.add_argument("--mode", type=str, default="resnet50", help="backbone arch")
    parser.add_argument("-oi", "--output_img", action="store_true")
    parser.add_argument("-of", "--output_feature", action="store_true")
    parser.add_argument("-om", "--output_motion", action="store_true")
    parser.add_argument("--weights", type=str, default=None, help=".npz or .pth backbone weights")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda or cpu (default: CP360_PLATFORM, then use_gpu, then cuda)")
    parser.add_argument("--data-parallel", type=int, default=None,
                        help="split frame batches over N local devices (sets mesh_data)")
    parser.add_argument("--supervise", nargs="?", type=float, const=420.0, default=None,
                        metavar="STALL_S",
                        help="run under a restart-on-stall supervisor (utils/supervise.py): "
                             "a child with no artifact or output progress for STALL_S seconds "
                             "is killed and relaunched, and resumes")
    add_config_overrides(parser)
    args, unknown = parser.parse_known_args(argv)
    warn_ignored_args(unknown)
    cfg = config_from_args(args)
    if args.data_parallel:
        cfg = cfg.replace(mesh_data=args.data_parallel)
    if not jax_params.is_backbone(args.mode):
        raise ValueError(f"unknown --mode {args.mode!r} (one of {jax_params.PORT_BACKBONES})")
    check_extract_config(cfg, args.output_motion)
    if args.supervise is not None:
        from cp360_tpu_torch.utils.supervise import run_supervised

        out_path = os.path.join(cfg.output_path, f"{args.out}_{args.mode}")
        raise SystemExit(run_supervised("cp360_tpu_torch.cli.extract_features", argv,
                                        [out_path], args.supervise))
    device = resolve_device(entry_device(args.device, cfg))  # before loading weights: fail fast
    pmesh.maybe_init_distributed(device=device)
    device = pmesh.rank_device(device)
    multiproc = pmesh.process_count() > 1
    # each rank computes on its own card: replicas only within one process
    devices = (pmesh.local_devices(device, cfg.mesh_data)
               if cfg.mesh_data > 1 and not multiproc else None)
    if devices is not None:
        pmesh.check_divisible(cfg.extract_batch, len(devices),
                              f"batch_frames={cfg.extract_batch}", "so frames shard evenly")

    for k, v in sorted(dataclasses.asdict(cfg).items()):
        print(f"\t{k} : {v}")
    params = load_params(args.weights, args.mode)
    compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    model = jax_params.backbone_from_params(params, args.mode, cfg.cube_pad,
                                            compute_dtype, device)
    del params
    if devices is not None:
        model = pmesh.LocalReplicas(model, devices)
    out_path = os.path.join(cfg.output_path, f"{args.out}_{args.mode}")
    os.makedirs(out_path, exist_ok=True)

    jobs = []
    if cfg.test_mode:
        jobs += [("test", v) for v in builtin_split("test_25")]
    if cfg.train_mode:
        jobs += [("train", v) for v in builtin_split("train_60")]
    if multiproc:
        # stage 1 is embarrassingly parallel over videos: each rank takes a
        # stripe and computes on its own card
        jobs = pmesh.stripe_jobs(jobs)
        print(f"multi-host extraction: process {pmesh.process_index()}/"
              f"{pmesh.process_count()} takes {len(jobs)} video(s)")
    for split, vid in jobs:
        vid_file = os.path.join(cfg.data_vid_path, split, vid + ".mp4")
        if not os.path.exists(vid_file):
            print(f"skip {vid}: {vid_file} not found")
            continue
        print(f"Now process {vid}!")
        extract_video(model, cfg, vid_file, os.path.join(out_path, vid),
                      output_img=args.output_img, output_feature=args.output_feature,
                      output_motion=args.output_motion, max_frames=args.max_frames,
                      batch_frames=cfg.extract_batch)


if __name__ == "__main__":
    main()
