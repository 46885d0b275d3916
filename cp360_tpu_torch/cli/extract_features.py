"""Stage-1 CLI: extract CAM cubes (and overlay images) from Wild-360 videos,
on one GPU.

    python -m cp360_tpu_torch.cli.extract_features --config config.yaml \
        --out static -of [-oi] [-om] [--weights resnet50.npz] [--max-frames N] \
        [--device cuda|cpu] [--set FIELD=VALUE ...]

The port of ``cp360_tpu/cli/extract_features.py`` (reference driver
static_model/dataset_feat_extractor.py: flags -oi/-of/-om, --out, --mode;
videos ``<data_vid_path>/{test,train}/<vid>.mp4`` from the built-in
test_25/train_60 splits, chosen by ``test_mode``/``train_mode``).
Artifacts go to ``<output_path>/<out>_<mode>/<vid>/``; a rerun resumes
where the artifacts stop.  Weights are the JAX package's ``.npz``
(compat/jax_params.py); without ``--weights`` the backbone is randomly
initialized from a seed (demo only).  ``-om`` with ``opt_flow: true``
writes the optical flow (``flow_backend``; the device backends solve on
the extraction's device); ``host_cube_remap: true`` with ``upload_format:
yuv420`` uploads 4:2:0 planes.  Extraction runs on the card; without one it
exits unless ``--device cpu`` is given.  Not ported, and refused:
``--data-parallel``, ``--supervise``, archs other than resnet50.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def main(argv=None):
    import torch

    from cp360_tpu_torch.compat import jax_params
    from cp360_tpu_torch.config import add_config_overrides, config_from_args
    from cp360_tpu_torch.data.dataset import builtin_split
    from cp360_tpu_torch.pipelines.extract import check_extract_config, extract_video
    from cp360_tpu_torch.serving.server import resolve_device

    parser = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    parser.add_argument("--out", type=str, default="static", help="output dir name")
    parser.add_argument("--mode", type=str, default="resnet50", help="backbone arch")
    parser.add_argument("-oi", "--output_img", action="store_true")
    parser.add_argument("-of", "--output_feature", action="store_true")
    parser.add_argument("-om", "--output_motion", action="store_true")
    parser.add_argument("--weights", type=str, default=None, help=".npz backbone weights")
    parser.add_argument("--max-frames", type=int, default=None)
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
            '(the port extracts on one card); see ROADMAP.md, "trainer options" and '
            '"parallel"')
    if args.mode != "resnet50":
        raise NotImplementedError(
            f"--mode {args.mode!r} is not ported yet (ported: resnet50); see "
            'ROADMAP.md, "resnet18/34/101/152" and "vgg16-bn and mobilenet_v2"')
    check_extract_config(cfg, args.output_motion)
    if args.weights and not args.weights.endswith(".npz"):
        raise SystemExit(f"{args.weights}: the port reads .npz checkpoints only "
                         "(convert .pth with the JAX package's cp360-convert)")
    device = resolve_device(args.device)  # before loading weights: fail fast

    for k, v in sorted(dataclasses.asdict(cfg).items()):
        print(f"\t{k} : {v}")
    if args.weights:
        params = jax_params.load_npz(args.weights)
    else:
        print("WARNING: no --weights given; using random init (demo only)")
        params = jax_params.init_resnet_params(0, args.mode)
    compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    model = jax_params.resnet_from_params(params, args.mode, cfg.cube_pad,
                                          compute_dtype, device)
    del params
    out_path = os.path.join(cfg.output_path, f"{args.out}_{args.mode}")
    os.makedirs(out_path, exist_ok=True)

    jobs = []
    if cfg.test_mode:
        jobs += [("test", v) for v in builtin_split("test_25")]
    if cfg.train_mode:
        jobs += [("train", v) for v in builtin_split("train_60")]
    for split, vid in jobs:
        vid_file = os.path.join(cfg.data_vid_path, split, vid + ".mp4")
        if not os.path.exists(vid_file):
            print(f"skip {vid}: {vid_file} not found")
            continue
        print(f"Now process {vid}!")
        extract_video(model, cfg, vid_file, os.path.join(out_path, vid),
                      output_img=args.output_img, output_feature=args.output_feature,
                      output_motion=args.output_motion, max_frames=args.max_frames)


if __name__ == "__main__":
    main()
