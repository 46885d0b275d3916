"""Stage-2 CLI: weakly-supervised ConvLSTM training over stage-1 artifacts,
on one GPU.

    python -m cp360_tpu_torch.cli.train_temporal --input output/static_resnet50 \
        [--motion PATH] [--resume] [--metrics-jsonl FILE] [--device cuda|cpu] \
        [--config config.yaml] [--sml W] [--tmpl W] [--mml W] [--lr LR] \
        [--set FIELD=VALUE ...]

The port of ``cp360_tpu/cli/train_temporal.py`` (reference script
temporal_model/train_temporal.py).  Windows come from the train_60 split
under ``--input`` (``<vid>/cube_feat/NNNNNN.npy`` [6, C, 7, 7] and
``<vid>/motion/NNNNNN.npy`` [H, W, 2]); checkpoints go to
``checkpoint_path/CLSTM_s_..._t_..._m_.../``.  Training runs on the card;
without one it exits unless ``--device cpu`` is given.  Not ported yet,
and refused: ``--data-parallel`` above 1, ``--profile-dir``, ``--supervise``
and the config options listed in ``train/loop.py::check_config``.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from cp360_tpu_torch.compat.jax_params import init_clstm_params, load_npz
    from cp360_tpu_torch.config import add_config_overrides, config_from_args
    from cp360_tpu_torch.data.dataset import PrefetchLoader, WindowDataset, builtin_split
    from cp360_tpu_torch.serving.server import resolve_device
    from cp360_tpu_torch.train.checkpoint import make_checkpointer
    from cp360_tpu_torch.train.loop import (
        check_config, checkpoint_dir, latest_checkpoint, train)

    parser = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    parser.add_argument("--input", type=str, required=True, help="stage-1 artifact root")
    parser.add_argument("--motion", type=str, default=None, help="motion root (default: --input)")
    parser.add_argument("--resume", action="store_true", help="resume from the latest checkpoint")
    parser.add_argument("--metrics-jsonl", type=str, default=None,
                        help="write structured train metrics to this JSONL file")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--data-parallel", type=int, default=None,
                        help="not ported: the port trains on one card")
    parser.add_argument("--profile-dir", type=str, default=None, help="not ported")
    parser.add_argument("--supervise", nargs="?", type=float, const=420.0, default=None,
                        metavar="STALL_S", help="not ported")
    add_config_overrides(parser)
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        print(f"WARNING: ignoring unrecognized arguments: {' '.join(unknown)} "
              "(config fields go through --set FIELD=VALUE)")
    cfg = config_from_args(args)
    if args.supervise is not None:
        raise NotImplementedError("--supervise (restart-on-stall supervision) is not "
                                  'ported to cp360_tpu_torch yet; see ROADMAP.md, '
                                  '"trainer options"')
    if args.data_parallel:
        cfg = cfg.replace(mesh_data=args.data_parallel)
    if args.profile_dir:
        cfg = cfg.replace(profile_dir=args.profile_dir)
    check_config(cfg)
    device = resolve_device(args.device)  # before reading data: fail fast

    ds = WindowDataset(args.input, args.motion, builtin_split("train_60"), cfg.seq_len)
    if len(ds) == 0:
        raise SystemExit(f"no training windows found under {args.input}")
    print(f"{len(ds)} training windows")
    loader = PrefetchLoader(ds, batch_size=cfg.batch_size, shuffle=True,
                            transfer_codec=cfg.transfer_codec)

    params = None
    resume_state = None
    if args.resume:
        if make_checkpointer(cfg.checkpoint_backend, checkpoint_dir(cfg)).has_state():
            resume_state = "latest"  # exact resume: params + optimizer + step
        else:
            ck = latest_checkpoint(checkpoint_dir(cfg))
            if ck:
                print(f"resuming weights from {ck} (no full train state found)")
                params = load_npz(ck)
    if params is None:
        params = init_clstm_params(0, cfg.input_size, cfg.hidden_size)

    return train(cfg, loader, params=params, device=device,
                 metrics_jsonl=args.metrics_jsonl, resume_state=resume_state)


if __name__ == "__main__":
    main()
