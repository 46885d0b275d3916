"""Stage-2 CLI: weakly-supervised ConvLSTM training over stage-1 artifacts.

    python -m cp360_tpu_torch.cli.train_temporal --input output/static_resnet50 \
        [--motion PATH] [--resume] [--metrics-jsonl FILE] [--profile-dir DIR] \
        [--supervise [STALL_S]] [--data-parallel N] [--device cuda|cpu] \
        [--config config.yaml] [--sml W] [--tmpl W] [--mml W] [--lr LR] \
        [--set FIELD=VALUE ...]

The port of ``cp360_tpu/cli/train_temporal.py`` (reference script
temporal_model/train_temporal.py).  Windows come from the train_60 split
under ``--input`` (``<vid>/cube_feat/NNNNNN.npy`` [6, C, 7, 7] and
``<vid>/motion/NNNNNN.npy`` [H, W, 2]); checkpoints go to
``checkpoint_path/CLSTM_s_..._t_..._m_.../``.  ``segment_windows: G``
reads G consecutive windows as one frame run (``batch_size`` must divide
by G), ``transfer_codec: int8`` ships the CAM windows int8, ``processes``
sets the reader threads, ``eval_every_epochs`` with ``eval_dir`` and
``label_path`` validates during training (``best.npz``, ``eval_patience``).
``--profile-dir`` writes a ``torch.profiler`` trace of the epochs;
``--supervise`` runs the job as a child that is restarted (with
``--resume``) when it stalls or crashes (not one worker of a multi-process
job: supervise the whole launch).  Training runs on the card; without one
it exits unless ``--device cpu`` is given.

``pipeline_stages: P`` pipelines the rollout over P devices in this
process.  ``mesh_data`` x ``mesh_model`` > 1 (``--data-parallel N`` sets
``mesh_data``) trains on that many ranks, one per card, started by the
launcher:

    python -m cp360_tpu_torch.cli.launch --nprocs 2 -- \
        python -m cp360_tpu_torch.cli.train_temporal --input ARTS --data-parallel 2

Each rank then reads only its rows of every batch from disk ("per-host
feeding").
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from cp360_tpu_torch.compat.jax_params import init_clstm_params, load_npz
    from cp360_tpu_torch.config import add_config_overrides, config_from_args
    from cp360_tpu_torch.data.dataset import (
        PrefetchLoader, SegmentWindowDataset, WindowDataset, builtin_split)
    from cp360_tpu_torch.parallel import mesh as pmesh
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
                        help="train data-parallel over N ranks (sets mesh_data)")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace of the epochs here")
    parser.add_argument("--supervise", nargs="?", type=float, const=420.0, default=None,
                        metavar="STALL_S",
                        help="run under a restart-on-stall supervisor (utils/supervise.py); "
                             "restarts resume the full train state (--resume is implied)")
    add_config_overrides(parser)
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        print(f"WARNING: ignoring unrecognized arguments: {' '.join(unknown)} "
              "(config fields go through --set FIELD=VALUE)")
    cfg = config_from_args(args)
    if args.data_parallel:
        cfg = cfg.replace(mesh_data=args.data_parallel)
    if args.profile_dir:
        cfg = cfg.replace(profile_dir=args.profile_dir)
    check_config(cfg)
    if args.supervise is not None:
        from cp360_tpu_torch.utils.supervise import run_supervised

        watch = [checkpoint_dir(cfg)] + ([args.metrics_jsonl] if args.metrics_jsonl else [])
        # SIGTERM makes the child save its full train state: give a slow
        # full-width step and checkpoint time before the SIGKILL
        raise SystemExit(run_supervised("cp360_tpu_torch.cli.train_temporal", argv, watch,
                                        args.supervise, resume=True, grace_s=60.0))
    device = resolve_device(args.device)  # before reading data: fail fast
    pmesh.maybe_init_distributed(device)
    device = pmesh.rank_device(device)
    grid = pmesh.grid_from_config(cfg)  # one process with a mesh: raises, naming the launcher

    ds = WindowDataset(args.input, args.motion, builtin_split("train_60"), cfg.seq_len)
    if len(ds) == 0:
        raise SystemExit(f"no training windows found under {args.input}")
    print(f"{len(ds)} training windows")
    batch_size = cfg.batch_size
    if cfg.segment_windows > 1:
        # each batch element is a run of segment_windows stride-1 windows,
        # read as one frame run and re-windowed on the device
        if cfg.batch_size % cfg.segment_windows:
            raise SystemExit(f"batch_size ({cfg.batch_size}) must be divisible by "
                             f"segment_windows ({cfg.segment_windows})")
        ds = SegmentWindowDataset(ds, cfg.segment_windows)
        batch_size = cfg.batch_size // cfg.segment_windows
        print(f"{len(ds)} segments of {cfg.segment_windows} windows "
              f"({ds.n_windows} windows reachable)")
    loader = PrefetchLoader(ds, batch_size=batch_size, shuffle=True,
                            num_threads=cfg.processes, transfer_codec=cfg.transfer_codec)
    per_host = grid is not None and pmesh.process_count() > 1
    if per_host:  # each rank reads only its own span of every global batch
        loader.rows = pmesh.local_rows_slice(grid, batch_size)
        print(f"per-host feeding: process {pmesh.process_index()} loads batch rows "
              f"[{loader.rows.start}:{loader.rows.stop}) of {batch_size}")

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
                 metrics_jsonl=args.metrics_jsonl, resume_state=resume_state,
                 grid=grid, per_host_batches=per_host)


if __name__ == "__main__":
    main()
