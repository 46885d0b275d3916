"""Serving CLI: long-lived HTTP saliency inference.

    python -m cp360_tpu_torch.cli.serve --weights W.npz|W.pth [--mode ARCH] \
        [--clstm CLSTM.npz|CLSTM.pth] [--host 0.0.0.0] [--port 8360] \
        [--data-parallel N] [--config config.yaml] [--device cuda|cpu]

``--mode`` picks the backbone (resnet18/34/50/101/152, vgg16,
mobilenet_v2).  Weights are the JAX package's ``.npz`` checkpoints or
torch ``.pth`` files (compat/torch_weights.py); without ``--weights`` the
backbone is randomly initialized from a seed (demo only).  POST an equirectangular JPEG/PNG to /saliency (add ?format=png for a
heatmap image); GET /healthz for liveness.  With --clstm, streaming temporal
sessions are served on /temporal/{session,frame,close} — see
cp360_tpu_torch/serving/server.py.  The server runs on the card; without
one it exits unless the CPU is asked for (``--device cpu``,
``CP360_PLATFORM=cpu`` or ``use_gpu: false``; utils/platform.py).
``--data-parallel N`` (``mesh_data``) serves from replicas on the first N
local cards.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from cp360_tpu_torch.compat import jax_params
    from cp360_tpu_torch.compat.torch_weights import load_clstm, load_params
    from cp360_tpu_torch.config import (add_config_overrides, config_from_args,
                                        warn_ignored_args)
    from cp360_tpu_torch.serving.server import SaliencyModel, resolve_device, serve
    from cp360_tpu_torch.utils.platform import entry_device

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--weights", type=str, default=None, help=".npz or .pth backbone")
    parser.add_argument("--clstm", type=str, default=None,
                        help=".npz or .pth ConvLSTM — enables /temporal streaming")
    parser.add_argument("--mode", type=str, default="resnet50")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8360)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda or cpu (default: CP360_PLATFORM, then use_gpu, then cuda)")
    parser.add_argument("--data-parallel", type=int, default=None,
                        help="serve from replicas on N local devices (sets mesh_data)")
    add_config_overrides(parser)
    args, unknown = parser.parse_known_args(argv)
    warn_ignored_args(unknown)
    cfg = config_from_args(args)
    if args.data_parallel:
        cfg = cfg.replace(mesh_data=args.data_parallel)
    if not jax_params.is_backbone(args.mode):
        raise ValueError(f"unknown --mode {args.mode!r} (one of {jax_params.PORT_BACKBONES})")
    device = resolve_device(entry_device(args.device, cfg))  # before loading weights: fail fast

    params = load_params(args.weights, args.mode)
    clstm_params = load_clstm(args.clstm) if args.clstm else None
    model = SaliencyModel(params, cfg, arch=args.mode, clstm_params=clstm_params,
                          device=device)
    httpd = serve(model, host=args.host, port=args.port)
    print(f"serving saliency on http://{args.host}:{args.port} (arch {args.mode}, "
          f"{model.device} x{model.data_parallel}"
          f"{', temporal' if clstm_params is not None else ''})")

    # SIGTERM drains like Ctrl-C: stop accepting, finish in-flight handlers,
    # fail queued batcher waiters
    import signal
    import threading

    def _term(signum, frame):
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.shutdown()
    finally:
        # join in-flight handler threads before failing the batchers, so a
        # request that already computed is not cut mid-write
        httpd.server_close()
        model.close()
    print("serve: shut down cleanly")


if __name__ == "__main__":
    main()
