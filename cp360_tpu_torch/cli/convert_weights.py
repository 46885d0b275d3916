"""Checkpoint conversion CLI: torch ``.pth`` <-> the JAX package's ``.npz``.

    python -m cp360_tpu_torch.cli.convert_weights [--kind KIND] [--arch ARCH] IN OUT

The port of ``cp360_tpu/cli/convert_weights.py``.  The direction follows the
extensions: a ``.pth`` input (a state dict or a whole module) is imported
into an ``.npz`` param tree, an ``.npz`` input is exported to a
reference-compatible ``.pth``:

    convert_weights --kind resnet --arch resnet50 zoo_resnet50.pth resnet50.npz
    convert_weights --kind clstm released_clstm.pth clstm.npz
    convert_weights trained_clstm.npz clstm_for_reference.pth

``--kind auto`` (the default) sniffs the family from the key names:
resnet (``--arch`` picks the depth), clstm, vgg16 (torchvision ``vgg16_bn``
features; the CAM head comes from the seeded init) or mobilenet_v2.  Only
resnet and clstm export: the reference has no consumer for the others.
Exit code 2, with a message, for two ``.npz`` files, a ``.pth`` input with
an output that is not ``.npz``, a missing file, a file that is not of the
kind, and an export of vgg16 or mobilenet_v2.  The conversion is numpy on
the host; it never touches the card.
"""

from __future__ import annotations

import argparse
import sys


def _err(msg: str) -> int:
    print(f"convert_weights: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    from cp360_tpu_torch.compat import torch_weights as tw

    p = argparse.ArgumentParser(
        prog="convert_weights",
        description="Convert checkpoints between torch .pth and the .npz param trees "
                    "(the direction follows the file extensions)")
    p.add_argument("input", help="source: .pth (torch state dict or module) or .npz")
    p.add_argument("output", help="destination: .npz (import) or .pth (export)")
    p.add_argument("--kind", choices=["auto", *tw.KINDS], default="auto",
                   help="checkpoint family (default: sniff from key names)")
    p.add_argument("--arch", default="resnet50",
                   help="resnet depth for --kind resnet (resnet18/34/50/101/152)")
    args = p.parse_args(argv)

    exporting = args.input.endswith(".npz")
    if exporting and args.output.endswith(".npz"):
        return _err("both files are .npz — nothing to convert")
    if not exporting and not args.output.endswith(".npz"):
        # a .pth input means an import, and np.savez would append .npz to
        # any other name: refuse rather than write a file the user did not name
        return _err(f"input {args.input} is a torch checkpoint, so the output is an .npz "
                    f"param tree — name it *.npz (got {args.output})")
    try:
        convert = tw.export_pth if exporting else tw.convert_pth
        kind, count = convert(args.input, args.output, args.kind, args.arch)
    except FileNotFoundError:
        return _err(f"no such file: {args.input}")
    except ValueError as e:
        return _err(str(e))
    if args.kind == "auto":
        print(f"convert_weights: sniffed kind={kind}", file=sys.stderr)
    if exporting:
        print(f"convert_weights: exported {count} tensors -> {args.output} "
              f"(reference-compatible {kind} state dict)", file=sys.stderr)
    else:
        print(f"convert_weights: wrote {count} arrays -> {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
