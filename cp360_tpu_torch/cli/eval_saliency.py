"""Standalone saliency evaluation CLI.

    python -m cp360_tpu_torch.cli.eval_saliency --input output/temporal \
        --gt /path/Wild360_GT [--offset N] [--seed S] [--json PATH|-] \
        [--device cuda|cpu]

The port of ``cp360_tpu/cli/eval_saliency.py`` (reference analogue
utils/eval_saliency.py:214-317, whose main() is broken upstream).  It
scores either stage-2 prediction dirs (``<root>/<vid>/NNNNN.npy``) or
stage-1 CAM cube dirs (``<root>/<vid>/cube_feat/NNNNNN.npy``, projected to
equi on ``--device`` and channel-maxed) against ``<gt>/<vid>.mp4/NNNNN.npy``.

Prediction->GT frame alignment (``--offset`` = pred index - GT index):
stage-2 files are saved as {window_end:05}.npy against the same-numbered
GT (test_temporal.py:86-88,101-102), offset 0; stage-1 artifacts start at
000002 and artifact N holds video frame N-2
(dataset_feat_extractor.py:126-137,187-189), offset 2.
"""

from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np


def default_offset(pred_dir: str) -> int:
    """Pred index minus GT index for a prediction directory (module doc)."""
    return 2 if os.path.basename(pred_dir) == "cube_feat" else 0


def gt_name_for(fname: str, offset: int) -> str:
    """GT file name of prediction file ``fname`` under the given offset."""
    return f"{int(fname.split('.')[0]) - offset:05}.npy"


def load_prediction(path: str, device) -> np.ndarray:
    """A [h, w] saliency map from a stage-2 map or a stage-1 [6, C, h, w]
    CAM cube (cube_to_equi on ``device``, then the channel max)."""
    import torch

    from cp360_tpu_torch.ops.resample import cube_to_equi

    arr = np.load(path)
    if arr.ndim == 2:
        return arr
    if arr.ndim == 4 and arr.shape[0] == 6:
        cube = torch.from_numpy(np.ascontiguousarray(arr.transpose(0, 2, 3, 1)))
        with torch.no_grad():
            equi = cube_to_equi(cube.to(device))
        return equi.amax(-1).cpu().numpy()
    raise ValueError(f"unrecognized prediction shape {arr.shape} in {path}")


def main(argv=None):
    from cp360_tpu_torch.data.dataset import builtin_split
    from cp360_tpu_torch.metrics import saliency as M
    from cp360_tpu_torch.serving.server import resolve_device

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input", type=str, required=True, help="prediction root")
    parser.add_argument("--gt", type=str, required=True, help="GT root (<vid>.mp4/NNNNN.npy)")
    parser.add_argument("--split", type=str, default="test_25")
    parser.add_argument("--seed", type=int, default=None, help="metric RNG seed")
    parser.add_argument("--offset", type=int, default=None,
                        help="pred index - GT index (default: 0 for stage-2 dirs, "
                             "2 for stage-1 cube_feat dirs)")
    parser.add_argument("--json", type=str, default=None, metavar="PATH",
                        help="also write the aggregate + per-video means as one JSON "
                             "file ('-' for stdout)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where stage-1 cubes are projected: cuda (default) or cpu")
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        print(f"WARNING: ignoring unrecognized arguments: {' '.join(unknown)}")
    device = resolve_device(args.device)

    rng = np.random.RandomState(args.seed) if args.seed is not None else None
    totals = {"AUC": [], "AUCB": [], "CC": [], "SIM": []}
    weights = []
    per_video = {}
    for vid in builtin_split(args.split):
        vdir = os.path.join(args.input, vid)
        if not os.path.isdir(vdir):
            continue
        pred_dir = vdir
        if os.path.isdir(os.path.join(vdir, "cube_feat")):
            pred_dir = os.path.join(vdir, "cube_feat")
        gt_dir = os.path.join(args.gt, vid + ".mp4")
        if not os.path.isdir(gt_dir):
            continue
        offset = args.offset if args.offset is not None else default_offset(pred_dir)
        scores = {k: [] for k in totals}
        for fname in sorted(os.listdir(pred_dir)):
            # strict NNNN.npy only: stray files (a crashed writer's .tmp,
            # _done markers) are no prediction frames
            if not re.match(r"\d+\.npy$", fname):
                continue
            gt_path = os.path.join(gt_dir, gt_name_for(fname, offset))
            if not os.path.exists(gt_path):
                continue
            pred = load_prediction(os.path.join(pred_dir, fname), device)
            gt = np.load(gt_path)
            scores["AUC"].append(M.auc_judd(pred, gt, rng=rng))
            scores["AUCB"].append(M.auc_borji(pred, gt, rng=rng))
            scores["CC"].append(M.corr_coeff(pred, gt))
            scores["SIM"].append(M.similarity(pred, gt))
        if not scores["AUC"]:
            continue
        n = len(scores["AUC"])
        print(f"[{vid}] n={n} AUC={np.mean(scores['AUC']):.4f} "
              f"AUCB={np.mean(scores['AUCB']):.4f} CC={np.mean(scores['CC']):.4f} "
              f"SIM={np.mean(scores['SIM']):.4f}")
        for k in totals:
            totals[k].append(np.mean(scores[k]))
        weights.append(n)
        per_video[vid] = {k: float(np.mean(v)) for k, v in scores.items()}
        per_video[vid]["frames"] = n

    agg = None
    if weights:
        w = np.asarray(weights, dtype=np.float64)
        w = w / w.sum()
        agg = {k: float(np.sum(np.asarray(v) * w)) for k, v in totals.items()}
        print("total result: AUC={AUC:.4f} AUCB={AUCB:.4f} CC={CC:.4f} SIM={SIM:.4f}"
              .format(**agg))
    else:
        print("no videos scored")
    if args.json:
        doc = {"aggregate": agg, "per_video": per_video, "videos": len(per_video),
               "split": args.split}
        if args.json == "-":
            print(json.dumps(doc))
        else:
            with open(args.json, "w") as f:
                json.dump(doc, f, indent=1)
    return agg


if __name__ == "__main__":
    main()
