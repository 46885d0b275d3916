"""A cell's files at a size a CPU test run can hold: the published depths,
the widths cut (backbone base width 8, 16 classes, a ConvLSTM 16/16, 64
px faces on 128x256 frames, 32x64 flows), a few clips and frames,
and float32 compute, so that the program's reading sits far below the
cell's limits, set for bf16 at the published widths, and a control or a
fault far above them."""

from __future__ import annotations

import torch

from benchmark import harness

TINY_CONFIG = {"equi_h": 256, "equi_w": 128, "cube_dim": 64, "hidden_size": 16,
               "input_size": 16, "flow_h": 32, "compute_dtype": "float32"}
TINY_TRAFFIC = {"stream": {"clips": 2, "frames": 20, "stage1_batch": 4, "check_maps": 6},
                "train": {"videos": 3, "frames": 9, "batch": 4}}


def tiny_run(cell: str, seed: int = 2 ** 31 + 11, seconds: float = 1.5,
             control: str = "none") -> harness.Run:
    run = harness.load_run(cell, seed, seconds, False, control)
    run.config = dict(run.config, base_width=8, num_classes=16)
    run.config["config"] = dict(run.config["config"], **TINY_CONFIG)
    run.traffic.update(TINY_TRAFFIC[run.traffic["driver"]])
    run.device = torch.device("cpu")
    return run
