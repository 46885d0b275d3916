"""Run one cell of the benchmark of ``cp360_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the cell's weights and inputs on the card from ``--seed``, warms up
its shapes (counted in ``setup_s``), measures for ``--seconds``, checks
what the window produced against the plain reference, and prints one JSON
line as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end metrics, or with ``--trace 1`` the
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number with its limit (also the last lines of
standard error).  Exits 2 without a result when there is no card, or fewer
than the cell asks for, and 3 when a module of JAX or of the JAX package
was loaded.

``--control fp8`` puts the reference, rounded to float8 wherever the
program holds bf16, in the program's place in the check (the precision
control); ``--control half`` (training) the reference stepped on half of
each batch, its loss scaled to the whole (a fault).  Such a run must read
not correct.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
os.environ.setdefault("USE_FLAX", "0")

from benchmark import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("none", "fp8", "half"), default="none")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    run = harness.load_run(args.workload, args.seed, args.seconds, bool(args.trace),
                           args.control)
    import torch

    chips = int(run.cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run.device = torch.device("cuda", 0)
    torch.cuda.set_device(run.device)
    line = harness.execute(run, T_START)
    if line is None:
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — the run's boundary: report, print no result
        traceback.print_exc()
        sys.exit(1)
