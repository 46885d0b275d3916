"""One traced run of a cell, split by the program's spans.

    python3 benchmark/split.py --workload <cell> --seed <n> --seconds <s>

Runs ``benchmark/run.py --trace 1`` in this process, prints its result
line, then one JSON line more: ``lib/spans.py::split`` of the traced window
(idle time inside each of the program's spans and outside them all, and
each recorded span's count, busy share, lengths and gaps), the program's
counters and the spans its store dropped.  A reading for ``PERF.md``'s
tables, not a metric of the benchmark; a program without the recorder
prints no split and exits 1."""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness, run  # noqa: E402  (run.py sets the run's start clock)
from benchmark.lib import spans  # noqa: E402


def main(argv=None) -> int:
    args = run.parse(argv)
    seen = {}
    execute, read_trace = harness.execute, harness.read_trace

    def keep_run(r, t_start):
        seen["run"] = r
        return execute(r, t_start)

    def keep_trace(prof, tmp):
        seen["trace"] = read_trace(prof, tmp)
        return seen["trace"]

    harness.execute, harness.read_trace = keep_run, keep_trace
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    rec = spans.recorder()
    if rc != 0 or seen.get("trace") is None or rec is None:
        return rc or 1
    out = spans.split(seen["trace"], rec.spans(), seen["run"].tracer.t0)
    out.update(cell=args.workload, seed=args.seed, counters=rec.counters(),
               dropped=rec.STORE.dropped)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
