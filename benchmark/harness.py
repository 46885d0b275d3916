"""One run of one cell: load its files by name, set up, measure, check.

A run is one process on the card(s) a cell asks for.  It reads
``workloads/<cell>.json`` (its configuration, traffic mix, chips and why),
``configs/<config>.json`` and ``traffic/<mix>.json``, and hands them to
the driver the mix names (``drivers/<driver>.py``): ``setup`` makes the
weights and inputs from the seed and warms up, ``window`` measures for the
given seconds, ``release`` frees the program's state and ``check`` holds
what the window produced against the plain reference (``reference/``).
The cell's metrics are those ``BENCHMARK.json`` lists for it: its
end-to-end metrics with ``--trace 0``, its per-layer metrics, each read by
``metrics/<metric>.py``, with ``--trace 1``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cp360_tpu")  # whole top-level module names
TRACE_SECONDS = 8.0  # a traced run traces this much of its window (or all of it)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
KERNEL = ("kernel",)  # the device is busy while a kernel runs; copies and sets are not counted


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def benchmark_json() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str) -> Dict[str, List[dict]]:
    """The end-to-end and per-layer metrics ``BENCHMARK.json`` gives a cell:
    those that list it under ``workloads``; one without that key is every
    cell's (a per-layer metric: every cell that reports its ``moves``)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m["workloads"] or ("workloads" not in m and m["moves"] in names)
             ] if bench.get("per_layer") else []
    return {"end_to_end": e2e, "per_layer": layer}


def load_metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(ctx)``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark refuses."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unreadable: {type(e).__name__}"


@dataclass
class Check:
    """One number compared with its limit (``value <= limit`` passes)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


class Tracer:
    """``torch.profiler`` over the start of the window: on at ``start``,
    off at the first ``tick`` after ``seconds`` (or at ``stop``)."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.active = False
        self.prof = self.mark = None
        self.t0 = None

    def start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.mark = torch.profiler.record_function("benchmark.traced_window")
        self.mark.__enter__()
        self.active = True
        self.t0 = time.perf_counter()

    def tick(self) -> None:
        if self.active and time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        import torch

        torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.active = False
        self.prof.__exit__(None, None, None)


@dataclass
class Run:
    """What a driver and a metric reader see of a run."""
    cell_name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    control: str  # 'none', or what the check puts in the program's place
    device: Any = None
    tmp: Path = None
    tracer: Optional[Tracer] = None
    spans: Dict[str, List[tuple]] = field(default_factory=dict)
    counters: Dict[str, Any] = field(default_factory=dict)
    window_s: float = 0.0
    t_start: float = field(default_factory=time.perf_counter)
    ticks: List[float] = field(default_factory=list)

    def tick(self) -> None:
        self.ticks.append(time.perf_counter())
        if self.tracer is not None:
            self.tracer.tick()

    @property
    def tracing(self) -> bool:
        return self.tracer is not None and self.tracer.active

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append((t0, time.perf_counter()))

    def note(self, what: str) -> None:
        """Say on standard error how far set-up has come."""
        print(f"[{time.perf_counter() - self.t_start:7.2f} s] {what}", file=sys.stderr,
              flush=True)


def load_run(cell_name: str, seed: int, seconds: float, trace: bool, control: str) -> Run:
    cell = load_json("workloads", cell_name)
    config = load_json("configs", cell["config"])
    traffic = load_json("traffic", cell["traffic"])
    return Run(cell_name, cell, config, traffic, seed, seconds, trace, control)


# ---- the host during the window -------------------------------------------


def host_sample() -> tuple:
    """(wall s, this process's CPU s)."""
    t = os.times()
    return time.perf_counter(), t.user + t.system


def host_report(a: tuple, b: tuple, ticks: List[float], step: float = 5.0) -> str:
    """One line on the window: the cores this process kept busy, and the
    ticks (maps, steps) in each ``step`` seconds, which show a rate that
    drifts inside a run."""
    wall = max(b[0] - a[0], 1e-9)
    counts = [0] * (int(wall // step) + 1)
    for t in ticks:
        if a[0] <= t <= b[0]:
            counts[int((t - a[0]) // step)] += 1
    return f"process {(b[1] - a[1]) / wall:.2f} cores; ticks per {step:g} s {counts}"


# ---- the traced window -----------------------------------------------------


@dataclass
class Trace:
    """The device and host activity of the traced window (microseconds on
    the profiler's clock)."""
    start: float
    end: float
    device: List[tuple]  # (name, ts, dur, category) of kernels, copies and sets
    host: List[tuple]  # (name, ts, dur) of host operations and runtime calls

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def clipped(self, cats=DEVICE_CATS):
        for name, ts, dur, cat in self.device:
            a, b = max(ts, self.start), min(ts + dur, self.end)
            if b > a and cat in cats:
                yield name, a, b

    def busy_s(self, cats=KERNEL) -> float:
        """Seconds in which a device operation of ``cats`` ran (by default a
        kernel): the union of their intervals inside the window."""
        total, cur_a, cur_b = 0.0, None, None
        for _, a, b in sorted(self.clipped(cats), key=lambda e: e[1]):
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    total += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            total += cur_b - cur_a
        return total * 1e-6

    def device_time_s(self, patterns) -> float:
        """Summed seconds of the device operations whose name holds one of
        ``patterns``."""
        return sum(b - a for name, a, b in self.clipped()
                   if any(p in name for p in patterns)) * 1e-6

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, a, b in self.clipped():
            by[name] = by.get(name, 0.0) + (b - a) * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest stretches in which no kernel ran, each named by
        the host operation that overlaps it most."""
        spans = sorted(((a, b) for _, a, b in self.clipped(KERNEL)))
        gaps, edge = [], self.start
        for a, b in spans:
            if a > edge:
                gaps.append((edge, a))
            edge = max(edge, b)
        if self.end > edge:
            gaps.append((edge, self.end))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:k]
        out = []
        for ga, gb in gaps:
            best, best_key = "host: no traced operation", (0.0, 0.0)
            for name, ts, dur in self.host:
                ov = min(ts + dur, gb) - max(ts, ga)
                key = (ov, -dur)
                if ov > 0 and key > best_key:
                    best, best_key = f"host: {name}", key
            out.append([best, (gb - ga) * 1e-6])
        return out


def read_trace(prof, tmp: Path) -> Optional[Trace]:
    """The traced window from the profiler's exported trace."""
    path = tmp / "benchmark_trace.json"
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        path.unlink(missing_ok=True)
    window = [e for e in events if e.get("name") == "benchmark.traced_window"
              and e.get("ph") == "X"]
    if not window:
        return None
    w = min(window, key=lambda e: e["ts"])
    start, end = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        item = (e.get("name", "?"), float(e["ts"]), float(e["dur"]))
        if cat in DEVICE_CATS:
            device.append(item + (cat,))
        elif cat in ("cpu_op", "cuda_runtime", "user_annotation") and \
                item[0] != "benchmark.traced_window":
            host.append(item)
    return Trace(start, end, device, host)


@dataclass
class MetricContext:
    """What a per-layer metric's reader gets: the run (its configuration,
    spans and counters, the whole window's seconds) and the traced window
    (None where nothing was traced)."""
    run: Run
    trace: Optional[Trace]


def _refused(stage: str) -> bool:
    bad = forbidden_modules()
    if bad:
        print(f"no result: modules {bad} were loaded by the {stage}", file=sys.stderr)
    return bool(bad)


def execute(run: Run, t_start: float) -> Optional[dict]:
    """Set up, measure and check ``run`` on ``run.device``; the result
    line, or None (having said why on standard error) when a module of JAX
    or of the JAX package was loaded."""
    import torch

    cuda = run.device.type == "cuda"
    run.t_start = t_start
    driver = importlib.import_module(f"benchmark.drivers.{run.traffic['driver']}")
    run.note("program and driver imported")
    with tempfile.TemporaryDirectory(prefix="benchmark_") as tmp:
        run.tmp = Path(tmp)
        state = driver.setup(run)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        run.note("set up; the window starts")
        try:
            if run.trace:
                run.tracer = Tracer(min(TRACE_SECONDS, run.seconds))
                run.tracer.start()
            before = host_sample()
            result = driver.window(run, state)
            after = host_sample()
            trace = None
            if run.tracer is not None:
                run.tracer.stop()
                trace = read_trace(run.tracer.prof, run.tmp)
            peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
        finally:  # the loader's threads stop whatever happened
            driver.release(run, state)
        if cuda:
            torch.cuda.empty_cache()
        if _refused("window"):
            return None
        run.note("window closed and released; the check starts")
        print("window: " + host_report(before, after, run.ticks), file=sys.stderr,
              flush=True)
        checks = driver.check(run, state)
        run.note("checked")
        if _refused("check"):
            return None

    wanted = cell_metrics(benchmark_json(), run.cell_name)
    metrics = {}
    if not run.trace:
        values = {**result["metrics"], "setup_s": setup_s}
        for m in wanted["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = MetricContext(run, trace)
        for m in wanted["per_layer"]:
            value = load_metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
              "count": int(run.cell.get("chips", 1)), "memory_peak_bytes": int(peak),
              "card": card_line() if cuda else "cpu"}
    line = {"correct": bool(checks) and all(c.ok for c in checks) and result["failed"] == 0,
            "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
        line["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)
    return line
