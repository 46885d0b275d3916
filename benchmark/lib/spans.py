"""What the readers of the program's spans and counters share.

The program (``cp360_tpu_torch/utils/profiling.py``) records spans and
counters while the profiler runs.  A span on the thread the profiler
records is a ``user_annotation`` event of the traced window, on the
kernels' clock: idle time inside it is read from the trace.  Every span,
on any thread, is also kept in the recorder's store, on the host's
``time.perf_counter_ns``: busy shares are read from there.  Each function
returns None where there is nothing to read: no trace, or a program that
records no such span or counter (a program without the recorder)."""

from __future__ import annotations

from benchmark.harness import KERNEL, Trace


def recorder():
    """The program's recorder module, or None for a program without one."""
    from cp360_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "spans") else None


def union_s(trace: Trace, items) -> float:
    """Seconds of the window covered by ``items`` ((name, ts, dur) on the
    trace's clock, microseconds), overlaps counted once."""
    return Trace(trace.start, trace.end, [i[:3] + ("x",) for i in items], []).busy_s(("x",))


def idle_s_in(trace: Trace, names) -> float:
    """Seconds of the window in which no kernel ran while a span named in
    ``names`` was open: |spans and kernels| - |kernels|."""
    spans = [(n, ts, dur, "span") for n, ts, dur in trace.host if n in names]
    both = Trace(trace.start, trace.end, trace.device + spans, trace.host)
    return both.busy_s(KERNEL + ("span",)) - trace.busy_s()


def idle_share_in(ctx, name: str):
    """% of the traced window in which no kernel ran while the span
    ``name`` was open; None without a trace or without such a span."""
    t = ctx.trace
    if t is None or t.window_s <= 0 or not any(n == name for n, _, _ in t.host):
        return None
    return 100.0 * idle_s_in(t, {name}) / t.window_s


def clipped_s(spans, a: float, b: float) -> float:
    """Summed seconds of the store's ``spans`` inside [a, b] (perf_counter
    seconds), each clipped, overlaps on different threads summed."""
    return sum(max(0.0, min(s[3] * 1e-9, b) - max(s[2] * 1e-9, a)) for s in spans)


def busy_share(ctx, name: str, threads: int = 1):
    """% of the traced window's thread time (window x ``threads``) spent in
    the store's spans ``name``, clipped to the window; None without a
    trace, a recorder or such a span."""
    t, rec = ctx.trace, recorder()
    if t is None or t.window_s <= 0 or rec is None:
        return None
    mine = [s for s in rec.spans() if s[0] == name]
    if not mine:
        return None
    a = ctx.run.tracer.t0
    return 100.0 * clipped_s(mine, a, a + t.window_s) / (t.window_s * threads)


def copy_gbps(ctx, counter: str, direction: str = "HtoD"):
    """GB/s of the window's copies in ``direction``: the program's counter
    ``counter`` (bytes, counted while the profiler ran, as the copies were
    issued) over the union of the trace's ``Memcpy <direction>`` events
    (the card's own copy time); None without a trace, the counter or a
    copy."""
    t, rec = ctx.trace, recorder()
    if t is None or t.window_s <= 0 or rec is None:
        return None
    nbytes = rec.counters().get(counter)
    seconds = union_s(t, [(n, a, b - a) for n, a, b in t.clipped(("gpu_memcpy",))
                          if direction in n])
    if not nbytes or seconds <= 0:
        return None
    return nbytes / seconds * 1e-9


def split(trace: Trace, recorded, t0: float) -> dict:
    """A traced window split by every program span (``benchmark/split.py``).

    ``idle_in``: % of the window idle (no kernel) while each traced span was
    open, and ``idle_outside_program_spans`` the rest of ``idle``.  ``store``:
    for each name in the store ``recorded``, its spans that overlap the window
    that starts at ``t0`` (perf_counter seconds): their count, threads,
    median, longest and summed milliseconds, their seconds inside the window
    (``busy_s``), the % of the window in which one of them was open
    (``open_share``), and the stretches between them in which none was
    (``gap_ms_max``, ``gap_s_sum``: a serial worker's idle time, across the
    threads it ran on)."""
    w = trace.window_s
    a, b = t0, t0 + w
    traced = {s[0] for s in recorded if s[4]}
    idle = 100.0 * (1.0 - trace.busy_s() / w)
    idle_in = {n: 100.0 * idle_s_in(trace, {n}) / w for n in sorted(traced)}
    out = {"window_s": w, "idle": idle, "idle_in": idle_in,
           "idle_outside_program_spans": idle - 100.0 * idle_s_in(trace, traced) / w,
           "store": {}}
    for name in sorted({s[0] for s in recorded}):
        mine = [s for s in recorded if s[0] == name and s[3] * 1e-9 > a and s[2] * 1e-9 < b]
        if not mine:
            continue
        ms = sorted((s[3] - s[2]) * 1e-6 for s in mine)
        merged = []
        for x, y in sorted((max(s[2] * 1e-9, a), min(s[3] * 1e-9, b)) for s in mine):
            if merged and x <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], y)
            else:
                merged.append([x, y])
        gaps = [nxt[0] - cur[1] for cur, nxt in zip(merged, merged[1:])]
        out["store"][name] = {
            "n": len(mine), "threads": len({s[1] for s in mine}),
            "ms_p50": ms[len(ms) // 2], "ms_max": ms[-1], "ms_sum": sum(ms),
            "busy_s": clipped_s(mine, a, b),
            "open_share": 100.0 * sum(y - x for x, y in merged) / w,
            "gap_ms_max": 1e3 * max(gaps, default=0.0), "gap_s_sum": sum(gaps)}
    return out
