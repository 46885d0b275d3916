"""K1's share of its roofline in the traced window: the least time of the
cube-padded 3x3 conv work the program asked of K1 and its input gradient
while traced (every call recorded with its shapes; operations and bytes per
call as ``lib/k1.py`` counts them, at the H100's published peaks) over the
device time of K1's kernels (``lib/k1.py::KERNEL_PATTERNS``)."""

from benchmark.lib import k1


def read(ctx):
    calls = ctx.run.counters.get("k1_calls")
    if ctx.trace is None or not calls:
        return None
    busy = ctx.trace.device_time_s(k1.KERNEL_PATTERNS)
    if busy <= 0:
        return None
    return 100.0 * sum(k1.least_ms(*c) for c in calls) * 1e-3 / busy
