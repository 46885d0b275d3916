"""Share of the bytes the training loop copied to the card while traced that
left from page-locked host memory, so that the copy ran without blocking:
the program's counter ``h2d.pinned_bytes`` over ``h2d.bytes``
(``train/loop.py::batch_to_device``), in %.  None without a trace, a
recorder or either counter (a program that counts no pinned bytes)."""

from benchmark.lib import spans


def read(ctx):
    rec = spans.recorder()
    if ctx.trace is None or rec is None:
        return None
    counters = rec.counters()
    total = counters.get("h2d.bytes")
    if not total or "h2d.pinned_bytes" not in counters:
        return None
    return 100.0 * counters["h2d.pinned_bytes"] / total
