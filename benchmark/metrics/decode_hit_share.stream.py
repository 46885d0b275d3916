"""Share of the frames the stream's calling thread took that the decode
thread had already queued when it asked (``pipelines/stream.py``): the
program's counters ``stream.decode_ready`` over ``stream.decode_taken``,
counted while the profiler ran; None without a trace or the counters."""

from benchmark.lib import spans


def read(ctx):
    rec = spans.recorder()
    if ctx.trace is None or rec is None:
        return None
    counters = rec.counters()
    taken = counters.get("stream.decode_taken")
    if not taken or "stream.decode_ready" not in counters:
        return None
    return 100.0 * counters["stream.decode_ready"] / taken
