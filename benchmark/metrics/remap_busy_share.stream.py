"""Share of the stream's remap pool kept busy in the traced window: the
program's ``stream.remap`` spans (``pipelines/stream.py``, one per frame's
remap job, on the pool's threads; from the recorder's store), clipped to
the window, summed, over the window times the pool's ``REMAP_WORKERS``
threads (``lib/spans.py::busy_share``)."""

from benchmark.lib import spans


def read(ctx):
    from cp360_tpu_torch.pipelines.stream import REMAP_WORKERS

    return spans.busy_share(ctx, "stream.remap", REMAP_WORKERS)
