"""Share of the traced window in which the loader's worker read a batch: the
program's ``loader.read`` spans (``data/dataset.py::PrefetchLoader``, one
per batch, on its one worker thread; from the recorder's store), clipped to
the window, summed, over the window (``lib/spans.py::busy_share``).  Near
100 the reader is saturated."""

from benchmark.lib import spans


def read(ctx):
    return spans.busy_share(ctx, "loader.read")
