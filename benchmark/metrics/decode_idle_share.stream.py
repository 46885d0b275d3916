"""Share of the traced window in which no kernel ran while the stream's
calling thread decoded or skipped a frame (``pipelines/stream.py``, each
``cap.read()`` or ``cap.grab()``): the program's ``stream.decode`` spans,
``lib/spans.py::idle_share_in``."""

from benchmark.lib import spans


def read(ctx):
    return spans.idle_share_in(ctx, "stream.decode")
