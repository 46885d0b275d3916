"""Share of the traced window in which no kernel ran while the stream's
calling thread waited for a batch's remap jobs (``pipelines/stream.py``, the
``f.result()`` loop): the program's ``stream.remap_wait`` spans,
``lib/spans.py::idle_share_in``."""

from benchmark.lib import spans


def read(ctx):
    return spans.idle_share_in(ctx, "stream.remap_wait")
