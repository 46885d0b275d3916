"""Share of the traced window in which no kernel ran while the stream's
calling thread waited for the decode thread's next frame
(``pipelines/stream.py``, each blocking take from its queue): the
program's ``stream.decode_wait`` spans, ``lib/spans.py::idle_share_in``."""

from benchmark.lib import spans


def read(ctx):
    return spans.idle_share_in(ctx, "stream.decode_wait")
