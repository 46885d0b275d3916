"""Share of the traced window in which no kernel ran while the stream's
calling thread staged a batch in host memory and queued its upload
(``pipelines/stream.py``, ``_stage`` and ``.to(device,
non_blocking=True)``): the program's ``stream.stage`` spans,
``lib/spans.py::idle_share_in``."""

from benchmark.lib import spans


def read(ctx):
    return spans.idle_share_in(ctx, "stream.stage")
