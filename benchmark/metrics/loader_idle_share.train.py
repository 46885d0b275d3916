"""Share of the traced window in which no kernel ran while the training loop
waited on the loader's queue (``data/dataset.py::PrefetchLoader``, the
consumer's ``q.get()``): the program's ``loader.wait`` spans,
``lib/spans.py::idle_share_in``."""

from benchmark.lib import spans


def read(ctx):
    return spans.idle_share_in(ctx, "loader.wait")
