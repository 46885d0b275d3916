"""Share of the traced window in which no kernel ran while the training loop
copied a batch to the card (``train/loop.py::batch_to_device``, its pageable
copy waiting for the step before): the program's ``train.h2d`` spans,
``lib/spans.py::idle_share_in``."""

from benchmark.lib import spans


def read(ctx):
    return spans.idle_share_in(ctx, "train.h2d")
