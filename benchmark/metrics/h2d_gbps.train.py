"""The rate of the copies to the card while they run: the bytes the
training loop copied while traced (the program's counter ``h2d.bytes``,
``train/loop.py::batch_to_device``, each batch's bytes) over the card's own
copy time, the union of the traced window's ``Memcpy HtoD`` events
(``lib/spans.py::copy_gbps``), in GB/s.  The time the host waits for the
step before, or to queue a copy, is not in it."""

from benchmark.lib import spans


def read(ctx):
    return spans.copy_gbps(ctx, "h2d.bytes")
