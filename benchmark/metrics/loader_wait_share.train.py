"""Share of the window the training loop spent waiting on the port's
loader (``data/dataset.py::PrefetchLoader``): the harness's span around
each ``next()`` on it, summed, over the window's seconds."""


def read(ctx):
    spans = ctx.run.spans.get("loader.next")
    if not spans or ctx.run.window_s <= 0:
        return None
    return 100.0 * sum(b - a for a, b in spans) / ctx.run.window_s
