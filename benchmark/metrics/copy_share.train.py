"""Share of the traced window in which a copy between host and card ran:
the union of the copies' intervals (``torch.profiler``'s ``gpu_memcpy``
events, each batch's ``batch_to_device`` above all) over wall."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    busy = ctx.trace.busy_s(("gpu_memcpy",))
    return 100.0 * busy / ctx.trace.window_s if busy > 0 else None
