"""Share of the traced window in which no kernel ran on the device:
1 - (union of the kernels' intervals) / wall, from ``torch.profiler``'s
trace of the window.  Copies and sets do not count as busy: a pageable
copy's time is mostly the host staging it."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
