"""The cube-padded depthwise conv kernel's share of its roofline in the
traced window: the least time of the depthwise 7x7 convs of the frames the
program put through the stage-1 step while traced (its counter
``stage1.frames``; every block's conv, 49 multiply-adds an output value,
the input read once, the output written once, the kernels and biases once
a stage-1 call, ``lib/convnext_work.py``, at the H100's bytes rate and f32
peak) over the device time of the kernels named ``cube_dwconv`` in the
trace.  The work comes from the counter, not from recorded calls: the
kernel runs inside the stage-1 CUDA graph, whose replays Python does not
see call by call.  None without a trace, the counter or the kernel (a
program without it)."""

from benchmark.lib import convnext_work, spans


def read(ctx):
    rec = spans.recorder()
    if ctx.trace is None or rec is None:
        return None
    frames = rec.counters().get("stage1.frames")
    busy = ctx.trace.device_time_s(("cube_dwconv",))
    if not frames or busy <= 0:
        return None
    batch = ctx.run.traffic["stage1_batch"]
    return 100.0 * convnext_work.dw_least_ms(ctx.run.config, frames, batch) * 1e-3 / busy
