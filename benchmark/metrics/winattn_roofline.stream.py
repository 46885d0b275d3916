"""The cube window-attention kernel's share of its roofline in the traced
window: the least time of the window attentions of the frames the program
put through the stage-1 step while traced (its counter ``stage1.frames``;
every block's, q and the output once a token, k and v once a window slot,
the qkv bias and the table once a stage-1 call, ``lib/swin_work.py``, at
the H100's bytes rate and bf16 peak, the larger) over the device time of
the kernels named ``cube_window_attn`` in the trace.  The work comes from
the counter, not from recorded calls: the kernel runs inside the stage-1
CUDA graph, whose replays Python does not see call by call.  None without
a trace, the counter or the kernel (a program without it)."""

from benchmark.lib import spans, swin_work


def read(ctx):
    rec = spans.recorder()
    if ctx.trace is None or rec is None:
        return None
    frames = rec.counters().get("stage1.frames")
    busy = ctx.trace.device_time_s(("cube_window_attn",))
    if not frames or busy <= 0:
        return None
    batch = ctx.run.traffic["stage1_batch"]
    return 100.0 * swin_work.attn_least_ms(ctx.run.config, frames, batch) * 1e-3 / busy
