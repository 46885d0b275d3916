"""The stage-1 backbone's share of its roofline in the traced window: the
least time of the backbone work of the frames the program put through the
stage-1 step while traced (its counter ``stage1.frames``; operations and
bytes a frame from the configuration's shapes, ``lib/backbone_work.py``,
at the H100's published peaks) over the device time between the edges of
its ``stage1.backbone`` spans (the counter ``stage1.backbone.device_ms``).
That time includes any stretch in which the card waited for the host to
launch the backbone's next kernel: a backbone whose launches the host
paces, as ResNet-50's in ``r50-stream``, reads low for its launch pace as
much as for its kernels.  None without a trace or either counter (a
program that does not time the span)."""

from benchmark.lib import backbone_work, spans


def read(ctx):
    rec = spans.recorder()
    if ctx.trace is None or rec is None:
        return None
    counters = rec.counters()
    ms, frames = counters.get("stage1.backbone.device_ms"), counters.get("stage1.frames")
    if not ms or not frames:
        return None
    return 100.0 * backbone_work.least_ms(ctx.run.config, frames) / ms
