"""The stage-1 Swin backbone's share of its roofline in the traced window:
the least time of the trunk and CAM work of the frames the program put
through the stage-1 step while traced (its counter ``stage1.frames``;
operations and bytes a frame from the configuration's shapes, the weights
once a stage-1 call, ``lib/swin_work.py``, at the H100's published peaks)
over the device time between the edges of its ``stage1.backbone`` spans
(the counter ``stage1.backbone.device_ms``), as ``backbone_roofline.stream``
reads the other families.  None without a trace or either counter (a
program that does not time the span)."""

from benchmark.lib import spans, swin_work


def read(ctx):
    rec = spans.recorder()
    if ctx.trace is None or rec is None:
        return None
    counters = rec.counters()
    ms, frames = counters.get("stage1.backbone.device_ms"), counters.get("stage1.frames")
    if not ms or not frames:
        return None
    batch = ctx.run.traffic["stage1_batch"]
    return 100.0 * swin_work.least_ms(ctx.run.config, frames, batch) / ms
