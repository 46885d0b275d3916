"""Share of the traced window that the stage-1 backbone and its CAM held
the card: the program's counter ``stage1.backbone.device_ms``
(``pipelines/extract.py::_cam_and_saliency``, the device time between the
edges of each ``stage1.backbone`` span, taken by a pair of CUDA timing
events on the stream the backbone's kernels run on), over the traced
window.  The span's device time includes any stretch in which the card
waited for the host to launch the backbone's next kernel, so on a
host-paced backbone it reads more than the kernels' own time.  None
without a trace or the counter (a program that does not time the span)."""

from benchmark.lib import spans


def read(ctx):
    rec = spans.recorder()
    if ctx.trace is None or ctx.trace.window_s <= 0 or rec is None:
        return None
    ms = rec.counters().get("stage1.backbone.device_ms")
    if not ms:
        return None
    return 100.0 * ms * 1e-3 / ctx.trace.window_s
