"""Share of the frames into the stage-1 step that a replay of the model's
CUDA graph served (``models/cam.py::CamGraphs``): the program's counters
``stage1.graph_frames`` over ``stage1.frames``, counted while the profiler
ran; None without a trace or the counters (a program without the graphs)."""

from benchmark.lib import spans


def read(ctx):
    rec = spans.recorder()
    if ctx.trace is None or rec is None:
        return None
    counters = rec.counters()
    frames = counters.get("stage1.frames")
    if not frames or "stage1.graph_frames" not in counters:
        return None
    return 100.0 * counters["stage1.graph_frames"] / frames
