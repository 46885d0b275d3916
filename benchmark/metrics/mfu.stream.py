"""The whole stream step's share of the card's bf16 peak: the model
operations of the maps yielded in the window (each map one frame through
the cube-padded backbone and its CAM, and one window through the ConvLSTM;
``lib/flops.py`` counts them from the configuration's shapes), over the
window's seconds times 989 TFLOP/s."""

from benchmark.lib import flops
from benchmark.lib.peaks import H100_BF16_FLOPS


def read(ctx):
    maps = ctx.run.counters.get("maps", 0)
    if not maps or ctx.run.window_s <= 0:
        return None
    frame, window = flops.for_config(ctx.run.config)
    return 100.0 * maps * (frame + window) / (ctx.run.window_s * H100_BF16_FLOPS)
