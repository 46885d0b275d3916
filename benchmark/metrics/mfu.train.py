"""The whole training step's share of the card's bf16 peak: forward, input
gradient and weight gradient of the ConvLSTM's convs (3x the forward,
``lib/flops.py``) for the windows stepped in the window, over the window's
seconds times 989 TFLOP/s.  Recomputation is not counted."""

from benchmark.lib import flops
from benchmark.lib.peaks import H100_BF16_FLOPS


def read(ctx):
    windows = ctx.run.counters.get("windows", 0)
    if not windows or ctx.run.window_s <= 0:
        return None
    _, window = flops.for_config(ctx.run.config)
    return 100.0 * windows * 3 * window / (ctx.run.window_s * H100_BF16_FLOPS)
