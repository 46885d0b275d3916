"""The whole stream step's share of the card's bf16 peak with the Swin
backbone: the model operations of the maps yielded in the window (each map
one frame through the cube-padded Swin Transformer and its CAM,
``lib/swin_work.py``, and one window through the ConvLSTM,
``lib/flops.py::clstm_window_flops``), over the window's seconds times
989 TFLOP/s.  ``mfu.stream`` counts ResNets only, ``mfu_vgg16.stream``
VGG16-BN, ``mfu_convnext.stream`` ConvNeXt."""

from benchmark.lib import flops, swin_work
from benchmark.lib.peaks import H100_BF16_FLOPS


def read(ctx):
    maps = ctx.run.counters.get("maps", 0)
    if not maps or ctx.run.window_s <= 0:
        return None
    cfg = ctx.run.config["config"]
    frame, _ = swin_work.frame_work(ctx.run.config, ctx.run.traffic["stage1_batch"])
    window = flops.clstm_window_flops(cfg["input_size"], cfg["hidden_size"],
                                      cfg.get("cube_dim", 224) // 32, cfg.get("seq_len", 5))
    return 100.0 * maps * (frame + window) / (ctx.run.window_s * H100_BF16_FLOPS)
