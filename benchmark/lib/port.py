"""The program's modules, built from the benchmark's seeded weights
(``lib/weights.py``) through the port's own constructors."""

from __future__ import annotations

from benchmark.lib.weights import DTYPES


def program_config(config: dict):
    """The port's ``Config``: its defaults, with the keys the configuration
    file sets."""
    from cp360_tpu_torch.config import Config

    return Config(**config["config"])


def resnet(config: dict, bb: dict):
    """``models.resnet.ResNet`` holding ``bb``'s tensors (no copy)."""
    from cp360_tpu_torch.models.resnet import ResNet

    cfg = config["config"]
    dtype = DTYPES[cfg.get("compute_dtype", "bfloat16")]
    stem = {"conv1": bb["conv1"], "bn1": bb["bn1"]}
    stages = []
    for stage in bb["stages"]:
        blocks = []
        for blk in stage:
            convs = {k: blk[k] for k in ("conv1", "conv2", "conv3")}
            bns = {k: blk[k] for k in ("bn1", "bn2", "bn3")}
            if "downsample" in blk:
                convs["downsample"], bns["downsample"] = blk["downsample"], blk["bn_ds"]
            blocks.append({"convs": convs, "bns": bns})
        stages.append(blocks)
    return ResNet(stem, stages, {"w": bb["fc_w"], "b": bb["fc_b"]}, config["arch"],
                  cfg.get("cube_pad", True), dtype).eval()


def clstm(config: dict, cl: dict, trainable: bool = False):
    """``models.clstm.ConvLSTM`` over ``cl``'s tensors: served in the
    compute dtype, or as float32 trainable masters."""
    from cp360_tpu_torch.models.clstm import ConvLSTM

    cfg = config["config"]
    cell = ConvLSTM(cl, DTYPES[cfg.get("compute_dtype", "bfloat16")], cfg.get("cube_pad", True),
                    cfg.get("clstm_conv_impl", "xla"), trainable=trainable)
    return cell.train() if trainable else cell.eval()
