"""Seeded weights, made on the device in a few large calls.

The benchmark's own layout, handed alike to the program (``lib/port.py``
builds its modules from these tensors) and to the plain reference:

- backbone: ``conv1`` and every block conv an OIHW kernel in the served
  dtype, stored channels-last (OHWI in memory, the layout the port's
  backbones hold); batch norms {scale, bias, mean, var} and the classifier
  ``fc_w`` [C, K], ``fc_b`` in float32;
- ConvLSTM: ``conv1``, ``conv2``, ``gates``, each {w: HWIO [3, 3, Cin, 4H],
  b: [4H]}.

Kernels are He-normal (fan-in for the backbone, so activations keep their
scale; fan-out n = k*k*Cout for the ConvLSTM, as the published
model/clstm.py initializes it); the last batch norm of each residual branch
has scale 0.25, so the residual sum keeps its scale over ResNet-152's 50
blocks.  Biases are zero.  A seed gives the same numbers on every call.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

DEPTHS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3), "resnet152": (3, 8, 36, 3)}
EXPANSION = 4
BRANCH_SCALE = 0.25
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _bn(c: int, device, scale: float = 1.0) -> Dict[str, torch.Tensor]:
    return {"scale": torch.full((c,), scale, device=device),
            "bias": torch.zeros(c, device=device), "mean": torch.zeros(c, device=device),
            "var": torch.ones(c, device=device)}


def backbone_shapes(arch: str, width: int) -> List[Tuple[str, Tuple[int, int, int, int]]]:
    """(key, (O, kh, kw, I)) of every conv kernel, in one fixed order."""
    out = [("conv1", (width, 7, 7, 3))]
    inplanes = width
    for li, depth in enumerate(DEPTHS[arch]):
        planes = width * 2 ** li
        for bi in range(depth):
            stride = 2 if (li > 0 and bi == 0) else 1
            key = f"{li}.{bi}."
            out += [(key + "conv1", (planes, 1, 1, inplanes)),
                    (key + "conv2", (planes, 3, 3, planes)),
                    (key + "conv3", (planes * EXPANSION, 1, 1, planes))]
            if stride != 1 or inplanes != planes * EXPANSION:
                out.append((key + "downsample", (planes * EXPANSION, 1, 1, inplanes)))
            inplanes = planes * EXPANSION
    return out


def make_backbone(arch: str, width: int, num_classes: int, seed: int, device,
                  dtype: torch.dtype) -> dict:
    shapes = backbone_shapes(arch, width)
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    convs, off = {}, 0
    for (key, (o, kh, kw, i)), n in zip(shapes, sizes):
        std = math.sqrt(2.0 / (kh * kw * i))
        ohwi = (flat[off:off + n] * std).to(dtype).reshape(o, kh, kw, i)
        convs[key] = ohwi.permute(0, 3, 1, 2)  # OIHW, channels-last storage
        off += n
    del flat
    c = width * 8 * EXPANSION
    fc_w = torch.randn((c, num_classes), generator=gen, device=device) * 0.01
    bb = {"conv1": convs["conv1"], "bn1": _bn(width, device), "stages": [],
          "fc_w": fc_w, "fc_b": torch.zeros(num_classes, device=device)}
    for li, depth in enumerate(DEPTHS[arch]):
        stage = []
        for bi in range(depth):
            key = f"{li}.{bi}."
            blk = {}
            for ci in (1, 2, 3):
                w = convs[f"{key}conv{ci}"]
                blk[f"conv{ci}"] = w
                blk[f"bn{ci}"] = _bn(w.shape[0], device, BRANCH_SCALE if ci == 3 else 1.0)
            if key + "downsample" in convs:
                blk["downsample"] = convs[key + "downsample"]
                blk["bn_ds"] = _bn(blk["downsample"].shape[0], device)
            stage.append(blk)
        bb["stages"].append(stage)
    return bb


def make_clstm(input_size: int, hidden_size: int, seed: int, device,
               dtype: torch.dtype) -> dict:
    h4 = 4 * hidden_size
    cins = {"conv1": input_size + hidden_size, "conv2": h4, "gates": h4}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(9 * c * h4 for c in cins.values()), generator=gen, device=device)
    flat.mul_(math.sqrt(2.0 / (9 * h4)))
    out, off = {}, 0
    for name, cin in cins.items():
        n = 9 * cin * h4
        out[name] = {"w": flat[off:off + n].reshape(3, 3, cin, h4).to(dtype),
                     "b": torch.zeros(h4, device=device, dtype=dtype)}
        off += n
    return out


def for_config(config: dict, seed: int, device, *, backbone: bool = True,
               clstm: bool = True, clstm_dtype: torch.dtype = None) -> dict:
    """{"bb": backbone, "cl": ConvLSTM} of a configuration file, from
    ``seed`` (the backbone from ``seed``, the ConvLSTM from ``seed + 1``)."""
    cfg = config["config"]
    dtype = DTYPES[cfg.get("compute_dtype", "bfloat16")]
    out = {}
    if backbone:
        out["bb"] = make_backbone(config["arch"], config["base_width"], config["num_classes"],
                                  seed, device, dtype)
    if clstm:
        out["cl"] = make_clstm(cfg["input_size"], cfg["hidden_size"], seed + 1, device,
                               clstm_dtype or dtype)
    return out
