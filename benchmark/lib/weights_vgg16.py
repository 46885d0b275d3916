"""Seeded VGG16-BN and ``camconv`` weights, made on the device in a few large
calls, in the benchmark's layout (handed alike to the program, through
``models/vgg.py::VGG16``'s constructor, and to ``reference/vgg16.py``):

- ``features``: the 13 convs of configuration "D", each {w: OIHW kernel in
  the served dtype, stored channels-last (OHWI in memory, the layout the
  port's backbones hold), b: [C] in the served dtype, bn: {scale, bias,
  mean, var} f32};
- ``camconv``: {w, b}, the cube-padded 3x3 conv from the last width to
  ``cam_channels``;
- ``fc_w`` [cam_channels, K] and ``fc_b`` [K] in float32, the classifier
  the CAM reads.

Kernels are He-normal (fan-in, so activations keep their scale down the 14
convs); biases are normal with std ``BIAS_STD``; batch norms are at their
identity statistics; the classifier is normal x0.01, as ``lib/weights.py``
makes ResNet-50's.  A configuration runs configuration D's published
widths, 64-512 (:data:`WIDTH` times its multiples), whatever ``base_width``
it sets: that key cuts a ResNet's widths, and a VGG is cut to a test's size
through :func:`make_backbone`'s ``width``.  The ConvLSTM comes from
``lib/weights.py::make_clstm``.  A seed gives the same numbers on every
call.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from benchmark.lib.weights import DTYPES, _bn, make_clstm

# configuration D: conv widths as multiples of the base width, 'M' a 2x2/s2 pool
CFG_D = (1, 1, "M", 2, 2, "M", 4, 4, 4, "M", 8, 8, 8, "M", 8, 8, 8, "M")
WIDTH = 64  # configuration D's first width
BIAS_STD = 0.05


def conv_shapes(width: int, cam_channels: int) -> List[Tuple[int, int]]:
    """(Cin, Cout) of the 13 trunk convs and ``camconv``, in order (all 3x3)."""
    out, cin = [], 3
    for v in CFG_D:
        if v != "M":
            out.append((cin, width * v))
            cin = width * v
    return out + [(cin, cam_channels)]


def make_backbone(cam_channels: int, num_classes: int, seed: int, device, dtype: torch.dtype,
                  width: int = WIDTH) -> dict:
    shapes = conv_shapes(width, cam_channels)
    sizes = [9 * cin * cout for cin, cout in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    biases = torch.randn(sum(c for _, c in shapes), generator=gen, device=device) * BIAS_STD
    convs, off, boff = [], 0, 0
    for (cin, cout), n in zip(shapes, sizes):
        ohwi = (flat[off:off + n] * math.sqrt(2.0 / (9 * cin))).to(dtype).reshape(cout, 3, 3,
                                                                                 cin)
        convs.append({"w": ohwi.permute(0, 3, 1, 2),  # OIHW, channels-last storage
                      "b": biases[boff:boff + cout].to(dtype)})
        off, boff = off + n, boff + cout
    del flat
    fc_w = torch.randn((cam_channels, num_classes), generator=gen, device=device) * 0.01
    return {"features": [dict(c, bn=_bn(c["w"].shape[0], device)) for c in convs[:-1]],
            "camconv": convs[-1], "fc_w": fc_w,
            "fc_b": torch.zeros(num_classes, device=device)}


def for_config(config: dict, seed: int, device, *, backbone: bool = True,
               clstm: bool = True) -> dict:
    """{"bb": backbone, "cl": ConvLSTM} of a configuration file, from
    ``seed`` (the backbone from ``seed``, the ConvLSTM from ``seed + 1``)."""
    cfg = config["config"]
    dtype = DTYPES[cfg.get("compute_dtype", "bfloat16")]
    out = {}
    if backbone:
        out["bb"] = make_backbone(config["cam_channels"], config["num_classes"], seed, device,
                                  dtype)
    if clstm:
        out["cl"] = make_clstm(cfg["input_size"], cfg["hidden_size"], seed + 1, device, dtype)
    return out
