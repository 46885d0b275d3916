"""Seeded ConvNeXt weights, made on the device in a few large calls, in the
benchmark's layout (handed alike to the program, through
``models/convnext.py::ConvNeXt``'s constructor, and to
``reference/convnext.py``):

- ``stem``: {w: OIHW [C0, 3, 4, 4], b, ln_w, ln_b};
- ``downsample``: 3 of {ln_w, ln_b, w: OIHW [C_i+1, C_i, 2, 2], b};
- ``stages``: 4 lists of blocks {dw_w: [C, 7, 7], dw_b, ln_w, ln_b,
  w1: OIHW [4C, C, 1, 1], b1, w2: OIHW [C, 4C, 1, 1], b2, gamma};
- ``head``: {ln_w, ln_b}; ``fc_w`` [C, K] and ``fc_b`` [K].

Kernels and LayerNorms are in the served dtype, the kernels stored
channels-last (OHWI in memory, and [7, 7, C] under each depthwise kernel:
the layouts the port's backbones hold); biases, gamma and the classifier
are float32.  Kernels and the classifier are normal with std 0.02 (the
published truncated normal, whose bounds of +-2 never bind at that std),
biases normal with std ``BIAS_STD`` (the published ones are 0; random ones
check the bias paths), LayerNorms at scale 1 and shift 0, and the layer
scale gamma uniform in ``GAMMA_RANGE`` (the published 1e-6 init would
leave every block a millionth of its branch).  A configuration gives
``depths`` and ``dims`` (ConvNeXt-B's 3-3-27-3 and 128-1024); a test cuts
them through :func:`make_backbone`.  The ConvLSTM comes from
``lib/weights.py::make_clstm``.  A seed gives the same numbers on every
call.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from benchmark.lib.weights import DTYPES, make_clstm

W_STD = 0.02
BIAS_STD = 0.05
GAMMA_RANGE = (0.1, 0.5)
STEM, DOWN, DW = 4, 2, 7  # the stem's, the downsampling convs' and the depthwise kernel sizes


def kernel_shapes(depths: Sequence[int], dims: Sequence[int]) -> List[Tuple[int, int, int]]:
    """(O, k, I) of every dense conv kernel, in one fixed order: the stem,
    each downsampling conv, then each block's W1 and W2."""
    out = [(dims[0], STEM, 3)] + [(dims[i + 1], DOWN, dims[i]) for i in range(3)]
    for depth, c in zip(depths, dims):
        out += [(4 * c, 1, c), (c, 1, 4 * c)] * depth
    return out


def make_backbone(depths: Sequence[int], dims: Sequence[int], num_classes: int, seed: int,
                  device, dtype: torch.dtype) -> dict:
    shapes = kernel_shapes(depths, dims)
    sizes = [o * k * k * i for o, k, i in shapes]
    dw_sizes = [DW * DW * c for depth, c in zip(depths, dims) for _ in range(depth)]
    n_bias = sum(o for o, _, _ in shapes) + sum(c for d, c in zip(depths, dims) for _ in range(d))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes) + sum(dw_sizes), generator=gen, device=device)
    biases = torch.randn(n_bias, generator=gen, device=device) * BIAS_STD
    lo, hi = GAMMA_RANGE
    gammas = lo + (hi - lo) * torch.rand(sum(dims[i] * depths[i] for i in range(4)),
                                        generator=gen, device=device)
    fc_w = torch.randn((dims[-1], num_classes), generator=gen, device=device) * W_STD
    off = boff = goff = 0

    def take(n):
        nonlocal off
        off += n
        return (flat[off - n:off] * W_STD).to(dtype)  # a tensor of its own: aligned

    def bias(n):
        nonlocal boff
        boff += n
        return biases[boff - n:boff].clone()

    def conv(o, k, i):
        return take(o * k * k * i).reshape(o, k, k, i).permute(0, 3, 1, 2)  # OIHW, OHWI memory

    def norm(c):
        return {"ln_w": torch.ones(c, device=device, dtype=dtype),
                "ln_b": torch.zeros(c, device=device, dtype=dtype)}

    kernels = iter(shapes)
    o, k, i = next(kernels)
    bb = {"stem": {"w": conv(o, k, i), "b": bias(o), **norm(o)}, "downsample": [],
          "stages": []}
    for _ in range(3):
        o, k, i = next(kernels)
        bb["downsample"].append({**norm(i), "w": conv(o, k, i), "b": bias(o)})
    for depth, c in zip(depths, dims):
        stage = []
        for _ in range(depth):
            (o1, _, i1), (o2, _, i2) = next(kernels), next(kernels)
            blk = {"w1": conv(o1, 1, i1), "b1": bias(o1), "w2": conv(o2, 1, i2), "b2": bias(o2)}
            blk.update(norm(c), dw_w=take(DW * DW * c).reshape(DW, DW, c).permute(2, 0, 1),
                       dw_b=bias(c), gamma=gammas[goff:goff + c].clone())
            goff += c
            stage.append(blk)
        bb["stages"].append(stage)
    del flat
    bb["head"] = norm(dims[-1])
    bb["fc_w"], bb["fc_b"] = fc_w, torch.zeros(num_classes, device=device)
    return bb


def for_config(config: dict, seed: int, device, *, backbone: bool = True,
               clstm: bool = True) -> dict:
    """{"bb": backbone, "cl": ConvLSTM} of a configuration file, from
    ``seed`` (the backbone from ``seed``, the ConvLSTM from ``seed + 1``)."""
    cfg = config["config"]
    dtype = DTYPES[cfg.get("compute_dtype", "bfloat16")]
    out = {}
    if backbone:
        out["bb"] = make_backbone(config["depths"], config["dims"], config["num_classes"], seed,
                                  device, dtype)
    if clstm:
        out["cl"] = make_clstm(cfg["input_size"], cfg["hidden_size"], seed + 1, device, dtype)
    return out
