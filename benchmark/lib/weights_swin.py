"""Seeded Swin Transformer weights, made on the device in a few large calls,
in the benchmark's layout (handed alike to the program, through
``models/swin.py::SwinTransformer``'s constructor, and to
``reference/swin.py``):

- ``stem``: {w: OIHW [C0, 3, 4, 4], b, ln_w, ln_b};
- ``stages``: 4 lists of blocks {ln1_w, ln1_b, w_qkv: OIHW [3C, C, 1, 1],
  b_qkv, table: [(2M-1)^2, heads], w_proj: [C, C, 1, 1], b_proj, ln2_w,
  ln2_b, w1: [4C, C, 1, 1], b1, w2: [C, 4C, 1, 1], b2};
- ``merges``: 3 of {ln_w, ln_b over 4C, w: OIHW [2C, 4C, 1, 1]} (no bias);
- ``head``: {ln_w, ln_b}; ``fc_w`` [C, K] and ``fc_b`` [K].

Kernels and LayerNorms are in the served dtype, the kernels stored
channels-last (OHWI in memory, the layout the port's backbones hold);
biases, the relative-position tables and the classifier are float32.
Every kernel is normal with std 1/sqrt(fan in): the published truncated
normal 0.02 gives the attention logits a spread of ~0.05 at these widths,
so every row of the softmax is near uniform and a kernel that mixed up
its keys would pass the check.  The tables are N(0, 1), biases normal with
std ``BIAS_STD`` (the published ones are 0; random ones check the bias
paths), LayerNorms at scale 1 and shift 0, the classifier normal with std
0.02 and a zero bias.  A configuration gives ``embed``, ``depths``,
``heads`` and ``window`` (Swin-B's 128, 2-2-18-2, 4-8-16-32 and 7); a test
cuts them through :func:`make_backbone`.  The ConvLSTM comes from
``lib/weights.py::make_clstm``.  A seed gives the same numbers on every
call.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from benchmark.lib.weights import DTYPES, make_clstm

BIAS_STD = 0.05
FC_STD = 0.02
PATCH, MLP_RATIO = 4, 4


def dims_of(embed: int) -> List[int]:
    return [embed * 2 ** i for i in range(4)]


def kernel_shapes(embed: int, depths: Sequence[int]) -> List[Tuple[int, int, int]]:
    """(O, k, I) of every kernel, in one fixed order: the patch embed, then
    each stage's merging (stages 2-4) and its blocks' qkv, proj, fc1, fc2."""
    dims = dims_of(embed)
    out = [(embed, PATCH, 3)]
    for i, (depth, c) in enumerate(zip(depths, dims)):
        if i:
            out.append((c, 1, 2 * c))
        out += [(3 * c, 1, c), (c, 1, c), (MLP_RATIO * c, 1, c), (c, 1, MLP_RATIO * c)] * depth
    return out


def bias_sizes(embed: int, depths: Sequence[int]) -> List[int]:
    """The biases in the order :func:`make_backbone` takes them."""
    out = [embed]
    for depth, c in zip(depths, dims_of(embed)):
        out += [3 * c, c, MLP_RATIO * c, c] * depth
    return out


def make_backbone(embed: int, depths: Sequence[int], heads: Sequence[int], window: int,
                  num_classes: int, seed: int, device, dtype: torch.dtype) -> dict:
    shapes = kernel_shapes(embed, depths)
    dims = dims_of(embed)
    n_table = (2 * window - 1) ** 2
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(o * k * k * i for o, k, i in shapes), generator=gen, device=device)
    biases = torch.randn(sum(bias_sizes(embed, depths)), generator=gen, device=device) * BIAS_STD
    tables = torch.randn(n_table * sum(h * d for h, d in zip(heads, depths)), generator=gen,
                         device=device)
    fc_w = torch.randn((dims[-1], num_classes), generator=gen, device=device) * FC_STD
    off = boff = toff = 0
    kernels = iter(shapes)

    def kernel():
        nonlocal off
        o, k, i = next(kernels)
        n = o * k * k * i
        off += n
        w = (flat[off - n:off] * (k * k * i) ** -0.5).to(dtype)  # a tensor of its own: aligned
        return w.reshape(o, k, k, i).permute(0, 3, 1, 2)  # OIHW, OHWI memory

    def bias(n):
        nonlocal boff
        boff += n
        return biases[boff - n:boff].clone()

    def table(h):
        nonlocal toff
        toff += n_table * h
        return tables[toff - n_table * h:toff].reshape(n_table, h).clone()

    def norm(c, key="ln"):
        return {f"{key}_w": torch.ones(c, device=device, dtype=dtype),
                f"{key}_b": torch.zeros(c, device=device, dtype=dtype)}

    bb = {"stem": {"w": kernel(), "b": bias(embed), **norm(embed)}, "merges": [], "stages": []}
    for i, (depth, c, h) in enumerate(zip(depths, dims, heads)):
        if i:
            bb["merges"].append({**norm(2 * c), "w": kernel()})
        stage = []
        for _ in range(depth):
            blk = {**norm(c, "ln1"), "w_qkv": kernel(), "b_qkv": bias(3 * c), "table": table(h),
                   "w_proj": kernel(), "b_proj": bias(c), **norm(c, "ln2")}
            blk.update(w1=kernel(), b1=bias(MLP_RATIO * c), w2=kernel(), b2=bias(c))
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
        out["bb"] = make_backbone(config["embed"], config["depths"], config["heads"],
                                  config["window"], config["num_classes"], seed, device, dtype)
    if clstm:
        out["cl"] = make_clstm(cfg["input_size"], cfg["hidden_size"], seed + 1, device, dtype)
    return out
