"""Swin's parameters: a seeded numpy tree and the port's module from it.

Swin is a backbone of the port alone (the JAX package has none), so its
tree is the port's own, in the layouts the JAX package's trees use
(``compat/jax_params.py``): conv kernels HWIO, linears {w: [in, out], b},
LayerNorms as {scale, bias}:

- ``patch_embed``: {w [4, 4, 3, C0], b, ln};
- ``stages``: 4 lists of blocks {ln1, qkv: {w [C, 3C], b}, rel_bias
  [(2M-1)^2, heads], proj: {w [C, C], b}, ln2, fc1: {w [C, 4C], b},
  fc2: {w [4C, C], b}};
- ``merges``: 3 of {ln [4C], w [4C, 2C]} (no bias);
- ``head_ln``; ``fc``: {w [C, K], b}.

:func:`init_swin_params` makes one from a seed: every kernel normal with
std 1/sqrt(fan in) (the published truncated normal 0.02 would give the
attention logits a spread of ~0.05 at these widths, every row of the
softmax near uniform, so that a kernel that mixed up its keys would pass
a check), the relative-position tables N(0, 1), biases normal with std
0.05, LayerNorms at scale 1 and shift 0, the classifier N(0, 0.02) with a
zero bias.  :func:`swin_from_params` builds ``models.swin.SwinTransformer``,
and ``jax_params.backbone_from_params`` calls it for an ``arch`` of
``models.swin.ARCHS``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from cp360_tpu_torch.models.swin import ARCHS, MLP_RATIO, PATCH, WINDOW, SwinTransformer
from cp360_tpu_torch.ops.cube_window_attn import HEAD_DIM

BIAS_STD = 0.05
FC_STD = 0.02


def init_swin_params(seed: int, arch: str = "swin_base", num_classes: int = 1000,
                     depths: Optional[Sequence[int]] = None,
                     embed: Optional[int] = None) -> dict:
    """The seeded tree of ``arch`` (``depths`` and ``embed`` override its
    published ones, to cut a model to a test's size; the heads follow the
    widths, 32 channels a head)."""
    if arch not in ARCHS:
        raise ValueError(f"unknown Swin arch {arch!r} (one of {sorted(ARCHS)})")
    embed = int(embed or ARCHS[arch][0])
    depths = tuple(depths or ARCHS[arch][1])
    dims = [embed * 2 ** i for i in range(4)]
    rs = np.random.RandomState(seed)

    def normal(shape, std):
        return (rs.standard_normal(shape) * std).astype(np.float32)

    def ln(c):
        return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}

    def linear(cin, cout, bias=True):
        out = {"w": normal((cin, cout), cin ** -0.5)}
        if bias:
            out["b"] = normal(cout, BIAS_STD)
        return out

    fan = PATCH * PATCH * 3
    tree = {"patch_embed": {"w": normal((PATCH, PATCH, 3, embed), fan ** -0.5),
                            "b": normal(embed, BIAS_STD), "ln": ln(embed)},
            "stages": [], "merges": []}
    for i, (depth, c) in enumerate(zip(depths, dims)):
        if i:
            tree["merges"].append({"ln": ln(2 * c), "w": linear(2 * c, c, bias=False)["w"]})
        tree["stages"].append([{
            "ln1": ln(c), "qkv": linear(c, 3 * c),
            "rel_bias": normal(((2 * WINDOW - 1) ** 2, c // HEAD_DIM), 1.0),
            "proj": linear(c, c), "ln2": ln(c), "fc1": linear(c, MLP_RATIO * c),
            "fc2": linear(MLP_RATIO * c, c)} for _ in range(depth)])
    tree["head_ln"] = ln(dims[-1])
    tree["fc"] = {"w": normal((dims[-1], num_classes), FC_STD),
                  "b": np.zeros(num_classes, np.float32)}
    return tree


def swin_from_params(params: dict, use_cube_pad: bool = True,
                     compute_dtype: torch.dtype = torch.bfloat16,
                     device="cpu") -> SwinTransformer:
    """A Swin tree -> the port's ``SwinTransformer`` on ``device``: kernels
    and LayerNorms in the compute dtype (kernels OIHW over channels-last
    storage), biases, the relative-position tables and the classifier in
    f32; its ``arch`` named from its widths, depths and heads."""
    def cd(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, compute_dtype)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)

    def oihw(w):  # HWIO -> OIHW over OHWI memory
        return cd(np.asarray(w).transpose(3, 0, 1, 2)).permute(0, 3, 1, 2)

    def lin(w):  # [in, out] -> OIHW [out, in, 1, 1]
        return oihw(np.asarray(w)[None, None])

    def norm(p, suffix=""):
        return {f"ln{suffix}_w": cd(p["scale"]), f"ln{suffix}_b": cd(p["bias"])}

    def block(b):
        return {**norm(b["ln1"], "1"), "w_qkv": lin(b["qkv"]["w"]), "b_qkv": f32(b["qkv"]["b"]),
                "table": f32(b["rel_bias"]), "w_proj": lin(b["proj"]["w"]),
                "b_proj": f32(b["proj"]["b"]), **norm(b["ln2"], "2"),
                "w1": lin(b["fc1"]["w"]), "b1": f32(b["fc1"]["b"]),
                "w2": lin(b["fc2"]["w"]), "b2": f32(b["fc2"]["b"])}

    pe = params["patch_embed"]
    module_params = {
        "stem": {"w": oihw(pe["w"]), "b": f32(pe["b"]), **norm(pe["ln"])},
        "merges": [{**norm(m["ln"]), "w": lin(m["w"])} for m in params["merges"]],
        "stages": [[block(b) for b in stage] for stage in params["stages"]],
        "head": norm(params["head_ln"]),
        "fc_w": f32(params["fc"]["w"]), "fc_b": f32(params["fc"]["b"])}
    return SwinTransformer(module_params, use_cube_pad, compute_dtype).eval()
