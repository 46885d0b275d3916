"""ConvNeXt's parameters: a seeded numpy tree and the port's module from it.

ConvNeXt is a backbone of the port alone (the JAX package has none), so
its tree is the port's own, in the layouts the JAX package's trees use
(``compat/jax_params.py``): conv kernels HWIO, LayerNorms as {scale, bias},
the classifier as {w: [C, K], b: [K]}:

- ``stem``: {w [4, 4, 3, C0], b, ln};
- ``downsample``: 3 of {ln, w [2, 2, C_i, C_i+1], b};
- ``stages``: 4 lists of blocks {dw: {w [7, 7, 1, C], b}, ln,
  pw1: {w [1, 1, C, 4C], b}, pw2: {w [1, 1, 4C, C], b}, gamma [C]};
- ``head_ln``; ``fc``.

:func:`init_convnext_params` makes one from a seed: kernels and the
classifier normal with std 0.02 (the published truncated normal, whose
bounds of +-2 never bind at that std), biases normal with std 0.05 (the
published biases are 0; random ones check the bias paths), LayerNorms at
scale 1 and shift 0, and the layer scale gamma uniform in [0.1, 0.5] (the
published 1e-6 would leave each block a millionth of its branch, so
neither a check nor a timing would see the blocks).
:func:`convnext_from_params` builds ``models.convnext.ConvNeXt``, and
``jax_params.backbone_from_params`` calls it for an ``arch`` of
``models.convnext.ARCHS``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from cp360_tpu_torch.models.convnext import ARCHS, DOWN, STEM, ConvNeXt

W_STD = 0.02
BIAS_STD = 0.05
GAMMA_RANGE = (0.1, 0.5)


def init_convnext_params(seed: int, arch: str = "convnext_base", num_classes: int = 1000,
                         depths: Optional[Sequence[int]] = None,
                         dims: Optional[Sequence[int]] = None) -> dict:
    """The seeded tree of ``arch`` (``depths`` and ``dims`` override its
    published ones, to cut a model to a test's size)."""
    if arch not in ARCHS:
        raise ValueError(f"unknown ConvNeXt arch {arch!r} (one of {sorted(ARCHS)})")
    depths = tuple(depths or ARCHS[arch][0])
    dims = tuple(dims or ARCHS[arch][1])
    rs = np.random.RandomState(seed)

    def normal(shape, std):
        return (rs.standard_normal(shape) * std).astype(np.float32)

    def ln(c):
        return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}

    def conv(k, cin, cout):
        return {"w": normal((k, k, cin, cout), W_STD), "b": normal(cout, BIAS_STD)}

    tree = {"stem": dict(conv(STEM, 3, dims[0]), ln=ln(dims[0])),
            "downsample": [dict(conv(DOWN, dims[i], dims[i + 1]), ln=ln(dims[i]))
                           for i in range(3)],
            "stages": []}
    for depth, c in zip(depths, dims):
        tree["stages"].append([{
            "dw": conv(7, 1, c), "ln": ln(c), "pw1": conv(1, c, 4 * c),
            "pw2": conv(1, 4 * c, c),
            "gamma": rs.uniform(*GAMMA_RANGE, size=c).astype(np.float32)}
            for _ in range(depth)])
    tree["head_ln"] = ln(dims[-1])
    tree["fc"] = {"w": normal((dims[-1], num_classes), W_STD),
                  "b": np.zeros(num_classes, np.float32)}
    return tree


def convnext_from_params(params: dict, use_cube_pad: bool = True,
                         compute_dtype: torch.dtype = torch.bfloat16, device="cpu") -> ConvNeXt:
    """A ConvNeXt tree -> the port's ``ConvNeXt`` on ``device``: conv
    kernels and LayerNorms in the compute dtype (kernels OIHW over
    channels-last storage, the depthwise kernels [C, 7, 7] over [7, 7, C]),
    biases, gamma and the classifier in f32; its ``arch`` named from its
    depths and widths."""
    def cd(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, compute_dtype)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)

    def oihw(w):  # HWIO -> OIHW over OHWI memory
        return cd(np.asarray(w).transpose(3, 0, 1, 2)).permute(0, 3, 1, 2)

    def norm(p):
        return {"ln_w": cd(p["scale"]), "ln_b": cd(p["bias"])}

    def block(b):
        return {"dw_w": cd(np.asarray(b["dw"]["w"])[:, :, 0, :]).permute(2, 0, 1),
                "dw_b": f32(b["dw"]["b"]), **norm(b["ln"]),
                "w1": oihw(b["pw1"]["w"]), "b1": f32(b["pw1"]["b"]),
                "w2": oihw(b["pw2"]["w"]), "b2": f32(b["pw2"]["b"]), "gamma": f32(b["gamma"])}

    stem = params["stem"]
    module_params = {
        "stem": {"w": oihw(stem["w"]), "b": f32(stem["b"]), **norm(stem["ln"])},
        "downsample": [{"w": oihw(d["w"]), "b": f32(d["b"]), **norm(d["ln"])}
                       for d in params["downsample"]],
        "stages": [[block(b) for b in stage] for stage in params["stages"]],
        "head": norm(params["head_ln"]),
        "fc_w": f32(params["fc"]["w"]), "fc_b": f32(params["fc"]["b"])}
    return ConvNeXt(module_params, use_cube_pad, compute_dtype).eval()
