"""Carries the JAX package's parameters across into the port's modules.

A JAX param tree is a nested dict (lists for ResNet stages) of arrays in the
JAX layouts: conv kernels HWIO, the classifier ``fc`` as {'w': [C, K],
'b': [K]}, batch norms as {'scale', 'bias', 'mean', 'var'} (see
``cp360_tpu/models/resnet.py::init_resnet_params`` and
``cp360_tpu/models/clstm.py::init_clstm_params``).  Here it is read as
numpy arrays (``np.asarray`` on each leaf) and turned into the port's
modules:

- :func:`resnet_from_params` -> ``models.resnet.ResNet``: conv kernels go
  HWIO -> OIHW in channels_last storage (cuDNN's layout) and the compute
  dtype; batch norms and fc stay f32;
- :func:`clstm_from_params` -> ``models.clstm.ConvLSTM``: HWIO kernels (the
  layout the fused cube conv reads) and biases in the compute dtype, or as
  f32 trainable parameters; :func:`clstm_to_params` turns one back into a
  numpy tree.

It also reads and writes the JAX package's flat ``.npz`` checkpoints (own
copies of ``flatten_params`` / ``unflatten_params`` / ``save_npz`` /
``load_npz``, ``cp360_tpu/compat/torch_weights.py:121-165``), converts the
reference's state dicts (:func:`convert_resnet_state_dict` for the
torchvision ResNet-50, :func:`convert_clstm_state_dict` for the ConvLSTM,
``torch_weights.py:50-114``) and makes seeded random
parameters for smoke runs: numpy ``RandomState``, He-normal fan-out as
``cp360_tpu/models/layers.py:112`` (reference model/resnet_cubic.py:137-143,
model/clstm.py:84-90).  The numbers differ from ``jax.random``'s for the
same seed; the tests hand one numpy tree to both packages.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict, Mapping

import numpy as np
import torch

from cp360_tpu_torch.models.clstm import ConvLSTM
from cp360_tpu_torch.models.resnet import ARCHS, EXPANSION, ResNet

# ---------------------------------------------------------------------------
# Flat .npz checkpoints (the JAX package's portable format).
# ---------------------------------------------------------------------------


def flatten_params(params, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(flatten_params(v, f"{prefix}{k}/"))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.update(flatten_params(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(params)
    return out


def unflatten_params(flat: Mapping[str, np.ndarray]):
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(val)

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def save_npz(path: str, params) -> None:
    """Write a param tree as the flat ``.npz`` :func:`load_npz` reads, in
    one atomic step: a temp file in the same directory, then a rename, so a
    killed writer never leaves a torn checkpoint under the final name.
    Stored uncompressed: trained f32 weights do not compress, and zlib
    would take a minute over the 1.4 GB of a full-width ConvLSTM."""
    if not path.endswith(".npz"):
        path += ".npz"  # np.savez would append it after the rename
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flatten_params(params))
    os.replace(tmp, path)


def load_npz(path: str):
    with np.load(path) as f:
        return unflatten_params(dict(f))


def _hwio(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).transpose(2, 3, 1, 0))


def _bn_sd(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    return {"scale": np.asarray(sd[f"{prefix}.weight"]), "bias": np.asarray(sd[f"{prefix}.bias"]),
            "mean": np.asarray(sd[f"{prefix}.running_mean"]),
            "var": np.asarray(sd[f"{prefix}.running_var"])}


def convert_resnet_state_dict(sd: Mapping[str, np.ndarray], arch: str = "resnet50") -> dict:
    """torchvision-style ResNet state dict (OIHW convs, ``fc.weight``
    [K, C]) -> the JAX package's ResNet param tree (HWIO, ``fc`` [C, K])."""
    if arch not in ARCHS:
        raise NotImplementedError(
            f'arch {arch!r} is not ported yet; see ROADMAP.md, "resnet18/34/101/152"')
    params = {"conv1": {"w": _hwio(sd["conv1.weight"])}, "bn1": _bn_sd(sd, "bn1")}
    for li, depth in enumerate(ARCHS[arch]):
        stage = []
        for bi in range(depth):
            pre = f"layer{li + 1}.{bi}"
            blk = {}
            for ci in (1, 2, 3):
                blk[f"conv{ci}"] = {"w": _hwio(sd[f"{pre}.conv{ci}.weight"])}
                blk[f"bn{ci}"] = _bn_sd(sd, f"{pre}.bn{ci}")
            if f"{pre}.downsample.0.weight" in sd:
                blk["downsample"] = {"conv": {"w": _hwio(sd[f"{pre}.downsample.0.weight"])},
                                     "bn": _bn_sd(sd, f"{pre}.downsample.1")}
            stage.append(blk)
        params[f"layer{li + 1}"] = stage
    params["fc"] = {"w": np.ascontiguousarray(np.asarray(sd["fc.weight"]).T),
                    "b": np.asarray(sd["fc.bias"])}
    return params


_CLSTM_NAME_MAP = {"Conv1": "conv1", "Conv2": "conv2", "Gates": "gates"}


def convert_clstm_state_dict(sd: Mapping[str, np.ndarray]) -> dict:
    """Reference ConvLSTMCell state dict (``Conv1``/``Conv2``/``Gates``
    ``.weight``/``.bias``, model/clstm.py:28-34; OIHW kernels) -> the
    ConvLSTM param tree (HWIO).  Other key names fall back to positional
    order, as the reference's sequential loader does (model/clstm.py:92-101):
    conv1.w, conv1.b, conv2.w, conv2.b, gates.w, gates.b."""
    named = {}
    for k, v in sd.items():
        m = re.match(r"^(Conv1|Conv2|Gates)\.(weight|bias)$", k)
        if m:
            named[(_CLSTM_NAME_MAP[m.group(1)], m.group(2))] = np.asarray(v)
    if len(named) != 6:
        vals = list(sd.values())
        if len(vals) < 6:
            raise ValueError(f"CLSTM checkpoint has {len(vals)} tensors, expected 6")
        order = [(n, p) for n in ("conv1", "conv2", "gates") for p in ("weight", "bias")]
        named = {o: np.asarray(v) for o, v in zip(order, vals)}
    return {name: {"w": _hwio(named[(name, "weight")]), "b": named[(name, "bias")]}
            for name in ("conv1", "conv2", "gates")}


# ---------------------------------------------------------------------------
# Seeded initialization (numpy).
# ---------------------------------------------------------------------------


def he_conv(rs: np.random.RandomState, kh: int, kw: int, cin: int, cout: int) -> np.ndarray:
    """He-normal fan-out HWIO kernel, f32."""
    std = math.sqrt(2.0 / (kh * kw * cout))
    return (rs.standard_normal((kh, kw, cin, cout)) * std).astype(np.float32)


def bn_params(c: int) -> dict:
    return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32),
            "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}


def init_resnet_params(seed: int, arch: str = "resnet50", num_classes: int = 1000) -> dict:
    """A He-initialized ResNet param tree in the JAX package's structure."""
    if arch not in ARCHS:
        raise NotImplementedError(
            f'arch {arch!r} is not ported yet; see ROADMAP.md, "resnet18/34/101/152"')
    rs = np.random.RandomState(seed)
    params = {"conv1": {"w": he_conv(rs, 7, 7, 3, 64)}, "bn1": bn_params(64)}
    inplanes = 64
    for li, depth in enumerate(ARCHS[arch]):
        planes = 64 * 2 ** li
        stage = []
        for bi in range(depth):
            stride = 2 if (li > 0 and bi == 0) else 1
            blk = {
                "conv1": {"w": he_conv(rs, 1, 1, inplanes, planes)},
                "bn1": bn_params(planes),
                "conv2": {"w": he_conv(rs, 3, 3, planes, planes)},
                "bn2": bn_params(planes),
                "conv3": {"w": he_conv(rs, 1, 1, planes, planes * EXPANSION)},
                "bn3": bn_params(planes * EXPANSION),
            }
            if stride != 1 or inplanes != planes * EXPANSION:
                blk["downsample"] = {
                    "conv": {"w": he_conv(rs, 1, 1, inplanes, planes * EXPANSION)},
                    "bn": bn_params(planes * EXPANSION),
                }
            stage.append(blk)
            inplanes = planes * EXPANSION
        params[f"layer{li + 1}"] = stage
    params["fc"] = {
        "w": (rs.standard_normal((512 * EXPANSION, num_classes)) * 0.01).astype(np.float32),
        "b": np.zeros(num_classes, np.float32),
    }
    return params


def init_clstm_params(seed: int, input_size: int, hidden_size: int) -> dict:
    """He-initialized ConvLSTM params (reference model/clstm.py:84-90); zero
    biases."""
    rs = np.random.RandomState(seed)
    h4 = 4 * hidden_size
    cins = {"conv1": input_size + hidden_size, "conv2": h4, "gates": h4}
    return {name: {"w": he_conv(rs, 3, 3, cin, h4), "b": np.zeros(h4, np.float32)}
            for name, cin in cins.items()}


# ---------------------------------------------------------------------------
# Param tree -> modules.
# ---------------------------------------------------------------------------


def _oihw(w, dtype, device) -> torch.Tensor:
    """HWIO array -> OIHW tensor in channels_last storage (OHWI in memory)."""
    ohwi = torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(3, 0, 1, 2)))
    return ohwi.to(device=device, dtype=dtype).permute(0, 3, 1, 2)


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)


def _bn(p: dict, device) -> dict:
    return {k: _f32(p[k], device) for k in ("scale", "bias", "mean", "var")}


def resnet_from_params(params: dict, arch: str = "resnet50", use_cube_pad: bool = True,
                       compute_dtype: torch.dtype = torch.bfloat16,
                       device="cpu") -> ResNet:
    """A JAX ResNet param tree -> the port's ``ResNet`` on ``device``."""
    stem = {"conv1": _oihw(params["conv1"]["w"], compute_dtype, device),
            "bn1": _bn(params["bn1"], device)}
    stages = []
    for li in range(4):
        stage = []
        for blk in params[f"layer{li + 1}"]:
            convs = {k: _oihw(blk[k]["w"], compute_dtype, device)
                     for k in ("conv1", "conv2", "conv3")}
            bns = {k: _bn(blk[k], device) for k in ("bn1", "bn2", "bn3")}
            if "downsample" in blk:
                convs["downsample"] = _oihw(blk["downsample"]["conv"]["w"], compute_dtype, device)
                bns["downsample"] = _bn(blk["downsample"]["bn"], device)
            stage.append({"convs": convs, "bns": bns})
        stages.append(stage)
    fc = {"w": _f32(params["fc"]["w"], device), "b": _f32(params["fc"]["b"], device)}
    return ResNet(stem, stages, fc, arch, use_cube_pad, compute_dtype).eval()


def clstm_from_params(params: dict, compute_dtype: torch.dtype = torch.bfloat16,
                      use_cube_pad: bool = True, conv_impl: str = "xla",
                      device="cpu", trainable: bool = False) -> ConvLSTM:
    """A JAX ConvLSTM param tree -> the port's ``ConvLSTM`` on ``device``:
    weights in the compute dtype for serving, or f32 trainable parameters."""
    dtype = torch.float32 if trainable else compute_dtype

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    convs = {name: {"w": tensor(params[name]["w"]), "b": tensor(params[name]["b"])}
             for name in ("conv1", "conv2", "gates")}
    cell = ConvLSTM(convs, compute_dtype, use_cube_pad, conv_impl, trainable=trainable)
    return cell.train() if trainable else cell.eval()


def clstm_to_params(cell: ConvLSTM) -> dict:
    """The port's ``ConvLSTM`` -> a JAX ConvLSTM param tree of f32 numpy
    arrays (HWIO kernels), as ``init_clstm_params`` makes and
    :func:`save_npz` writes."""
    def array(t):
        return t.detach().float().cpu().numpy()

    return {name: {"w": array(getattr(cell, f"{name}_w")),
                   "b": array(getattr(cell, f"{name}_b"))}
            for name in ("conv1", "conv2", "gates")}
