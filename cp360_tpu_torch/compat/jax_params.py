"""Carries the JAX package's parameters across into the port's modules.

A JAX param tree is a nested dict (lists for ResNet stages, VGG features and
MobileNet blocks) of arrays in the JAX layouts: conv kernels HWIO, a
classifier as {'w': [C, K], 'b': [K]}, batch norms as {'scale', 'bias',
'mean', 'var'} (see ``cp360_tpu/models/resnet.py::init_resnet_params``,
``vgg.py::init_vgg16_params``, ``mobilenet.py::init_mobilenet_v2_params``
and ``clstm.py::init_clstm_params``).  Here it is read as numpy arrays
(``np.asarray`` on each leaf) and turned into the port's modules:

- :func:`backbone_from_params` -> the stage-1 backbone of any family
  (:func:`resnet_from_params`, :func:`vgg16_from_params`,
  :func:`mobilenet_v2_from_params`): conv kernels go HWIO -> OIHW in
  channels_last storage (cuDNN's layout) and the compute dtype; batch norms
  and the classifier stay f32;
- :func:`clstm_from_params` -> ``models.clstm.ConvLSTM``: HWIO kernels (the
  layout the fused cube conv reads) and biases in the compute dtype, or as
  f32 trainable parameters; :func:`clstm_to_params` turns one back into a
  numpy tree.

It also reads and writes the JAX package's flat ``.npz`` checkpoints (own
copies of ``flatten_params`` / ``unflatten_params`` / ``save_npz`` /
``load_npz``, ``cp360_tpu/compat/torch_weights.py:121-165``), converts the
reference's and torchvision's state dicts (:func:`convert_resnet_state_dict`
for every ResNet depth, :func:`convert_vgg16_bn_features`,
:func:`convert_mobilenet_v2`, :func:`convert_clstm_state_dict`; the
``.pth`` files themselves are read by compat/torch_weights.py) and makes
seeded random parameters for smoke runs: numpy ``RandomState``, He-normal
fan-out as ``cp360_tpu/models/layers.py:112`` (reference
model/resnet_cubic.py:137-143, model/clstm.py:84-90).  The numbers differ
from ``jax.random``'s for the same seed; the tests hand one numpy tree to
both packages.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict, Mapping

import numpy as np
import torch

from cp360_tpu_torch.compat.convnext_params import convnext_from_params, init_convnext_params
from cp360_tpu_torch.models import convnext
from cp360_tpu_torch.models.clstm import ConvLSTM
from cp360_tpu_torch.models.mobilenet import LAST, V2_CFG, MobileNetV2
from cp360_tpu_torch.models.resnet import ARCHS, EXPANSION, ResNet
from cp360_tpu_torch.models.vgg import VGG16, VGG16_CFG

BACKBONES = tuple(ARCHS) + ("vgg16", "mobilenet_v2")

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
    [K, C]) -> the JAX package's ResNet param tree (HWIO, ``fc`` [C, K]);
    Bottlenecks carry conv1..conv3, BasicBlocks conv1 and conv2."""
    kind, depths = _arch(arch)
    params = {"conv1": {"w": _hwio(sd["conv1.weight"])}, "bn1": _bn_sd(sd, "bn1")}
    n_convs = 3 if kind == "bottleneck" else 2
    for li, depth in enumerate(depths):
        stage = []
        for bi in range(depth):
            pre = f"layer{li + 1}.{bi}"
            blk = {}
            for ci in range(1, n_convs + 1):
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


def convert_vgg16_bn_features(sd: Mapping[str, np.ndarray], params: dict) -> dict:
    """torchvision ``vgg16_bn`` feature weights merged into a VGG16 param
    tree (``cp360_tpu/models/vgg.py:124-149``).  torchvision's sequential
    layout alternates ``features.{i}`` Conv2d, BatchNorm2d and ReLU, with a
    MaxPool at each 'M'; the camconv/classifier head has no torchvision
    counterpart and is kept from ``params``."""
    out = {**params, "features": [dict(f) for f in params["features"]]}
    seq_i = conv_i = 0
    for v in VGG16_CFG:
        if v == "M":
            seq_i += 1
            continue
        out["features"][conv_i] = {"w": _hwio(sd[f"features.{seq_i}.weight"]),
                                   "b": np.asarray(sd[f"features.{seq_i}.bias"]),
                                   "bn": _bn_sd(sd, f"features.{seq_i + 1}")}
        conv_i += 1
        seq_i += 3  # Conv2d, BatchNorm2d, ReLU
    return out


def convert_mobilenet_v2(sd: Mapping[str, np.ndarray]) -> dict:
    """torchvision ``mobilenet_v2`` state dict -> the MobileNetV2 param tree
    (``cp360_tpu/models/mobilenet.py:167-203``).  ``features.0`` is the
    stem, ``features.1..17`` the inverted residuals (``conv.{0.0, 0.1, 1,
    2}`` at expansion 1, ``conv.{0.0, 0.1, 1.0, 1.1, 2, 3}`` above it),
    ``features.18`` the head and ``classifier.1`` the linear; a depthwise
    [C, 1, 3, 3] kernel lands as HWIO [3, 3, 1, C]."""
    blocks = []
    fi = 1
    for t, _, n, _ in V2_CFG:
        for _ in range(n):
            pre = f"features.{fi}.conv"
            blk = {}
            if t != 1:
                blk["expand"] = {"w": _hwio(sd[f"{pre}.0.0.weight"]),
                                 "bn": _bn_sd(sd, f"{pre}.0.1")}
                dw, dw_bn, pw, pw_bn = f"{pre}.1.0", f"{pre}.1.1", f"{pre}.2", f"{pre}.3"
            else:
                dw, dw_bn, pw, pw_bn = f"{pre}.0.0", f"{pre}.0.1", f"{pre}.1", f"{pre}.2"
            blk["dw"] = {"w": _hwio(sd[f"{dw}.weight"]), "bn": _bn_sd(sd, dw_bn)}
            blk["project"] = {"w": _hwio(sd[f"{pw}.weight"]), "bn": _bn_sd(sd, pw_bn)}
            blocks.append(blk)
            fi += 1
    return {"stem": {"w": _hwio(sd["features.0.0.weight"]), "bn": _bn_sd(sd, "features.0.1")},
            "blocks": blocks,
            "head": {"w": _hwio(sd["features.18.0.weight"]), "bn": _bn_sd(sd, "features.18.1")},
            "fc": {"w": np.ascontiguousarray(np.asarray(sd["classifier.1.weight"]).T),
                   "b": np.asarray(sd["classifier.1.bias"])}}


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


def _arch(arch: str):
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r} (one of {sorted(ARCHS)})")
    return ARCHS[arch]


def _classifier(rs: np.random.RandomState, c: int, num_classes: int) -> dict:
    return {"w": (rs.standard_normal((c, num_classes)) * 0.01).astype(np.float32),
            "b": np.zeros(num_classes, np.float32)}


def init_resnet_params(seed: int, arch: str = "resnet50", num_classes: int = 1000) -> dict:
    """A He-initialized ResNet param tree in the JAX package's structure."""
    kind, depths = _arch(arch)
    exp = EXPANSION[kind]
    rs = np.random.RandomState(seed)
    params = {"conv1": {"w": he_conv(rs, 7, 7, 3, 64)}, "bn1": bn_params(64)}
    inplanes = 64
    for li, depth in enumerate(depths):
        planes = 64 * 2 ** li
        stage = []
        for bi in range(depth):
            stride = 2 if (li > 0 and bi == 0) else 1
            if kind == "bottleneck":
                shapes = ((1, inplanes, planes), (3, planes, planes), (1, planes, planes * exp))
            else:
                shapes = ((3, inplanes, planes), (3, planes, planes))
            blk = {}
            for ci, (k, cin, cout) in enumerate(shapes, 1):
                blk[f"conv{ci}"] = {"w": he_conv(rs, k, k, cin, cout)}
                blk[f"bn{ci}"] = bn_params(cout)
            if stride != 1 or inplanes != planes * exp:
                blk["downsample"] = {
                    "conv": {"w": he_conv(rs, 1, 1, inplanes, planes * exp)},
                    "bn": bn_params(planes * exp),
                }
            stage.append(blk)
            inplanes = planes * exp
        params[f"layer{li + 1}"] = stage
    params["fc"] = _classifier(rs, 512 * exp, num_classes)
    return params


def init_vgg16_params(seed: int, num_classes: int = 1000, cam_channels: int = 1024) -> dict:
    """A He-initialized VGG16-BN + CAM head param tree
    (``cp360_tpu/models/vgg.py::init_vgg16_params``); zero biases."""
    rs = np.random.RandomState(seed)
    features, cin = [], 3
    for v in VGG16_CFG:
        if v != "M":
            features.append({"w": he_conv(rs, 3, 3, cin, v), "b": np.zeros(v, np.float32),
                             "bn": bn_params(v)})
            cin = v
    return {"features": features,
            "camconv": {"w": he_conv(rs, 3, 3, cin, cam_channels),
                        "b": np.zeros(cam_channels, np.float32)},
            "classifier": _classifier(rs, cam_channels, num_classes)}


def init_mobilenet_v2_params(seed: int, num_classes: int = 1000) -> dict:
    """A He-initialized MobileNetV2 param tree
    (``cp360_tpu/models/mobilenet.py::init_mobilenet_v2_params``).  A
    depthwise kernel's fan-out is 3*3*cout/groups = 9, so its std is
    sqrt(2/9) (torch's kaiming_normal with groups)."""
    rs = np.random.RandomState(seed)

    def cbr(cin, cout, k):
        return {"w": he_conv(rs, k, k, cin, cout), "bn": bn_params(cout)}

    stem = cbr(3, 32, 3)
    blocks, cin = [], 32
    for t, c, n, _ in V2_CFG:
        for _ in range(n):
            hidden = cin * t
            blk = {"expand": cbr(cin, hidden, 1)} if t != 1 else {}
            blk["dw"] = {"w": (rs.standard_normal((3, 3, 1, hidden))
                               * math.sqrt(2.0 / 9.0)).astype(np.float32),
                         "bn": bn_params(hidden)}
            blk["project"] = cbr(hidden, c, 1)
            blocks.append(blk)
            cin = c
    return {"stem": stem, "blocks": blocks, "head": cbr(cin, LAST, 1),
            "fc": _classifier(rs, LAST, num_classes)}


def init_backbone_params(seed: int, arch: str, num_classes: int = 1000) -> dict:
    """The seeded param tree of any backbone family in :data:`BACKBONES`,
    or of the port's own ConvNeXt (``compat/convnext_params.py``)."""
    if arch in convnext.ARCHS:
        return init_convnext_params(seed, arch, num_classes)
    if arch == "vgg16":
        return init_vgg16_params(seed, num_classes)
    if arch == "mobilenet_v2":
        return init_mobilenet_v2_params(seed, num_classes)
    return init_resnet_params(seed, arch, num_classes)


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
                       compute_dtype: torch.dtype = torch.bfloat16, device="cpu",
                       cube_conv_form=None) -> ResNet:
    """A JAX ResNet param tree -> the port's ``ResNet`` on ``device``
    (``cube_conv_form`` None: ``CP360_CUBE_CONV_FORM`` where set, else
    ``pad`` under f32, ``halo`` under bf16)."""
    stem = {"conv1": _oihw(params["conv1"]["w"], compute_dtype, device),
            "bn1": _bn(params["bn1"], device)}
    stages = []
    for li in range(4):
        stage = []
        for blk in params[f"layer{li + 1}"]:
            names = [k for k in blk if k.startswith("conv")]
            convs = {k: _oihw(blk[k]["w"], compute_dtype, device) for k in names}
            bns = {f"bn{k[4:]}": _bn(blk[f"bn{k[4:]}"], device) for k in names}
            if "downsample" in blk:
                convs["downsample"] = _oihw(blk["downsample"]["conv"]["w"], compute_dtype, device)
                bns["downsample"] = _bn(blk["downsample"]["bn"], device)
            stage.append({"convs": convs, "bns": bns})
        stages.append(stage)
    fc = {"w": _f32(params["fc"]["w"], device), "b": _f32(params["fc"]["b"], device)}
    return ResNet(stem, stages, fc, arch, use_cube_pad, compute_dtype, cube_conv_form).eval()


def _conv_bn(p: dict, compute_dtype, device) -> dict:
    return {"w": _oihw(p["w"], compute_dtype, device), "bn": _bn(p["bn"], device)}


def vgg16_from_params(params: dict, use_cube_pad: bool = True,
                      compute_dtype: torch.dtype = torch.bfloat16, device="cpu") -> VGG16:
    """A JAX VGG16 param tree -> the port's ``VGG16`` on ``device`` (conv
    kernels and biases in the compute dtype; BN and classifier f32)."""
    def bias(b):
        return torch.from_numpy(np.asarray(b, np.float32).copy()).to(device, compute_dtype)

    features = [{**_conv_bn(f, compute_dtype, device), "b": bias(f["b"])}
                for f in params["features"]]
    camconv = {"w": _oihw(params["camconv"]["w"], compute_dtype, device),
               "b": bias(params["camconv"]["b"])}
    cls = {"w": _f32(params["classifier"]["w"], device),
           "b": _f32(params["classifier"]["b"], device)}
    return VGG16(features, camconv, cls, use_cube_pad, compute_dtype).eval()


def mobilenet_v2_from_params(params: dict, use_cube_pad: bool = True,
                             compute_dtype: torch.dtype = torch.bfloat16,
                             device="cpu") -> MobileNetV2:
    """A JAX MobileNetV2 param tree -> the port's ``MobileNetV2`` on
    ``device`` (conv kernels in the compute dtype; BN and fc f32)."""
    blocks = [{k: _conv_bn(v, compute_dtype, device) for k, v in blk.items()}
              for blk in params["blocks"]]
    fc = {"w": _f32(params["fc"]["w"], device), "b": _f32(params["fc"]["b"], device)}
    return MobileNetV2(_conv_bn(params["stem"], compute_dtype, device), blocks,
                       _conv_bn(params["head"], compute_dtype, device), fc, use_cube_pad,
                       compute_dtype).eval()


def backbone_from_params(params: dict, arch: str = "resnet50", use_cube_pad: bool = True,
                         compute_dtype: torch.dtype = torch.bfloat16, device="cpu",
                         cube_conv_form=None):
    """A param tree -> the stage-1 backbone of family ``arch`` (one of
    :data:`BACKBONES`, or a ConvNeXt of ``models.convnext.ARCHS``, the
    port's own family) on ``device``: the one constructor every entry point
    uses.  ``cube_conv_form`` is the ResNets' option."""
    if arch in convnext.ARCHS:
        return convnext_from_params(params, use_cube_pad, compute_dtype, device)
    if arch == "vgg16":
        return vgg16_from_params(params, use_cube_pad, compute_dtype, device)
    if arch == "mobilenet_v2":
        return mobilenet_v2_from_params(params, use_cube_pad, compute_dtype, device)
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r} (one of {BACKBONES})")
    return resnet_from_params(params, arch, use_cube_pad, compute_dtype, device,
                              cube_conv_form)


def clstm_from_params(params: dict, compute_dtype: torch.dtype = torch.bfloat16,
                      use_cube_pad: bool = True, conv_impl: str = "xla",
                      device="cpu", trainable: bool = False) -> ConvLSTM:
    """A JAX ConvLSTM param tree -> the port's ``ConvLSTM`` on ``device``:
    weights in the compute dtype for serving, or f32 trainable parameters.
    Trainable parameters are copies: training never writes into the
    caller's arrays (on the CPU an f32 ``.to`` would share their memory)."""
    dtype = torch.float32 if trainable else compute_dtype

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype, copy=trainable)

    convs = {name: {"w": tensor(params[name]["w"]), "b": tensor(params[name]["b"])}
             for name in ("conv1", "conv2", "gates")}
    cell = ConvLSTM(convs, compute_dtype, use_cube_pad, conv_impl, trainable=trainable)
    return cell.train() if trainable else cell.eval()


def clstm_to_params(cell: ConvLSTM) -> dict:
    """The port's ``ConvLSTM`` -> a JAX ConvLSTM param tree of f32 numpy
    arrays (HWIO kernels), as ``init_clstm_params`` makes and
    :func:`save_npz` writes.  The arrays are copies, so later steps do not
    change a tree taken before them."""
    def array(t):
        return t.detach().to("cpu", torch.float32, copy=True).numpy()

    return {name: {"w": array(getattr(cell, f"{name}_w")),
                   "b": array(getattr(cell, f"{name}_b"))}
            for name in ("conv1", "conv2", "gates")}
