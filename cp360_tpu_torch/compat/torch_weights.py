"""PyTorch ``.pth`` checkpoints <-> the JAX package's param trees and ``.npz``.

The ``.pth`` side of ``cp360_tpu/compat/torch_weights.py``: the reference
uses torchvision-zoo ResNet weights (model/resnet_cubic.py:228-237) and
ships a trained ConvLSTM ``.pth`` (temporal_model/test_temporal.py:147-150).

Layout mapping (compat/jax_params.py holds the converters themselves):
  torch conv OIHW  -> HWIO (transpose 2, 3, 1, 0)
  torch linear [out, in] -> {'w': [in, out], 'b': [out]}
  torch BatchNorm {weight, bias, running_mean, running_var}
     -> {'scale', 'bias', 'mean', 'var'}

The exporters are exact inverses of the converters, so
``convert(export(p)) == p`` leaf for leaf.  :func:`convert_pth` and
:func:`export_pth` are the file conversions ``cli/convert_weights.py``
runs.  :func:`load_params` is the one
backbone loader of every CLI: ``.npz`` or ``.pth`` weights of any family,
or without a file the seeded random init (demo only).

:func:`load_torch_state_dict` unpickles whole modules (``weights_only=False``),
as the JAX package's loader does: load only files you trust.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from cp360_tpu_torch.compat import jax_params as jp


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A ``.pth`` holding a state dict or a whole module -> numpy arrays by
    key (``cp360_tpu/compat/torch_weights.py:41-48``)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def merge_pretrained_tolerant(init_params, converted, log_fn=print):
    """Copy every leaf of ``converted`` whose shape matches its counterpart
    in ``init_params``; keep the init value, and log, otherwise
    (``cp360_tpu/compat/torch_weights.py:167-190``; the reference's loaders
    skip mismatched keys, model/resnet_cubic.py:183-201).  For loading e.g.
    1000-class zoo weights into a model with another head."""
    flat_init = jp.flatten_params(init_params)
    out = dict(flat_init)
    for key, val in jp.flatten_params(converted).items():
        if key not in flat_init:
            log_fn(f"skip unexpected key '{key}'")
        elif flat_init[key].shape != val.shape:
            log_fn(f"skip key '{key}' due to inconsistent size "
                   f"{val.shape} vs {flat_init[key].shape}")
        else:
            out[key] = val
    return jp.unflatten_params(out)


def convert_state_dict(sd: Mapping[str, np.ndarray], kind: str, arch: str = "resnet50"):
    """A torch state dict of family ``kind`` (resnet, clstm, vgg16,
    mobilenet_v2) -> its param tree.  vgg16's camconv/classifier head has
    no torchvision counterpart: it comes from the seeded init (seed 0)."""
    if kind == "resnet":
        return jp.convert_resnet_state_dict(sd, arch)
    if kind == "clstm":
        return jp.convert_clstm_state_dict(sd)
    if kind == "mobilenet_v2":
        return jp.convert_mobilenet_v2(sd)
    if kind == "vgg16":
        return jp.convert_vgg16_bn_features(sd, jp.init_vgg16_params(0))
    raise ValueError(f"unknown kind {kind!r}")


KINDS = ("resnet", "clstm", "vgg16", "mobilenet_v2")


def sniff_kind(keys) -> str:
    """Guess the family from torch state-dict key names.

    The reference ConvLSTM's six tensors are Conv1/Conv2/Gates
    .weight/.bias (model/clstm.py:28-34); torchvision ResNets live under
    layerN.* / fc.* and carry BN running statistics."""
    ks = list(keys)
    if any(k.startswith(("Conv1.", "Conv2.", "Gates.")) for k in ks):
        return "clstm"
    if any(k.startswith("features.") and ".conv." in k for k in ks):
        return "mobilenet_v2"  # torchvision's inverted-residual layout
    if any(k.startswith("features.") for k in ks) and any(
            k.startswith("classifier.") for k in ks):
        return "vgg16"  # torchvision's sequential-features layout
    if any(k.startswith(("layer", "fc.")) or "running_mean" in k for k in ks):
        return "resnet"
    # the reference's sequential fallback loader takes any 6-tensor dict as
    # a ConvLSTM (model/clstm.py:92-101)
    return "clstm" if len(ks) == 6 else "resnet"


def sniff_kind_npz(flat_keys) -> str:
    """Guess the family from an ``.npz``'s flat key paths."""
    ks = list(flat_keys)
    if any(k.startswith("gates/") for k in ks):
        return "clstm"
    if any(k.startswith("blocks/") for k in ks):
        return "mobilenet_v2"
    if any(k.startswith("camconv/") for k in ks):
        return "vgg16"
    return "resnet"


def _check_kind(kind: str) -> None:
    if kind != "auto" and kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r} (auto or one of {KINDS})")


def convert_pth(path_in: str, path_out: str, kind: str = "auto",
                arch: str = "resnet50") -> Tuple[str, int]:
    """Import: a ``.pth`` (state dict or whole module) of family ``kind``
    ("auto" sniffs it from the key names) -> an ``.npz`` param tree.
    Returns the kind and the number of arrays written.  Raises
    ``FileNotFoundError``, or ``ValueError`` for a file not of the kind."""
    _check_kind(kind)
    sd = load_torch_state_dict(path_in)
    if kind == "auto":
        kind = sniff_kind(sd)
    try:
        params = convert_state_dict(sd, kind, arch)
    except (KeyError, ValueError) as e:
        what = f"{kind} ({arch})" if kind == "resnet" else kind
        raise ValueError(f"{path_in} does not look like a {what} state dict: "
                         f"missing/invalid {e}") from e
    jp.save_npz(path_out, params)
    return kind, len(jp.flatten_params(params))


def load_params(weights: Optional[str], arch: str):
    """The backbone param tree of family ``arch`` (one of
    ``jax_params.BACKBONES``) from ``.npz`` or ``.pth`` weights, or, with no
    file, the seeded random init (demo only), as
    ``cp360_tpu/cli/extract_features.py:23-59``."""
    if weights:
        if weights.endswith(".pth"):
            kind = arch if arch in ("vgg16", "mobilenet_v2") else "resnet"
            return convert_state_dict(load_torch_state_dict(weights), kind, arch)
        return jp.load_npz(weights)
    print("WARNING: no --weights given; using random init (demo only)")
    return jp.init_backbone_params(0, arch)


def load_clstm(path: str):
    """A ConvLSTM param tree from ``.npz`` or the reference's ``.pth``."""
    if path.endswith(".pth"):
        return jp.convert_clstm_state_dict(load_torch_state_dict(path))
    return jp.load_npz(path)


# ---------------------------------------------------------------------------
# Export: param trees -> reference / torchvision state dicts.
# ---------------------------------------------------------------------------


def _torch_float(a) -> np.ndarray:
    """A leaf -> a dtype ``torch.from_numpy`` takes (f32 for other floats)."""
    a = np.asarray(a)
    if a.dtype.kind == "f" and a.dtype != np.float32:
        a = a.astype(np.float32)
    return np.ascontiguousarray(a)


def _oihw(w) -> np.ndarray:
    return _torch_float(np.asarray(w).transpose(3, 2, 0, 1))


def _bn_inv(bn: Mapping[str, np.ndarray], prefix: str) -> dict:
    return {
        f"{prefix}.weight": _torch_float(bn["scale"]),
        f"{prefix}.bias": _torch_float(bn["bias"]),
        f"{prefix}.running_mean": _torch_float(bn["mean"]),
        f"{prefix}.running_var": _torch_float(bn["var"]),
        # torchvision's BatchNorm2d carries it: a strict load_state_dict works
        f"{prefix}.num_batches_tracked": np.asarray(0, dtype=np.int64),
    }


def export_resnet_state_dict(params: Mapping, arch: str = "resnet50") -> Dict[str, np.ndarray]:
    """A ResNet param tree -> a torchvision-style state dict
    (``cp360_tpu/compat/torch_weights.py:216-260``)."""
    if arch not in jp.ARCHS:
        raise ValueError(f"unknown arch {arch!r} (one of {sorted(jp.ARCHS)})")
    kind, depths = jp.ARCHS[arch]
    sd = {"conv1.weight": _oihw(params["conv1"]["w"])}
    sd.update(_bn_inv(params["bn1"], "bn1"))
    n_convs = 3 if kind == "bottleneck" else 2
    for li, depth in enumerate(depths):
        stage = params[f"layer{li + 1}"]
        if len(stage) != depth:
            raise ValueError(f"layer{li + 1} has {len(stage)} blocks, {arch} expects {depth}")
        for bi, blk in enumerate(stage):
            pre = f"layer{li + 1}.{bi}"
            for ci in range(1, n_convs + 1):
                sd[f"{pre}.conv{ci}.weight"] = _oihw(blk[f"conv{ci}"]["w"])
                sd.update(_bn_inv(blk[f"bn{ci}"], f"{pre}.bn{ci}"))
            if "downsample" in blk:
                sd[f"{pre}.downsample.0.weight"] = _oihw(blk["downsample"]["conv"]["w"])
                sd.update(_bn_inv(blk["downsample"]["bn"], f"{pre}.downsample.1"))
    sd["fc.weight"] = _torch_float(np.asarray(params["fc"]["w"]).T)
    sd["fc.bias"] = _torch_float(params["fc"]["b"])
    return sd


def export_clstm_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """A ConvLSTM param tree -> the reference's Conv1/Conv2/Gates keys
    (model/clstm.py:28-34), which its temporal_model/test_temporal.py ``torch.load``s."""
    inv = {v: k for k, v in jp._CLSTM_NAME_MAP.items()}
    sd = {}
    for name in ("conv1", "conv2", "gates"):
        sd[f"{inv[name]}.weight"] = _oihw(params[name]["w"])
        sd[f"{inv[name]}.bias"] = _torch_float(params[name]["b"])
    return sd


def save_pth(path: str, sd: Mapping[str, np.ndarray]) -> None:
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)


def export_pth(path_in: str, path_out: str, kind: str = "auto",
               arch: str = "resnet50") -> Tuple[str, int]:
    """Export: an ``.npz`` param tree of kind resnet or clstm ("auto" sniffs
    it from the key paths) -> a reference-compatible ``.pth``.  Returns the
    kind and the number of tensors written.  Raises ``FileNotFoundError``,
    or ``ValueError`` for vgg16 and mobilenet_v2 (the reference has no
    consumer for them) and for a tree not of the kind."""
    _check_kind(kind)
    params = jp.load_npz(path_in)
    if kind == "auto":
        kind = sniff_kind_npz(jp.flatten_params(params))
    if kind in ("vgg16", "mobilenet_v2"):
        raise ValueError(f"export to .pth is not supported for {kind} (the reference repo "
                         f"has no consumer for it; resnet and clstm export are)")
    try:
        sd = (export_resnet_state_dict(params, arch) if kind == "resnet"
              else export_clstm_state_dict(params))
    except (KeyError, ValueError, TypeError) as e:
        raise ValueError(f"{path_in} does not look like a {kind} params tree: {e}") from e
    save_pth(path_out, sd)
    return kind, len(sd)
