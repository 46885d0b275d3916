"""Typed configuration with the reference's exact YAML schema.

The port's own copy of the JAX package's ``Config`` (same field names,
types and defaults, so one ``config.yaml`` configures both packages).  The
flat key set is the reference config.yaml:1-41 plus the extensions the JAX
package added.  Fields that only the JAX package reads (link and some
training and extraction settings) are kept so a shared file still
validates; the port's serving path reads ``cube_dim``, ``equi_h``/``equi_w``,
``input_size``/``hidden_size``, ``seq_len``, ``cube_pad``, ``compute_dtype``,
``host_cube_remap``, ``clstm_conv_impl``, ``upload_format``, ``mesh_data``
and the ``serve_*`` keys; its extraction also reads ``opt_flow``,
``flow_h``, ``flow_backend`` and ``flow_link_dtype``.  Its trainer (``train/loop.py``) reads the
training keys too: ``checkpoint_path``, ``epochs``, ``save_freq``,
``summary_freq``, ``lr`` and the ``lr_*`` schedule keys, ``grad_clip_norm``,
``batch_size``, ``flow_h``, the loss weights ``l_s``/``l_t``/
``l_m``, ``mm_th``, ``train_remat``, ``keep_checkpoints``,
``checkpoint_backend``, ``mesh_data``/``mesh_model`` (a grid of ranks) and
``pipeline_stages``/``pipeline_microbatches`` (``parallel/``).

Note on ``equi_h``/``equi_w``: the reference passes (equi_h, equi_w) as a
PIL (width, height) pair, so with the shipped values the actual frame is
960 rows x 1920 cols (static_model/dataset_feat_extractor.py:129-130).  We
keep the key names and that interpretation; use the ``frame_hw`` property
for the unambiguous (rows, cols).

``yaml`` is imported inside :func:`load_config` only: a config built in
Python needs no YAML parser.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import typing
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Config:
    # Paths (config.yaml:1-5)
    data_vid_path: str = "./dataset/360_Discovery"
    label_path: str = "./dataset/Wild360_GT"
    output_path: str = "./output"
    checkpoint_path: str = "./checkpoint"

    # General (config.yaml:7-12)
    test_mode: bool = True
    train_mode: bool = False
    cube_pad: bool = True
    use_gpu: bool = True
    opt_flow: bool = True

    # Projection (config.yaml:14-18)
    equi_h: int = 1920  # PIL width (columns) — see module docstring
    equi_w: int = 960  # PIL height (rows)
    cube_dim: int = 224
    flow_h: int = 480

    # ConvLSTM (config.yaml:20-22)
    hidden_size: int = 1000
    input_size: int = 1000

    # Training (config.yaml:24-29)
    epochs: int = 5
    save_freq: int = 1000
    summary_freq: int = 10
    lr: float = 1e-6

    # Dataloader (config.yaml:31-35)
    batch_size: int = 1
    seq_len: int = 5
    processes: int = 4

    # Losses (config.yaml:37-41)
    l_s: float = 0.7
    l_t: float = 1.0
    l_m: float = 0.01
    mm_th: float = 0.15

    # --- extensions of the JAX package (absent from the reference) -------
    compute_dtype: str = "bfloat16"  # conv compute precision on the device
    mesh_data: int = 1  # data-parallel width (replicas in one process, or ranks)
    mesh_model: int = 1  # tensor-parallel ranks of the ConvLSTM's convs (training)
    profile_dir: Optional[str] = None
    host_cube_remap: bool = True  # sample cube faces on the host (cv2, u8);
    #   false = the all-device stage-1 step (equi->cube kernel on the card)
    feat_dtype: str = "float16"
    extract_batch: int = 16
    train_remat: bool = False
    flow_backend: str = "horn_schunck"
    flow_link_dtype: str = "float16"
    checkpoint_backend: str = "npz"
    clstm_conv_impl: str = "xla"  # 'xla' | 'pallas'; in the port both name
    #   the one fused cube-pad conv (ops/cube_conv.py)
    keep_checkpoints: int = 0
    upload_format: str = "rgb8"  # 'rgb8' | 'yuv420' (with host_cube_remap)
    upload_depth: int = 4
    fetch_depth: int = 1
    transfer_codec: str = "none"
    pipeline_stages: int = 1
    pipeline_microbatches: int = 4
    serve_max_batch: int = 8  # serving: concurrent requests coalesced into
    #   one device step (serving/batcher.py); 1 disables grouping
    serve_batch_window_ms: float = 5.0  # serving: how long the device
    #   worker waits after a request arrives for others to join its batch
    serve_request_timeout_s: float = 0.0  # >0: a request waiting longer
    #   than this on the device worker fails with HTTP 504
    grad_clip_norm: float = 0.0
    lr_schedule: str = "constant"
    lr_warmup_steps: int = 0
    lr_total_steps: int = 0
    segment_windows: int = 1
    eval_every_epochs: int = 0
    eval_dir: Optional[str] = None
    eval_split: str = ""
    eval_batch_windows: int = 16
    eval_max_videos: int = 0
    eval_patience: int = 0

    @property
    def frame_hw(self):
        """Unambiguous (rows, cols) of the working equirectangular frame."""
        return (self.equi_w, self.equi_h)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def load_config(path: str = "config.yaml", **overrides) -> Config:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    known = {f.name for f in dataclasses.fields(Config)}
    unknown = set(raw) - known
    if unknown:
        raise ValueError(f"unknown config keys in {path}: {sorted(unknown)}")
    raw.update({k: v for k, v in overrides.items() if v is not None})
    return Config(**raw)


def add_config_overrides(parser: argparse.ArgumentParser) -> None:
    """The reference drivers' override flags (train_temporal.py:196-203),
    plus a general ``--set field=value`` escape hatch for any Config field."""
    parser.add_argument("--config", type=str, default=None, help="config.yaml path")
    parser.add_argument("--sml", type=float, default=None, help="smooth (flow-warp) loss weight")
    parser.add_argument("--tmpl", type=float, default=None, help="temporal loss weight")
    parser.add_argument("--mml", type=float, default=None, help="motion-mask loss weight")
    parser.add_argument("--lr", type=float, default=None, help="learning rate")
    parser.add_argument("--set", action="append", default=None, metavar="FIELD=VALUE",
                        help="override any config field (repeatable), e.g. "
                        "--set serve_max_batch=4 --set compute_dtype=float32")


def _coerce(field: dataclasses.Field, raw: str):
    """Parse a --set value using the Config field's declared type; bad
    values exit cleanly (SystemExit) like every other --set error."""
    tp = typing.get_type_hints(Config)[field.name]
    if typing.get_origin(tp) is typing.Union:
        non_none = [a for a in typing.get_args(tp) if a is not type(None)]
        tp = non_none[0] if len(non_none) == 1 else str
    try:
        if tp is bool:
            low = raw.lower()
            if low not in ("true", "false", "1", "0"):
                raise ValueError
            return low in ("true", "1")
        if tp is int:
            return int(raw)
        if tp is float:
            return float(raw)
    except ValueError:
        raise SystemExit(
            f"--set {field.name}: expected {tp.__name__}, got {raw!r}"
        ) from None
    if tp is not str:
        raise SystemExit(
            f"--set {field.name}: type {tp!r} has no CLI coercion; set it in the YAML"
        )
    return raw


def config_from_args(args: argparse.Namespace, default_path: str = "config.yaml") -> Config:
    # an explicitly named --config must exist; the implicit ./config.yaml
    # falls back to the (identical) dataclass defaults when absent
    if args.config is None and not os.path.exists(default_path):
        import sys

        print(f"config: no ./{default_path} here — using built-in defaults "
              "(pass --config to load a file)", file=sys.stderr)
        cfg = Config()
    else:
        cfg = load_config(args.config or default_path)
    mapping = {"sml": "l_s", "tmpl": "l_t", "mml": "l_m", "lr": "lr"}
    kw = {
        dst: getattr(args, src)
        for src, dst in mapping.items()
        if getattr(args, src, None) is not None
    }
    fields = {f.name: f for f in dataclasses.fields(Config)}
    for item in getattr(args, "set", None) or []:
        if "=" not in item:
            raise SystemExit(f"--set expects FIELD=VALUE, got {item!r}")
        key, raw = item.split("=", 1)
        if key not in fields:
            raise SystemExit(
                f"--set: unknown config field {key!r} (valid: {', '.join(sorted(fields))})"
            )
        kw[key] = _coerce(fields[key], raw)
    return cfg.replace(**kw) if kw else cfg
