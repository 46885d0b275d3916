"""Stage-1 extraction: video -> per-frame CAM cubes (+ overlay images).

The device steps are the counterparts of
``cp360_tpu/pipelines/extract.py::stage1_batch`` (:288, the all-device step
from u8 equirectangular frames) and ``stage1_batch_faces`` (:40, from faces
sampled on the host, with the optional int8 transfer codec);
:func:`stage1_step` is ``stage1_step`` (:324), one frame.  Everything
between the decoded frame and the saliency map runs on the device:
equi->cube (the hand kernel of ops/equi_gather.py, with the /255 fused),
ImageNet normalization, the CAM of any cube-padded backbone
(``models.cam.Backbone``: a ResNet, whose stem pool is the hand kernel of
ops/cube_pool.py, VGG16-BN or MobileNetV2), cube->equi and the squared
channel max (dataset_feat_extractor.py:173-176).

:func:`extract_frames` is the batch loop of ``extract_video`` (:388) over
any iterable of decoded BGR frames; :func:`extract_video` feeds it from
``cv2.VideoCapture``.  Artifacts keep the reference's layout
(dataset_feat_extractor.py:102-137,181-193): ``<out>/cube_feat/NNNNNN.npy``
[6, 1000, 7, 7] in ``feat_dtype``, ``<out>/img/NNNNNN.jpg`` and the overlay
``<out>/NNNNNN.jpg``; numbering starts at 000002 and artifact k holds video
frame k-2.  With ``-om`` and ``opt_flow: true``, ``<out>/motion/NNNNNN.npy``
holds the flow [flow_h, 2 flow_h, 2] f32 from frame k-2 to frame k-1, from
the decoded frames (``flow/``): a device backend (``horn_schunck``,
``variational``) solves each batch's pairs in one call on the model's
device, a host backend (``farneback``, ``deepflow``) runs per pair on a
thread pool.

``upload_format: yuv420`` (with ``host_cube_remap: true``) ships the faces
as 4:2:0 planes, half the bytes, and :func:`stage1_batch_faces_yuv`
rebuilds RGB on the device (``cp360_tpu/pipelines/extract.py:135-283``).

This module owns stage 1's upload for every caller (the stream, the
extraction, serving and the bench loops): :func:`check_upload_format`
refuses an unknown ``upload_format``, :func:`stage_batch` pads a batch and
packs it into host tensors, and :func:`stage1_uploaded` runs the step that
those tensors' form takes.

cv2 and PIL are imported only where they are used: the video decoder, the
host remap of ``host_cube_remap: true`` (:func:`host_equi_to_cube_u8`), a
frame resize, the images of ``output_img`` and the host flow backends.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache, partial
from typing import Iterable, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cp360_tpu_torch.config import Config
from cp360_tpu_torch.flow import optical_flow
from cp360_tpu_torch.geometry import build_equi2cube_maps
from cp360_tpu_torch.imaging.overlay import IMAGENET_MEAN, IMAGENET_STD
from cp360_tpu_torch.models.cam import Backbone, cam_forward
from cp360_tpu_torch.ops import equi_gather
from cp360_tpu_torch.ops.quantize import dequantize_cam_np, quantize_cam
from cp360_tpu_torch.ops.resample import cube_to_equi
from cp360_tpu_torch.parallel.mesh import LocalReplicas, check_divisible
from cp360_tpu_torch.utils.atomic import atomic_save
from cp360_tpu_torch.utils.profiling import annotate, count


def _cam_and_saliency(model: Backbone, cubes01: torch.Tensor):
    """(f32 score cube [N, 6, h, w, K], saliency [N, 2h, 4w]).

    The one stage-1 step of the stream, extraction and serving.  On the
    card the backbone and its CAM replay the model's CUDA graph for the
    batch's shape (``models/cam.py::cam_forward``).  While a profiler runs
    it counts its frames (``stage1.frames``; those a replay served also in
    ``stage1.graph_frames``) and times the backbone and its CAM on the
    device (the span ``stage1.backbone``, its device time in the counter
    ``stage1.backbone.device_ms``)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=cubes01.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=cubes01.device)
    cubes = (cubes01 - mean) / std
    count("stage1.frames", cubes01.shape[0])
    with annotate("stage1.backbone", device=cubes01.device):
        scores, _ = cam_forward(model, cubes)
    equi_scores = cube_to_equi(scores)  # [N, 2h, 4w, K]
    sal = torch.amax(equi_scores, dim=-1) ** 2
    return scores, sal


def stage1_batch(model: Backbone, frames_u8: torch.Tensor, cube_dim: int = 224,
                 *, out_dtype: torch.dtype = torch.float32):
    """Device step for a batch of frames: u8 equi -> (CAM, saliency).

    Args:
      frames_u8: [N, H, 2H, 3] uint8 frames (the decoded, resized image; /255
        happens on the device, in f32, before sampling).

    Returns:
      scores: [N, 6, h, w, K] CAM score cubes in ``out_dtype`` (NHWC).
      sal:    [N, 2h, 4w] f32 equi saliency (channel max of the projected
              scores, squared).
    """
    cubes01 = equi_gather.equi_to_cube(frames_u8, cube_dim)  # [N, 6, cd, cd, 3]
    scores, sal = _cam_and_saliency(model, cubes01)
    return scores.to(out_dtype), sal


def stage1_step(model: Backbone, equi01: torch.Tensor, cube_dim: int = 224,
                *, out_dtype: torch.dtype = torch.float32):
    """Single-frame wrapper over :func:`stage1_batch`, on the model's device.

    Args:
      equi01: [H, 2H, 3] float RGB in [0, 1], or uint8.  A float frame
        becomes u8 as ``clamp(0, 1) * 255 + 0.5`` in f32, truncated.

    Returns (scores [6, h, w, K], sal [2h, 4w]).  The JAX function's
    ``arch``, ``use_cube_pad`` and ``compute_dtype`` are properties of the
    port's ``model`` (``compat/jax_params.py::backbone_from_params``).
    """
    frame = equi01.to(_model_device(model))
    if frame.dtype != torch.uint8:
        frame = (frame.float().clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    scores, sal = stage1_batch(model, frame[None], cube_dim, out_dtype=out_dtype)
    return scores[0], sal[0]


def stage1_batch_faces(model: Backbone, faces_u8: torch.Tensor,
                       *, out_dtype: torch.dtype = torch.float16, codec: str = "none"):
    """Device step from cube faces sampled on the host.

    Args:
      faces_u8: [N, 6, cd, cd, 3] uint8 cube faces (:func:`host_equi_to_cube_u8`).
      codec: "int8" quantizes the score cube on the device
        (ops/quantize.py, f16 scales), so about half the bytes cross back;
        the caller dequantizes before writing the float artifact.

    Returns (scores [N, 6, h, w, K] ``out_dtype``, sal [N, 2h, 4w] f32), or
    with ``codec="int8"`` (q int8 [N, 6, h, w, K], scales f16
    [N, 6, 1, 1, K], sal).
    """
    return _faces_outputs(*_cam_and_saliency(model, faces_u8.float() / 255.0), out_dtype, codec)


def _faces_outputs(scores, sal, out_dtype: torch.dtype, codec: str):
    if codec == "int8":
        q, scales = quantize_cam(scores, scale_dtype=torch.float16)
        return q, scales, sal
    return scores.to(out_dtype), sal


# ---- 4:2:0 chroma-subsampled upload (half the bytes of rgb8) -----------------
#
# Full-range BT.601 YUV with 2x2-subsampled chroma carries the faces in half
# the bytes: Y [6, cd, cd] u8 + UV [6, cd/2, cd/2, 2] u8.  The device rebuilds
# RGB (bilinear chroma upsample); the error is u8 rounding plus the chroma
# edges' loss.

_YUV_M = np.array(
    [[0.299, 0.587, 0.114],        # Y
     [-0.168736, -0.331264, 0.5],  # U (Cb)
     [0.5, -0.418688, -0.081312]], # V (Cr)
    np.float32,
)


def host_rgb_to_yuv420(faces_u8: np.ndarray):
    """[..., h, w, 3] u8 RGB -> (Y [..., h, w] u8, UV [..., h/2, w/2, 2] u8).

    Full-range BT.601; chroma is 2x2 box-averaged before quantization."""
    f = faces_u8.astype(np.float32)
    y = f @ _YUV_M[0]
    u = f @ _YUV_M[1] + 128.0
    v = f @ _YUV_M[2] + 128.0
    uv = np.stack([u, v], axis=-1)
    sh = uv.shape
    h, w = sh[-3], sh[-2]
    uv = uv.reshape(*sh[:-3], h // 2, 2, w // 2, 2, 2).mean(axis=(-4, -2))
    return (np.clip(y + 0.5, 0, 255).astype(np.uint8),
            np.clip(uv + 0.5, 0, 255).astype(np.uint8))


def host_faces_for_upload(frame_u8: np.ndarray, cube_dim: int, yuv: bool):
    """Cube-sample a frame on the host and package it for the upload: the
    faces [6, cd, cd, 3] u8, or with ``yuv`` their (Y, UV) planes.  The one
    definition of this preprocessing, shared by extraction and serving."""
    faces = host_equi_to_cube_u8(frame_u8, cube_dim)
    return host_rgb_to_yuv420(faces) if yuv else faces


def _up2_axis_slice(x: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    """2x bilinear upsample along ``axis`` from shifted slices.

    The taps are static: out[2j] = 0.25 in[j-1] + 0.75 in[j] (j >= 1,
    out[0] = in[0]), out[2j+1] = 0.75 in[j] + 0.25 in[j+1] (j < n-1,
    out[2n-1] = in[n-1]), the coefficients and operand order of the JAX
    package's gather form (``_up2_axis_take``), which the slice form
    equals bit for bit."""
    n = x.shape[axis]
    if n_out != 2 * n:
        raise ValueError(f"the chroma upsample doubles an axis: {n} -> {n_out}")
    lo, hi = x.narrow(axis, 0, n - 1), x.narrow(axis, 1, n - 1)
    even = torch.cat([x.narrow(axis, 0, 1), 0.25 * lo + 0.75 * hi], dim=axis)
    odd = torch.cat([0.75 * lo + 0.25 * hi, x.narrow(axis, n - 1, 1)], dim=axis)
    inter = torch.stack([even, odd], dim=axis + 1)
    return inter.reshape(*x.shape[:axis], n_out, *x.shape[axis + 1:])


def _device_yuv420_to_rgb01(y_u8: torch.Tensor, uv_u8: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`host_rgb_to_yuv420` on the device -> f32 RGB in
    [0, 1]: chroma upsampled bilinearly on the 2x2 box grid (edges
    clamped), then the BT.601 inverse in the JAX package's order."""
    y = y_u8.float()
    uv = uv_u8.float() - 128.0
    *lead, h2, w2, _ = uv.shape
    uv_flat = uv.reshape(-1, h2, w2, 2)
    up = _up2_axis_slice(_up2_axis_slice(uv_flat, 1, h2 * 2), 2, w2 * 2)
    up = up.reshape(*lead, h2 * 2, w2 * 2, 2)
    u, v = up[..., 0], up[..., 1]
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(rgb, 0.0, 255.0) / 255.0


def stage1_batch_faces_yuv(model: Backbone, y_u8: torch.Tensor, uv_u8: torch.Tensor,
                           *, out_dtype: torch.dtype = torch.float16, codec: str = "none"):
    """:func:`stage1_batch_faces` fed by 4:2:0 planes
    (``cp360_tpu/pipelines/extract.py:249``).

    Args:
      y_u8: [N, 6, cd, cd] u8 luma.
      uv_u8: [N, 6, cd/2, cd/2, 2] u8 chroma (Cb, Cr offset by 128).
    """
    cubes01 = _device_yuv420_to_rgb01(y_u8, uv_u8)
    return _faces_outputs(*_cam_and_saliency(model, cubes01), out_dtype, codec)


@lru_cache(maxsize=8)
def _equi2cube_maps_f32(cube_dim: int, h: int, w: int):
    in_x, in_y = build_equi2cube_maps(cube_dim, h, w)
    return (np.ascontiguousarray(in_x.astype(np.float32)),
            np.ascontiguousarray(in_y.astype(np.float32)))


def host_equi_to_cube_u8(frame_u8: np.ndarray, cube_dim: int) -> np.ndarray:
    """Host-side equi->cube of one [H, 2H, 3] u8 frame via cv2.remap (the
    same sampling maps as the device path; u8 output).  One call samples
    the six faces as one [6 cd, cd] map: each output pixel depends on its
    own map entry alone, so the faces are those of six calls, bit for bit,
    and a remap thread takes the GIL back once a frame, not six times."""
    import cv2

    h, w = frame_u8.shape[:2]
    in_x, in_y = _equi2cube_maps_f32(cube_dim, h, w)
    rows = 6 * cube_dim
    faces = cv2.remap(frame_u8, in_x.reshape(rows, cube_dim), in_y.reshape(rows, cube_dim),
                      cv2.INTER_LINEAR)
    return faces.reshape(6, cube_dim, cube_dim, 3)


# ---- stage 1's upload: the format, the host packing, the step ---------------


def check_upload_format(cfg: Config) -> None:
    """Refuse an ``upload_format`` stage 1 does not know."""
    if cfg.upload_format not in ("rgb8", "yuv420"):
        raise ValueError(f"upload_format={cfg.upload_format!r} is not one of 'rgb8', 'yuv420'")


def stage_batch(items: Sequence, batch: int, pin: bool) -> Tuple[torch.Tensor, ...]:
    """Pack one stage-1 batch into host tensors, one per part of the upload.

    An item is one frame's upload: a u8 array (the equirectangular frame,
    or the faces :func:`host_faces_for_upload` samples), or a tuple of u8
    planes (yuv420's (Y, UV), or serving's prepped parts).  The batch is
    padded to ``batch`` with its last item, so every batch has one shape,
    and each part is stacked straight into host memory, pinned when
    ``pin``, one host copy per item.  A ``non_blocking`` copy reads the
    tensors after this returns: the caller keeps them until it has run."""
    items = list(items) + [items[-1]] * (batch - len(items))
    parts = list(zip(*items)) if isinstance(items[0], tuple) else [items]
    hosts = []
    for part in parts:
        host = torch.empty((batch, *part[0].shape), dtype=torch.uint8, pin_memory=pin)
        np.stack(part, out=host.numpy())
        hosts.append(host)
    return tuple(hosts)


def stage1_uploaded(model: Backbone, *xs: torch.Tensor, out_dtype: torch.dtype,
                    codec: str = "none", cube_dim: int = 224):
    """The stage-1 step for an upload as :func:`stage_batch` packs it (on
    the device), chosen from its parts: two, the (Y, UV) planes, run
    :func:`stage1_batch_faces_yuv`; one [N, 6, cd, cd, 3] faces
    :func:`stage1_batch_faces`; one [N, H, 2H, 3] frame :func:`stage1_batch`,
    which samples the faces at ``cube_dim`` and has no transfer codec."""
    if len(xs) == 2:
        return stage1_batch_faces_yuv(model, *xs, out_dtype=out_dtype, codec=codec)
    (x,) = xs
    if x.dim() == 5:
        return stage1_batch_faces(model, x, out_dtype=out_dtype, codec=codec)
    if codec != "none":
        raise ValueError(f"codec={codec!r}: the equirectangular upload has no transfer codec")
    return stage1_batch(model, x, cube_dim, out_dtype=out_dtype)


# ---- the extraction loop ------------------------------------------------------


def check_extract_config(cfg: Config, output_motion: bool) -> None:
    """Refuse values the extraction does not know."""
    check_upload_format(cfg)
    if cfg.transfer_codec not in ("none", "int8"):
        # 'auto' resolves through the JAX package's TPU link probe, which
        # the port does not carry
        raise ValueError(f"transfer_codec={cfg.transfer_codec!r} is not one of "
                         "'none', 'int8'")
    if output_motion and cfg.opt_flow:
        backends = optical_flow.DEVICE_BACKENDS + optical_flow.HOST_BACKENDS
        if cfg.flow_backend not in backends:
            raise ValueError(f"unknown flow backend {cfg.flow_backend!r} (one of {backends})")
        if cfg.flow_link_dtype not in optical_flow.LINK_DTYPES:
            raise ValueError(f"flow_link_dtype={cfg.flow_link_dtype!r} must be 'float16' "
                             "or 'float32'")


def _artifacts_exist(cnt, feat_dir, motion_dir, img_dir, out_dir,
                     need_feat, need_motion, need_img) -> bool:
    if need_feat and not os.path.exists(os.path.join(feat_dir, f"{cnt:06}.npy")):
        return False
    if need_motion and not os.path.exists(os.path.join(motion_dir, f"{cnt:06}.npy")):
        return False
    if need_img and not (os.path.exists(os.path.join(img_dir, f"{cnt:06}.jpg"))
                         and os.path.exists(os.path.join(out_dir, f"{cnt:06}.jpg"))):
        return False
    return need_feat or need_motion or need_img


def _atomic_pil_save(img, path: str) -> None:
    """PIL save that lands atomically (utils/atomic.py's contract: the temp
    name carries no image extension, so the format is passed explicitly)."""
    tmp = path + ".tmp"
    fmt = {"jpg": "JPEG", "jpeg": "JPEG", "png": "PNG"}[path.rsplit(".", 1)[1].lower()]
    img.save(tmp, format=fmt)
    os.replace(tmp, path)


def _resize_frame(frame_bgr: np.ndarray, cfg: Config) -> np.ndarray:
    """A decoded frame -> the [rows, cols, 3] u8 working frame (LANCZOS).

    The reference wraps the raw cv2 (BGR) frame in PIL without a channel
    conversion (dataset_feat_extractor.py:127-131), so the CNN sees B and
    R swapped; kept for artifact parity.  A frame already at
    ``cfg.frame_hw`` is returned as it is, without PIL: Pillow's
    ``resize`` to the image's own size returns a plain copy, and
    ``convert("RGB")`` of a 3-channel u8 image is the identity, so the
    bytes are the same.
    """
    rows, cols = cfg.frame_hw
    if frame_bgr.shape[:2] == (rows, cols):
        return np.ascontiguousarray(frame_bgr, dtype=np.uint8)
    from PIL import Image

    img = Image.fromarray(frame_bgr).convert("RGB")
    img = img.resize((cols, rows), resample=getattr(Image, "LANCZOS", None)
                     or Image.Resampling.LANCZOS)
    return np.asarray(img, dtype=np.uint8)


def _model_device(model: Backbone) -> torch.device:
    return next(iter(model.buffers())).device


def extract_frames(model: Union[Backbone, LocalReplicas], cfg: Config,
                   frames: Iterable[np.ndarray], out_dir: str,
                   output_img: bool = True, output_feature: bool = True,
                   output_motion: bool = False, max_frames: Optional[int] = None,
                   batch_frames: int = 8, resume: bool = True, log_fn=print,
                   name: str = "frames") -> int:
    """Stage 1 over a stream of decoded BGR u8 frames; returns the number of
    frames written or found complete.

    The first frame only seeds the reference's lag: artifact k = i + 1
    holds frame i - 1, so numbering starts at 000002, and motion k is the
    flow from decoded frame i - 1 to frame i at ``(2 flow_h, flow_h)``.
    Frames go to the model's device in batches of ``batch_frames`` (the
    CLI passes ``cfg.extract_batch``), the tail batch padded with its last
    frame so every batch has one shape;
    ``cfg.host_cube_remap`` picks the host cv2 remap (``stage1_batch_faces``,
    or ``stage1_batch_faces_yuv`` with ``upload_format: yuv420``; optional
    int8 codec) or the all-device step (``stage1_batch``).  With
    ``output_motion`` and ``cfg.opt_flow``, a device flow backend solves
    the batch's pairs (tail padded with its last pair) in one call on the
    model's device and copies them back in ``cfg.flow_link_dtype``; a host
    backend solves each pair on a pool of ``cfg.processes`` threads.  One
    assembly thread waits for each batch's host remaps and stacks and pads
    it into (pinned, on a card) host memory up to ``cfg.upload_depth``
    batches ahead of the device; the copies to the device and the launches
    stay on the calling thread, in batch order.  Up to ``cfg.fetch_depth``
    batches stay in flight on the device before the oldest is copied back
    and written, so the host decodes and writes while the device computes.
    With ``resume`` frames whose requested artifacts exist are skipped (every
    file is written atomically, so an existing one is complete); without
    it they are computed and written again.  The summary line goes to
    ``log_fn``.

    ``model`` may be a :class:`~cp360_tpu_torch.parallel.mesh.LocalReplicas`
    of the backbone: each batch then splits into equal row blocks, one per
    replica's device (frames are independent; the reference's loop is
    serial only by construction, dataset_feat_extractor.py:119-123), and
    the results come back on its first device.
    """
    check_extract_config(cfg, output_motion)
    replicas = model if isinstance(model, LocalReplicas) else None
    if replicas is not None:
        check_divisible(batch_frames, len(replicas), f"batch_frames={batch_frames}",
                        "so frames shard evenly")
    device = replicas.device if replicas is not None else _model_device(model)
    pin = device.type == "cuda"
    feat_dir = os.path.join(out_dir, "cube_feat")
    motion_dir = os.path.join(out_dir, "motion")
    img_dir = os.path.join(out_dir, "img")
    flow_on = output_motion and cfg.opt_flow
    device_flow = flow_on and cfg.flow_backend in optical_flow.DEVICE_BACKENDS
    flow_res = (cfg.flow_h * 2, cfg.flow_h)
    for d in (out_dir, feat_dir, img_dir) + ((motion_dir,) if flow_on else ()):
        os.makedirs(d, exist_ok=True)
    out_dtype = torch.float16 if cfg.feat_dtype == "float16" else torch.float32
    np_dtype = np.float16 if cfg.feat_dtype == "float16" else np.float32
    codec = cfg.transfer_codec if cfg.host_cube_remap else "none"
    yuv = cfg.host_cube_remap and cfg.upload_format == "yuv420"
    fetch_depth = max(1, cfg.fetch_depth)
    upload_depth = max(1, cfg.upload_depth)
    flow_solver = (optical_flow.get_batch_solver_u8(cfg.flow_backend, cfg.flow_link_dtype,
                                                    device) if device_flow else None)
    written = 0
    stage1 = partial(stage1_uploaded, out_dtype=out_dtype, codec=codec, cube_dim=cfg.cube_dim)

    def assemble(batch, remap_futs):
        """Stack and pad one batch into host staging tensors (on the
        assembly thread: no device work)."""
        if cfg.host_cube_remap:
            items = [f.result() for f in remap_futs]
        else:
            items = [b[1] for b in batch]
        return stage_batch(items, batch_frames, pin)

    def compute(batch, hosts):
        """Copy one assembled batch to the device and launch it; returns its
        pending record (the staging tensors live until it is flushed)."""
        xs = tuple(h.to(device, non_blocking=True) for h in hosts)
        if replicas is not None:
            out = replicas.run(stage1, split=xs)
        else:
            out = stage1(model, *xs)
        # the artifact layout [N, 6, K, h, w], made contiguous on the device:
        # np.save of a transposed view writes element by element
        out = (*(t.permute(0, 1, 4, 2, 3).contiguous() for t in out[:-1]), out[-1])
        flows = None
        if device_flow:  # one solve for the batch's pairs, the tail padded
            pairs = [b[2].result() for b in batch]
            pairs += [pairs[-1]] * (batch_frames - len(pairs))
            flows = flow_solver(np.stack([p[0] for p in pairs]),
                                np.stack([p[1] for p in pairs]))
        return batch, out, hosts, flows

    def flush(pending) -> None:
        nonlocal written
        batch, out, _, flows = pending
        if len(out) == 3:  # int8 codec: (q, scales, sal) crossed back
            q, scales, sals = (t.cpu().numpy() for t in out)
            scores = dequantize_cam_np(q, scales, np_dtype)
        else:
            scores, sals = (t.cpu().numpy() for t in out)
        if flows is not None:
            flows = flows.cpu().numpy()
        for k, (cnt, frame_u8, flow) in enumerate(batch):
            if output_feature:  # reference layout [6, K, h, w]
                atomic_save(os.path.join(feat_dir, f"{cnt:06}.npy"), scores[k])
            if flow_on:  # f32 [flow_h, 2 flow_h, 2], whatever the link dtype
                motion = flows[k] if device_flow else flow.result()[1]
                atomic_save(os.path.join(motion_dir, f"{cnt:06}.npy"),
                            np.ascontiguousarray(motion, dtype=np.float32))
            if output_img:
                from PIL import Image

                from cp360_tpu_torch.imaging.overlay import overlay

                img = Image.fromarray(frame_u8)
                _atomic_pil_save(overlay(img, sals[k]), os.path.join(out_dir, f"{cnt:06}.jpg"))
                _atomic_pil_save(img, os.path.join(img_dir, f"{cnt:06}.jpg"))
            written += 1

    t_start = time.time()
    remap_pool = (ThreadPoolExecutor(max_workers=max(2, cfg.processes))
                  if cfg.host_cube_remap else None)
    # flow: a device backend's pool only resizes and grays the pairs; a host
    # backend's (cv2 releases the GIL) computes the whole flow
    flow_pool = (ThreadPoolExecutor(max_workers=max(2, cfg.processes) if device_flow
                                    else cfg.processes) if flow_on else None)
    flow_job = (optical_flow._preprocess_pair if device_flow
                else optical_flow.get_flow_fn(cfg.flow_backend))
    upload_pool = ThreadPoolExecutor(max_workers=1)
    uploads: deque = deque()  # (batch, future of its staging tensors), oldest first
    pendings: deque = deque()

    def drain_one() -> None:
        batch, staged = uploads.popleft()
        pendings.append(compute(batch, staged.result()))
        while len(pendings) > fetch_depth:
            flush(pendings.popleft())

    batch, remap_futs = [], []
    prev = None
    try:
        with torch.no_grad():
            for i, frame in enumerate(frames):
                if max_frames is not None and i >= max_frames:
                    break
                if i == 0:
                    prev = frame
                    continue
                cnt = i + 1  # reference numbering starts at 000002
                if resume and _artifacts_exist(cnt, feat_dir, motion_dir, img_dir, out_dir,
                                               output_feature, flow_on, output_img):
                    written += 1
                    prev = frame
                    continue
                frame_u8 = _resize_frame(prev, cfg)
                flow = flow_pool.submit(flow_job, prev, frame, flow_res) if flow_on else None
                batch.append((cnt, frame_u8, flow))
                if remap_pool is not None:
                    remap_futs.append(remap_pool.submit(host_faces_for_upload, frame_u8,
                                                        cfg.cube_dim, yuv))
                prev = frame
                if len(batch) == batch_frames:
                    uploads.append((batch, upload_pool.submit(assemble, batch, remap_futs)))
                    batch, remap_futs = [], []
                    if len(uploads) > upload_depth:
                        drain_one()
            if batch:
                uploads.append((batch, upload_pool.submit(assemble, batch, remap_futs)))
            while uploads:
                drain_one()
            while pendings:
                flush(pendings.popleft())
    finally:
        for pool in (upload_pool, remap_pool, flow_pool):
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
    log_fn(f"{name}: {written} frames in {time.time() - t_start:.1f}s")
    return written


def _video_frames(cap, total: int) -> Iterator[np.ndarray]:
    for _ in range(total):
        ok, frame = cap.read()
        if not ok:
            return
        yield frame


def extract_video(model: Union[Backbone, LocalReplicas], cfg: Config, vid_path: str,
                  out_dir: str,
                  output_img: bool = True, output_feature: bool = True,
                  output_motion: bool = True, *, max_frames: Optional[int] = None,
                  batch_frames: int = 8, resume: bool = True, log_fn=print) -> int:
    """:func:`extract_frames` over the frames ``cv2.VideoCapture`` decodes
    from ``vid_path`` (up to its frame count, or ``max_frames``).  An
    unreadable path raises ``FileNotFoundError``."""
    import cv2

    cap = cv2.VideoCapture(vid_path)
    try:
        if not cap.isOpened():
            raise FileNotFoundError(
                f"cannot open video {vid_path!r} (missing file or unsupported codec)")
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        return extract_frames(model, cfg, _video_frames(cap, total), out_dir,
                              output_img=output_img, output_feature=output_feature,
                              output_motion=output_motion, max_frames=max_frames,
                              batch_frames=batch_frames, resume=resume, log_fn=log_fn,
                              name=vid_path)
    finally:
        cap.release()
