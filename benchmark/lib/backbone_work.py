"""The stage-1 backbone's work a frame, counted from a configuration's
shapes: (operations, bytes) of the trunk on the 6 faces of a frame with
its CAM, for the cube-padded ResNets (``arch`` ``resnet*``) and VGG16-BN
(``vgg16``), and the least time of that work at the H100's published
peaks.

Operations: multiply-adds count 2.  A ResNet's are
``lib/flops.py::backbone_frame_flops``'s; VGG16's are its 13 convs,
``camconv`` and the CAM matmul.  Cube padding makes each 3x3 conv a VALID
conv of the padded faces, so a conv's output has the unpadded size.

VGG16's widths are configuration D's (``lib/weights_vgg16.py``).

Bytes, as ``lib/k1.py`` counts K1's: each layer's input read once, its
output written once and its weights once, in the compute dtype (the CAM's
scores in float32).  The layers are the convs, the max pools and the CAM
matmul; a batch norm, a ReLU and a residual add are taken as fused into
the conv before them, so they add nothing.
"""

from __future__ import annotations

from typing import Tuple

from benchmark.lib.flops import backbone_frame_flops
from benchmark.lib.peaks import H100_BF16_FLOPS, H100_F32_FLOPS, bound_ms
from benchmark.lib.weights import DEPTHS, DTYPES, EXPANSION
from benchmark.lib.weights_vgg16 import CFG_D, WIDTH

F32 = 4


def _conv(s_in: int, s_out: int, k: int, cin: int, cout: int, item: int):
    """(multiply-adds, bytes) of one conv on one face."""
    return (s_out * s_out * k * k * cin * cout,
            item * (s_in * s_in * cin + s_out * s_out * cout + k * k * cin * cout))


def _pool(s_in: int, s_out: int, c: int, item: int):
    return 0, item * c * (s_in * s_in + s_out * s_out)


def vgg16_face(face: int, width: int, cam_channels: int, item: int):
    """((trunk multiply-adds, bytes), (camconv multiply-adds, bytes)) on
    one face."""
    macs = nbytes = 0
    s, cin = face, 3
    for v in CFG_D:
        if v == "M":
            nbytes += _pool(s, s // 2, cin, item)[1]
            s //= 2
            continue
        m, b = _conv(s, s, 3, cin, width * v, item)
        macs, nbytes, cin = macs + m, nbytes + b, width * v
    return (macs, nbytes), _conv(s, s, 3, cin, cam_channels, item)


def resnet_face_bytes(arch: str, width: int, face: int, item: int) -> int:
    """The bytes of a cube-padded ResNet's trunk on one face."""
    s = face // 2
    total = _conv(face, s, 7, 3, width, item)[1] + _pool(s, s // 2, width, item)[1]
    s //= 2
    inplanes = width
    for li, depth in enumerate(DEPTHS[arch]):
        planes = width * 2 ** li
        for bi in range(depth):
            stride = 2 if (li > 0 and bi == 0) else 1
            s_out = s // stride
            total += _conv(s, s, 1, inplanes, planes, item)[1]
            total += _conv(s, s_out, 3, planes, planes, item)[1]
            total += _conv(s_out, s_out, 1, planes, planes * EXPANSION, item)[1]
            if stride != 1 or inplanes != planes * EXPANSION:
                total += _conv(s, s_out, 1, inplanes, planes * EXPANSION, item)[1]
            inplanes, s = planes * EXPANSION, s_out
    return total


def _cam(s: int, c: int, k: int, item: int):
    """(multiply-adds, bytes) of the CAM matmul on one face's features."""
    return s * s * c * k, item * s * s * c + F32 * (c * k + s * s * k)


def frame_work(config: dict) -> Tuple[float, float]:
    """(operations, bytes) of one frame: the backbone on its 6 faces and the
    CAM."""
    cfg = config["config"]
    face = cfg.get("cube_dim", 224)
    item = DTYPES[cfg.get("compute_dtype", "bfloat16")].itemsize
    arch, k = config["arch"], config["num_classes"]
    if arch == "vgg16":
        c = config["cam_channels"]
        (tm, tb), (cm, cb) = vgg16_face(face, WIDTH, c, item)
        am, ab = _cam(face // 32, c, k, item)
        return 6 * 2.0 * (tm + cm + am), 6.0 * (tb + cb + ab)
    if arch in DEPTHS:
        width = config["base_width"]
        c = width * 8 * EXPANSION
        return (backbone_frame_flops(arch, width, face, k),
                6.0 * (resnet_face_bytes(arch, width, face, item) + _cam(face // 32, c, k,
                                                                         item)[1]))
    raise ValueError(f"no backbone work counted for arch {arch!r}")


def least_ms(config: dict, frames: float) -> float:
    """The least time of ``frames`` frames' backbone work at the H100's
    published peaks (the tensor cores' in bf16, else float32's)."""
    ops, nbytes = frame_work(config)
    bf16 = config["config"].get("compute_dtype", "bfloat16") == "bfloat16"
    return bound_ms(frames * nbytes, frames * ops,
                    H100_BF16_FLOPS if bf16 else H100_F32_FLOPS)[0]
