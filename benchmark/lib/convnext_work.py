"""The cube-padded ConvNeXt backbone's work, counted from a configuration's
shapes: (operations, bytes) a frame of the trunk on its 6 faces with the
CAM, and of its depthwise convs alone; the least time of each at the
H100's published peaks.

Operations: multiply-adds count 2.  The trunk's are the stem (4x4 stride
4), the three downsampling convs (2x2 stride 2), and each block's depthwise
7x7 (49 multiply-adds an output value) and its two per-position linears
(C -> 4C -> C); then the CAM matmul.  ConvNeXt-B on a 224 face: 15.35 G
multiply-adds and 88.59 M parameters.

Bytes, as ``lib/backbone_work.py`` counts a backbone's: each conv's and
each linear's input read once and its output written once in the compute
dtype (the CAM's scores in float32), and its weights once a stage-1 call
(a batch of ``stage1_batch`` frames, which the program reads its weights
once for), not once a face; a LayerNorm, GELU, the layer scale and the
residual add are taken as fused into the layer before them, so they add
nothing.  The residual stream is float32, as the program holds it: the
outputs of the stem, of the downsampling convs and of each block (its W2,
which adds the residual) and the depthwise convs' inputs count 4 bytes a
value; so do the depthwise kernels and the scales and shifts of the
LayerNorms that read the stream (the downsampling convs' and the head's),
which the program holds in float32 beside it.

The depthwise convs' least time is at the f32 peak of the CUDA cores,
where their sums run whatever the storage dtype (a depthwise conv has no
matrix product for the tensor cores); the whole trunk's is at the bf16
tensor-core peak in a bf16 configuration, as ``backbone_work.py`` counts
the other families.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from benchmark.lib.peaks import H100_BF16_FLOPS, H100_F32_FLOPS, bound_ms
from benchmark.lib.weights import DTYPES
from benchmark.lib.weights_convnext import DOWN, DW, STEM

F32 = 4


def _conv(s_out: int, k: int, cin: int, cout: int, item: int, out_item: int):
    """(multiply-adds, activation bytes read and written, kernel values,
    f32 values) of one dense conv and its bias on one face (a kxk conv at
    stride k: each input read once), its input ``item`` and its output
    ``out_item`` bytes a value."""
    return (s_out * s_out * k * k * cin * cout,
            s_out * s_out * (k * k * cin * item + cout * out_item), k * k * cin * cout, cout)


def _add(a, b, times: int = 1):
    return tuple(x + times * y for x, y in zip(a, b))


def face_work(face: int, depths: Sequence[int], dims: Sequence[int], item: int = 2):
    """{"trunk": (multiply-adds, activation bytes read and written, values in
    the compute dtype: kernels and the blocks' and the stem's LayerNorms,
    f32 values: biases, gamma, the depthwise kernels and the other
    LayerNorms), "dw": the same of the depthwise convs alone} of one face,
    the compute dtype ``item`` bytes a value."""
    s = face // STEM
    trunk = _add(_conv(s, STEM, 3, dims[0], item, F32), (0, 0, 2 * dims[0], 0))  # its LayerNorm
    dw = (0, 0, 0, 0)
    for si, (depth, c) in enumerate(zip(depths, dims)):
        if si:
            s //= DOWN
            down = _conv(s, DOWN, dims[si - 1], c, item, F32)
            trunk = _add(trunk, _add(down, (0, 0, 0, 2 * dims[si - 1])))  # with its LayerNorm
        per_dw = (s * s * DW * DW * c, s * s * c * (F32 + item), 0, DW * DW * c + c)
        per_block = _add(_add(_add(per_dw, _conv(s, 1, c, 4 * c, item, item)),
                              _conv(s, 1, 4 * c, c, item, F32)),
                         (0, 0, 2 * c, c))  # the LayerNorm, gamma
        trunk = _add(trunk, per_block, depth)
        dw = _add(dw, per_dw, depth)
    return {"trunk": _add(trunk, (0, 0, 0, 2 * dims[-1])), "dw": dw}  # the head's LayerNorm


def parameters(config: dict) -> int:
    """The backbone's parameters: the trunk's and the classifier's."""
    _, item, depths, dims = _shapes(config)
    trunk = face_work(224, depths, dims, item)["trunk"]
    return trunk[2] + trunk[3] + dims[-1] * config["num_classes"] + config["num_classes"]


def _shapes(config: dict) -> Tuple[int, int, Sequence[int], Sequence[int]]:
    cfg = config["config"]
    return (cfg.get("cube_dim", 224), DTYPES[cfg.get("compute_dtype", "bfloat16")].itemsize,
            config["depths"], config["dims"])


def frame_work(config: dict, batch: int) -> Tuple[float, float]:
    """(operations, bytes) of one frame: the trunk on its 6 faces and the
    CAM, the weights counted once a stage-1 call of ``batch`` frames."""
    face, item, depths, dims = _shapes(config)
    m, acts, kernels, vectors = face_work(face, depths, dims, item)["trunk"]
    s, c, k = face // 32, dims[-1], config["num_classes"]
    cam_m, cam_bytes = s * s * c * k, item * s * s * c + F32 * s * s * k
    return (6 * 2.0 * (m + cam_m),
            6.0 * (acts + cam_bytes) + (item * kernels + F32 * (vectors + c * k)) / batch)


def dw_frame_work(config: dict, batch: int) -> Tuple[float, float]:
    """(operations, bytes) of one frame's depthwise convs (every block's),
    their kernels and biases counted once a stage-1 call of ``batch``
    frames."""
    face, item, depths, dims = _shapes(config)
    m, acts, _, kernels_and_biases = face_work(face, depths, dims, item)["dw"]
    return 6 * 2.0 * m, 6.0 * acts + F32 * kernels_and_biases / batch


def least_ms(config: dict, frames: float, batch: int) -> float:
    """The least time of ``frames`` frames' trunk and CAM work at the
    H100's published peaks (the tensor cores' in bf16, else float32's)."""
    ops, nbytes = frame_work(config, batch)
    bf16 = config["config"].get("compute_dtype", "bfloat16") == "bfloat16"
    return bound_ms(frames * nbytes, frames * ops,
                    H100_BF16_FLOPS if bf16 else H100_F32_FLOPS)[0]


def dw_least_ms(config: dict, frames: float, batch: int) -> float:
    """The least time of ``frames`` frames' depthwise convs at the H100's
    published bytes rate and f32 peak."""
    ops, nbytes = dw_frame_work(config, batch)
    return bound_ms(frames * nbytes, frames * ops, H100_F32_FLOPS)[0]
