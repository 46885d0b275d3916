"""The cube-padded Swin Transformer backbone's work, counted from a
configuration's shapes: (operations, bytes) a frame of the trunk on its 6
faces with the CAM, and of its window attentions alone; the least time of
each at the H100's published peaks.

Operations: multiply-adds count 2.  The trunk's are the patch embed (4x4
stride 4), each block's qkv (C -> 3C), window attention, proj (C -> C), fc1
(C -> 4C) and fc2 (4C -> C), and each patch merging's linear (4C -> 2C);
then the CAM matmul.  A window attention takes q.k and p.v over its
windows: 2 * M^4 * C multiply-adds a window (all heads).  A regular layer
has (g/M)^2 windows on a g x g grid, a shifted one (g/M + 1)^2 (the grid
cube-padded by M - M//2 and M//2; the published roll and mask has
(g/M)^2), and a grid of one window is never shifted.  Swin-B on a 224
face: 15.5 G multiply-adds (the paper's 15.4 G with (g/M)^2 shifted
windows) and 87.77 M parameters.

Bytes, as ``lib/convnext_work.py`` counts ConvNeXt's: each linear's input
read once and its output written once in the compute dtype, except the
outputs that are the f32 residual stream (the patch embed's, proj's,
fc2's, each merging's), 4 bytes a value; the weights once a stage-1 call
(a batch of ``stage1_batch`` frames); a LayerNorm, GELU and the residual
adds are taken as fused into the layers beside them, so they add nothing.
A window attention reads q once a token and k and v once a window slot
(as its windows gather them) and writes its output once a token, in the
compute dtype, and reads the qkv bias and its relative-position table (f32)
once a stage-1 call.  The module holds the LayerNorms that read the f32
stream (all but the patch embed's) in f32, with the biases and tables.

The attention's least time is at the bytes rate or the bf16 tensor-core
peak, the larger (bytes: about 24 operations a byte, against the card's
~295); the whole trunk's at the bf16 peak in a bf16 configuration, as the
other families are counted.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from benchmark.lib.peaks import H100_BF16_FLOPS, H100_F32_FLOPS, bound_ms
from benchmark.lib.weights import DTYPES

F32 = 4
PATCH = 4


def windows(g: int, m: int, shift: bool) -> int:
    """Windows a face of one layer on a g x g grid."""
    return (g // m + 1) ** 2 if shift else (g // m) ** 2


def _add(a, b, times: int = 1):
    return tuple(x + times * y for x, y in zip(a, b))


def _linear(tokens: int, cin: int, cout: int, item: int, out_item: int):
    """(multiply-adds, activation bytes, kernel values, 0) of a per-token
    linear over ``tokens`` tokens."""
    return tokens * cin * cout, tokens * (cin * item + cout * out_item), cin * cout, 0


def face_work(face: int, embed: int, depths: Sequence[int], heads: Sequence[int], m: int,
              item: int = 2, mlp: int = 4) -> Dict[str, tuple]:
    """{"trunk": (multiply-adds, activation bytes, values in the compute
    dtype: kernels and the patch embed's LayerNorm, f32 values: biases,
    tables and the other LayerNorms), "attn": the same of the window
    attentions alone} of one face, the compute dtype ``item`` bytes a
    value."""
    g = face // PATCH
    trunk = _add(_linear(g * g, PATCH * PATCH * 3, embed, item, F32), (0, 0, 2 * embed, embed))
    attn = (0, 0, 0, 0)
    c = embed
    for si, (depth, h) in enumerate(zip(depths, heads)):
        if si:
            g, c = g // 2, 2 * c
            merge = _linear(g * g, 2 * c, c, item, F32)
            trunk = _add(trunk, _add(merge, (0, 0, 0, 4 * c)))  # its LayerNorm over 2c
        for bi in range(depth):
            nw = windows(g, m, g > m and bi % 2 == 1)
            a = (2 * nw * m ** 4 * c, item * (2 * g * g * c + 2 * nw * m * m * c), 0,
                 3 * c + (2 * m - 1) ** 2 * h)  # q.k and p.v; q, o, k, v; bias, table
            blk = _add(_add(_linear(g * g, c, 3 * c, item, item), a),
                       _linear(g * g, c, c, item, F32))
            blk = _add(_add(blk, _linear(g * g, c, mlp * c, item, item)),
                       _linear(g * g, mlp * c, c, item, F32))
            blk = _add(blk, (0, 0, 0, c + mlp * c + c + 4 * c))  # proj, fc1, fc2 biases; 2 LNs
            trunk = _add(trunk, blk)
            attn = _add(attn, a)
    return {"trunk": _add(trunk, (0, 0, 0, 2 * c)), "attn": attn}  # the head's LayerNorm


def _shapes(config: dict):
    cfg = config["config"]
    return (cfg.get("cube_dim", 224), DTYPES[cfg.get("compute_dtype", "bfloat16")].itemsize,
            config["embed"], config["depths"], config["heads"], config["window"],
            config.get("mlp_ratio", 4))


def _face(config: dict, face: int = None) -> Dict[str, tuple]:
    f, item, embed, depths, heads, m, mlp = _shapes(config)
    return face_work(face or f, embed, depths, heads, m, item, mlp)


def parameters(config: dict) -> int:
    """The backbone's parameters: the trunk's and the classifier's."""
    trunk = _face(config, 224)["trunk"]
    c = config["embed"] * 8
    return trunk[2] + trunk[3] + c * config["num_classes"] + config["num_classes"]


def frame_work(config: dict, batch: int) -> Tuple[float, float]:
    """(operations, bytes) of one frame: the trunk on its 6 faces and the
    CAM, the weights counted once a stage-1 call of ``batch`` frames."""
    face, item = _shapes(config)[:2]
    m, acts, kernels, vectors = _face(config)["trunk"]
    s, c, k = face // 32, config["embed"] * 8, config["num_classes"]
    cam_m, cam_bytes = s * s * c * k, item * s * s * c + F32 * s * s * k
    return (6 * 2.0 * (m + cam_m),
            6.0 * (acts + cam_bytes) + (item * kernels + F32 * (vectors + c * k)) / batch)


def attn_frame_work(config: dict, batch: int) -> Tuple[float, float]:
    """(operations, bytes) of one frame's window attentions (every
    block's), their qkv biases and tables counted once a stage-1 call of
    ``batch`` frames."""
    m, acts, _, vectors = _face(config)["attn"]
    return 6 * 2.0 * m, 6.0 * acts + F32 * vectors / batch


def least_ms(config: dict, frames: float, batch: int) -> float:
    """The least time of ``frames`` frames' trunk and CAM work at the
    H100's published peaks (the tensor cores' in bf16, else float32's)."""
    ops, nbytes = frame_work(config, batch)
    bf16 = config["config"].get("compute_dtype", "bfloat16") == "bfloat16"
    return bound_ms(frames * nbytes, frames * ops,
                    H100_BF16_FLOPS if bf16 else H100_F32_FLOPS)[0]


def attn_least_ms(config: dict, frames: float, batch: int) -> float:
    """The least time of ``frames`` frames' window attentions at the H100's
    published bytes rate and bf16 peak."""
    ops, nbytes = attn_frame_work(config, batch)
    return bound_ms(frames * nbytes, frames * ops, H100_BF16_FLOPS)[0]
