"""Model operations counted from a configuration's shapes (multiply-adds
count 2): the cube-padded ResNet on the 6 faces of a frame with its class
activation map, and the ConvLSTM over one window.  Cube padding makes each
3x3 conv a VALID conv of the padded faces, so a conv's output has the
unpadded size and the count is that of the plain network on each face."""

from __future__ import annotations

from benchmark.lib.weights import DEPTHS, EXPANSION


def backbone_frame_flops(arch: str, width: int, face: int, num_classes: int) -> float:
    """One frame: the ResNet trunk on its 6 faces and the CAM matmul."""
    def conv(hw_out, k, cin, cout):
        return 2.0 * hw_out * hw_out * k * k * cin * cout

    s = face // 2
    total = conv(s, 7, 3, width)
    s //= 2  # the stem pool
    inplanes = width
    for li, depth in enumerate(DEPTHS[arch]):
        planes = width * 2 ** li
        for bi in range(depth):
            stride = 2 if (li > 0 and bi == 0) else 1
            s_out = s // stride
            total += conv(s, 1, inplanes, planes) + conv(s_out, 3, planes, planes)
            total += conv(s_out, 1, planes, planes * EXPANSION)
            if stride != 1 or inplanes != planes * EXPANSION:
                total += conv(s_out, 1, inplanes, planes * EXPANSION)
            inplanes, s = planes * EXPANSION, s_out
    total += 2.0 * s * s * inplanes * num_classes  # CAM
    return 6 * total


def clstm_window_flops(input_size: int, hidden_size: int, h: int, seq_len: int) -> float:
    """One window's forward: seq_len steps of three cube-padded 3x3 convs."""
    h4 = 4 * hidden_size
    m = 6 * h * h
    step = 2.0 * m * 9 * ((input_size + hidden_size) * h4 + 2 * h4 * h4)
    return seq_len * step


def for_config(config: dict):
    """(backbone FLOPs a frame, ConvLSTM forward FLOPs a window)."""
    cfg = config["config"]
    face = cfg.get("cube_dim", 224)
    return (backbone_frame_flops(config["arch"], config["base_width"], face,
                                 config["num_classes"]),
            clstm_window_flops(cfg["input_size"], cfg["hidden_size"], face // 32,
                               cfg.get("seq_len", 5)))
