"""The fused cube-pad 3x3 conv (K1, ``cp360_tpu_torch/ops/cube_conv.py``)
and its input gradient: the work of each call counted from its shapes, as
``cp360_tpu_torch/bench/cube_conv.py`` counts it (the 9 taps' products;
each input read once, each output written once), and a recorder of the
calls a traced window makes."""

from __future__ import annotations

from benchmark.lib.peaks import H100_BF16_FLOPS, H100_F32_FLOPS, bound_ms

# the device operations of K1's library (csrc/cube_conv3x3.cu)
KERNEL_PATTERNS = ("cube_conv3x3_wgmma", "cube_conv3x3_f32", "splitk_reduce", "dx_row_sums")


def work(kind: str, n: int, h: int, cin: int, cout: int, itemsize: int):
    """(operations, bytes) of one call: ``fwd`` [n, 6, h, h, cin] ->
    cout, or ``dx`` back from cout to cin."""
    m = n * 6 * h * h
    ops = 2.0 * m * 9 * cin * cout
    w = 9 * cin * cout * itemsize
    if kind == "fwd":
        return ops, m * cin * itemsize + w + cout * itemsize + m * cout * itemsize
    return ops, m * cout * itemsize + w + m * cin * itemsize


def least_ms(kind: str, n: int, h: int, cin: int, cout: int, itemsize: int) -> float:
    ops, nbytes = work(kind, n, h, cin, cout, itemsize)
    return bound_ms(nbytes, ops, H100_BF16_FLOPS if itemsize == 2 else H100_F32_FLOPS)[0]


def record_calls(run) -> None:
    """Count every K1 and dx call the program makes while the window is
    traced, with its shapes, in ``run.counters["k1_calls"]``."""
    from cp360_tpu_torch.ops import cube_conv

    calls = run.counters.setdefault("k1_calls", [])
    fwd, dx = cube_conv._forward, cube_conv._dx

    def _forward(x, w, b, splits=None):
        if run.tracing:
            calls.append(("fwd", x.shape[0], x.shape[2], x.shape[4], w.shape[3],
                          x.element_size()))
        return fwd(x, w, b, splits)

    def _dx(dy, w, splits=None):
        if run.tracing:
            calls.append(("dx", dy.shape[0], dy.shape[2], w.shape[2], dy.shape[4],
                          dy.element_size()))
        return dx(dy, w, splits)

    cube_conv._forward, cube_conv._dx = _forward, _dx
