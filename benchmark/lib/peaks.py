"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W) and
the least time of a piece of work at them (copied from the port's
``cp360_tpu_torch/bench/common.py::bound_ms``)."""

H100_BF16_FLOPS = 989e12  # dense tensor-core peak
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = H100_BF16_FLOPS):
    """(least time in ms, what bounds it) at the H100's published peaks."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
