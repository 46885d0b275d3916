"""Cube-padded convolutional LSTM (PyTorch).

The counterpart of ``cp360_tpu/models/clstm.py:76-143`` (reference single
cell, model/clstm.py:19-101): three stacked 3x3 VALID convs, each preceded
by cube padding, produce the 4 LSTM gates over the [*, 6, 7, 7, C] CAM
cube.  Gate order in the stacked channel dim is torch ``chunk(4, 1)``'s:
input, forget (remember), output, cell (model/clstm.py:68).  The reference's
dead LogSoftmax is not computed; the time rollout is a Python loop over
whole batches of independent windows.

``conv_impl`` (config ``clstm_conv_impl``) accepts 'xla' and 'pallas', the
JAX package's two names for its XLA and Pallas convs.  In the port both
name the same function: a cube-padded conv on a CUDA tensor always launches
the fused kernel (ops/cube_conv.py); its plain version runs for CPU tensors
only.  ``use_cube_pad=False`` runs the plain zero-pad conv, as
``cp360_tpu/models/clstm.py:60,72`` does.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from cp360_tpu_torch.models import layers
from cp360_tpu_torch.ops import cube_conv
from cp360_tpu_torch.ops.cube_pad import zero_pad

CONV_IMPLS = ("xla", "pallas")
CONV_NAMES = ("conv1", "conv2", "gates")


class ConvLSTM(nn.Module):
    """One ConvLSTM cell's weights: for each conv a [3, 3, Cin, Cout] HWIO
    kernel and a [Cout] bias, held in the compute dtype (the dtype the convs
    run in).  Built by ``compat/jax_params.py::clstm_from_params``."""

    def __init__(self, convs: dict, compute_dtype: torch.dtype,
                 use_cube_pad: bool = True, conv_impl: str = "xla"):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"clstm_conv_impl must be one of {CONV_IMPLS}, got {conv_impl!r}")
        self.compute_dtype = compute_dtype
        self.use_cube_pad = use_cube_pad
        for name in CONV_NAMES:
            self.register_buffer(f"{name}_w", convs[name]["w"].to(compute_dtype).contiguous())
            self.register_buffer(f"{name}_b", convs[name]["b"].to(compute_dtype).contiguous())

    @property
    def hidden_size(self) -> int:
        return self.gates_w.shape[3] // 4

    def conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """One cube-padded 3x3 conv on face-flattened [B*6, h, w, C] input."""
        w, b = getattr(self, f"{name}_w"), getattr(self, f"{name}_b")
        if self.use_cube_pad:  # the kernel's wrapper rejects non-square faces
            x6 = x.reshape(-1, 6, *x.shape[1:]).to(self.compute_dtype).contiguous()
            out = cube_conv.cube_conv3x3(x6, w, b)
            return out.reshape(-1, *out.shape[2:])
        x6 = zero_pad(x.reshape(-1, 6, *x.shape[1:]), 1)
        return layers.conv2d(x6.reshape(-1, *x6.shape[2:]), w, b,
                             compute_dtype=self.compute_dtype)


def clstm_step(cell: ConvLSTM, x: torch.Tensor,
               state: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ConvLSTM step.

    Args:
      x: [B*6, H, W, Cin] input cube faces (face-flattened batch).
      state: (hidden, cell), each [B*6, H, W, Ch].

    Returns new (hidden, cell).
    """
    h, c = state
    z = torch.cat([x, h], dim=-1)
    out = torch.relu(cell.conv("conv1", z))
    out = torch.relu(cell.conv("conv2", out))
    gates = cell.conv("gates", out)

    i_g, f_g, o_g, c_g = torch.chunk(gates, 4, dim=-1)
    i_g = torch.sigmoid(i_g)
    f_g = torch.sigmoid(f_g)
    o_g = torch.sigmoid(o_g)
    c_g = torch.tanh(c_g)

    new_c = f_g * c + i_g * c_g
    new_h = o_g * torch.tanh(new_c)
    return new_h, new_c


def clstm_rollout(cell: ConvLSTM, seq: torch.Tensor, h0: torch.Tensor,
                  c0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the cell over time.

    Args:
      seq: [T, B*6, H, W, Cin].
      h0, c0: [B*6, H, W, Ch] initial state (the protocol seeds both with
        the normalized first frame, temporal_model/test_temporal.py:70-73).

    Returns (hiddens [T, B*6, H, W, Ch], final hidden, final cell).
    """
    h, c = h0, c0
    hs = []
    for x in seq:
        h, c = clstm_step(cell, x, (h, c))
        hs.append(h)
    return torch.stack(hs), h, c
