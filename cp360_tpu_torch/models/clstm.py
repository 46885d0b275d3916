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
the fused kernel (ops/cube_conv.py), and its backward the dx kernel; the
plain versions run for CPU tensors only.  ``use_cube_pad=False`` runs the
plain zero-pad conv, as ``cp360_tpu/models/clstm.py:60,72`` does.

Under tensor parallelism (:meth:`ConvLSTM.shard_over`) each rank holds a
contiguous slice of every conv's output channels, runs its convs (K1
forward, dx backward) on that slice and gathers the activations along
channels before the next conv and the gate split
(``parallel/mesh.py``, the layout of ``clstm_param_sharding``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from cp360_tpu_torch.models import layers
from cp360_tpu_torch.ops import cube_conv
from cp360_tpu_torch.ops.cube_pad import zero_pad
from cp360_tpu_torch.parallel import mesh as pmesh

CONV_IMPLS = ("xla", "pallas")
CONV_NAMES = ("conv1", "conv2", "gates")


class ConvLSTM(nn.Module):
    """One ConvLSTM cell's weights: for each conv a [3, 3, Cin, Cout] HWIO
    kernel and a [Cout] bias.  Built by ``compat/jax_params.py::clstm_from_params``.

    Serving (``trainable=False``) holds them as buffers in the compute dtype
    (the dtype the convs run in).  Training (``trainable=True``) holds f32
    ``nn.Parameter`` master weights; :meth:`weights` casts them to the
    compute dtype, once per rollout, and the convs' gradients flow back to
    the masters through :func:`ops.cube_conv.cube_conv3x3_train`.
    """

    def __init__(self, convs: dict, compute_dtype: torch.dtype,
                 use_cube_pad: bool = True, conv_impl: str = "xla",
                 trainable: bool = False):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"clstm_conv_impl must be one of {CONV_IMPLS}, got {conv_impl!r}")
        self.compute_dtype = compute_dtype
        self.use_cube_pad = use_cube_pad
        self.model_group = None  # tensor parallelism: see shard_over
        self.n_model = 1
        for name in CONV_NAMES:
            for key in ("w", "b"):
                if trainable:
                    t = nn.Parameter(convs[name][key].float().contiguous())
                    self.register_parameter(f"{name}_{key}", t)
                else:
                    t = convs[name][key].to(compute_dtype).contiguous()
                    self.register_buffer(f"{name}_{key}", t)

    @property
    def hidden_size(self) -> int:
        return self.gates_w.shape[3] * self.n_model // 4

    def shard_over(self, group, n_model: int) -> "ConvLSTM":
        """Mark the held weights as this rank's output-channel shard of a
        model group of ``n_model`` ranks (``parallel/mesh.py::
        shard_clstm_params`` made them): each conv's output is gathered
        along channels, and its input gradient summed over the group."""
        self.model_group, self.n_model = group, n_model
        return self

    def weights(self) -> Dict[str, Tuple[torch.Tensor, ...]]:
        """name -> (w, b, wc, bc): the held weights and their compute-dtype
        forms (the same tensors when they are held in that dtype already,
        one cast each otherwise).  Call once per rollout, not per conv."""
        out = {}
        for name in CONV_NAMES:
            w, b = getattr(self, f"{name}_w"), getattr(self, f"{name}_b")
            out[name] = (w, b, w.to(self.compute_dtype), b.to(self.compute_dtype))
        return out

    def conv(self, name: str, x: torch.Tensor, weights: dict) -> torch.Tensor:
        """One cube-padded 3x3 conv on face-flattened [B*6, h, w, C] input,
        with ``weights`` from :meth:`weights`."""
        w, b, wc, bc = weights[name]
        if self.model_group is not None:
            x = pmesh.reduce_grad(x, self.model_group)
        if self.use_cube_pad:  # the kernel's wrapper rejects non-square faces
            x6 = x.reshape(-1, 6, *x.shape[1:]).to(self.compute_dtype).contiguous()
            out = cube_conv.cube_conv3x3_train(x6, w, b, wc, bc)
            out = out.reshape(-1, *out.shape[2:])
        else:
            x6 = zero_pad(x.reshape(-1, 6, *x.shape[1:]), 1)
            # the bias stays in its held dtype and adds after the conv, as
            # cp360_tpu/models/layers.py::conv2d adds it
            out = layers.conv2d(x6.reshape(-1, *x6.shape[2:]), wc, b,
                                compute_dtype=self.compute_dtype)
        if self.model_group is not None:
            out = pmesh.gather_channels(out, self.model_group)
        return out


def clstm_step(cell: ConvLSTM, x: torch.Tensor,
               state: Tuple[torch.Tensor, torch.Tensor],
               weights: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ConvLSTM step.

    Args:
      x: [B*6, H, W, Cin] input cube faces (face-flattened batch).
      state: (hidden, cell), each [B*6, H, W, Ch].
      weights: ``cell.weights()``, made once per rollout by the caller.

    Returns new (hidden, cell).  In bf16 the gates are bf16 and the state
    takes the dtype of ``state`` (f32 from a f32 seed), as in JAX.
    """
    h, c = state
    z = torch.cat([x, h], dim=-1)
    out = torch.relu(cell.conv("conv1", z, weights))
    out = torch.relu(cell.conv("conv2", out, weights))
    gates = cell.conv("gates", out, weights)

    i_g, f_g, o_g, c_g = torch.chunk(gates, 4, dim=-1)
    i_g = torch.sigmoid(i_g)
    f_g = torch.sigmoid(f_g)
    o_g = torch.sigmoid(o_g)
    c_g = torch.tanh(c_g)

    new_c = f_g * c + i_g * c_g
    new_h = o_g * torch.tanh(new_c)
    return new_h, new_c


def clstm_rollout(cell: ConvLSTM, seq: torch.Tensor, h0: torch.Tensor,
                  c0: torch.Tensor, remat: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the cell over time.

    Args:
      seq: [T, B*6, H, W, Cin].
      h0, c0: [B*6, H, W, Ch] initial state (the protocol seeds both with
        the normalized first frame, temporal_model/test_temporal.py:70-73).
      remat: recompute each step's intermediates in the backward pass
        (``torch.utils.checkpoint`` per step, config ``train_remat``), as
        ``jax.checkpoint`` does in ``cp360_tpu/models/clstm.py:140-141``.

    Returns (hiddens [T, B*6, H, W, Ch], final hidden, final cell).
    """
    weights = cell.weights()  # one cast of each weight per rollout
    h, c = h0, c0
    hs = []
    for x in seq:
        if remat:
            h, c = checkpoint(clstm_step, cell, x, (h, c), weights, use_reentrant=False)
        else:
            h, c = clstm_step(cell, x, (h, c), weights)
        hs.append(h)
    return torch.stack(hs), h, c
