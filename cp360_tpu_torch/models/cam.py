"""Class Activation Mapping head (``cp360_tpu/models/cam.py:20-74``).

The reference (static_model/class_activation_model.py:13-85) captures
layer4 through a forward hook and multiplies it on the host with the
non-negative shifted classifier weight per face.  Here the backbone returns
its feature map and the score cube is one f32 matmul on the device.

Every backbone family takes this one path, as the JAX package's
``_backbone_cam`` dispatch does (``cp360_tpu/pipelines/extract.py:84-101``):
a ``Backbone`` is any of ``models.resnet.ResNet``, ``models.vgg.VGG16``,
``models.mobilenet.MobileNetV2`` and ``models.convnext.ConvNeXt`` (a family
the JAX package does not have), whose ``forward(x, with_logits=False)``
returns the CAM feature map and whose ``cam_w`` is its classifier weight.

On a CUDA input with autograd off, :func:`cam_forward` replays a CUDA graph
of the whole forward, captured once per input shape (:class:`CamGraphs`):
a backbone launches several hundred small kernels a batch, and one graph
launch takes the place of their host-side launches.  The kernels, and so
the results, are those of the eager forward.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Union

import torch

from cp360_tpu_torch.models.convnext import ConvNeXt
from cp360_tpu_torch.models.mobilenet import MobileNetV2
from cp360_tpu_torch.models.resnet import ResNet
from cp360_tpu_torch.models.vgg import VGG16
from cp360_tpu_torch.ops import conv_epilogue, cube_dwconv, cube_pool
from cp360_tpu_torch.utils.profiling import count

Backbone = Union[ResNet, VGG16, MobileNetV2, ConvNeXt]

MAX_GRAPHS = 8  # captured input shapes a model keeps; the least recently used goes first
# the kernels in a forward whose module-level ``launches`` a capture records
# and each replay adds (the capture itself launches nothing)
COUNTED = (cube_pool, conv_epilogue, cube_dwconv)


def shift_weight_nonneg(fc_w: torch.Tensor) -> torch.Tensor:
    """Shift the classifier weight so its minimum is >= 0.

    Reference: class_activation_model.py:51-52 — applied only when the min
    is negative, which the unconditional `w - min(min, 0)` reproduces.
    """
    return fc_w - torch.clamp(fc_w.min(), max=0.0)


def cam_scores(feats: torch.Tensor, fc_w: torch.Tensor) -> torch.Tensor:
    """Per-face class score maps.

    Args:
      feats: [B, h, w, C] layer4 features (B = N*6 faces).
      fc_w: [C, num_classes] classifier weight.

    Returns [B, h, w, num_classes] f32 score maps.
    """
    w = shift_weight_nonneg(fc_w.float())
    return torch.matmul(feats.float(), w)


def cam_forward(model: Backbone, cubes: torch.Tensor):
    """Cube faces -> (score cube, features).

    Args:
      cubes: [N, 6, H, W, 3] normalized cube faces.

    Returns:
      scores: [N, 6, h, w, num_classes] CAM score cube (f32).
      feats:  [N, 6, h, w, C] the backbone's CAM features.

    A CUDA input with autograd off, on a stream that is not capturing, is
    served by the model's graph for its shape (:class:`CamGraphs`); the
    returned tensors are the caller's own.  Any other input runs eagerly.
    """
    if replayable(cubes):
        return graphs_of(model).run(model, cubes)
    return cam_forward_eager(model, cubes)


def cam_forward_eager(model: Backbone, cubes: torch.Tensor):
    """:func:`cam_forward` launched op by op: what a graph captures."""
    n = cubes.shape[0]
    _, feats = model(cubes, with_logits=False)
    scores = cam_scores(feats, model.cam_w)
    h, w = feats.shape[1:3]
    return scores.reshape(n, 6, h, w, -1), feats.reshape(n, 6, h, w, -1)


def replayable(x) -> bool:
    """Whether :func:`cam_forward` serves ``x`` from a graph: a CUDA tensor,
    autograd off (a graph records no backward), and the current stream not
    capturing already (a caller's own capture records the eager ops)."""
    return x.is_cuda and not torch.is_grad_enabled() and not _capturing(x.device)


def _capturing(device) -> bool:
    with torch.cuda.device(device):
        return torch.cuda.is_current_stream_capturing()


def graphs_of(model: Backbone) -> "CamGraphs":
    """The model's :class:`CamGraphs`, made at its first use.  It lives on
    the model, so it goes with it; a copy of the model (each replica of
    ``parallel/mesh.py::LocalReplicas``) starts with none captured."""
    graphs = vars(model).get("_cam_graphs")
    if graphs is None:
        graphs = vars(model).setdefault("_cam_graphs", CamGraphs())
    return graphs


def _registered(model) -> list:
    """(dict, name, value, data pointer) of every buffer, parameter and
    submodule of the model's modules: where a capture reads its weights
    from.  A parameter keeps its object when ``.to()`` moves its data, so
    its data pointer is kept too."""
    out = []
    for m in model.modules():
        out += [(m._buffers, k, v, None) for k, v in m._buffers.items()]
        out += [(m._parameters, k, v, None if v is None else v.data_ptr())
                for k, v in m._parameters.items()]
        out += [(m._modules, k, v, None) for k, v in m._modules.items()]
    return out


class CamGraphs:
    """One model's captured forwards, keyed by the input's (shape, dtype,
    device), at most :data:`MAX_GRAPHS` of them, the least recently used
    dropped first.

    ``capture(model, x, shared)`` returns ``(entry, outputs)``: an object
    whose ``replay(x)`` gives the outputs for a later input of the same
    key, and the outputs for ``x`` itself; ``shared`` is a dict that the
    captures on ``x``'s device share (their memory pool).  One lock runs
    the model's captures and replays one at a time: its graphs share that
    pool, whose temporaries a replay overwrites.  The graphs read the
    weights where they were at capture, so a weight changed in place shows
    in the next replay; when the model holds another tensor or submodule
    under any name (after ``.to()``, a reassigned buffer) every graph is
    dropped and captured again.

    Counters (``utils/profiling.py::count``): ``stage1.graph_frames``, the
    frames a replay served; ``stage1.graph_captures``, the captures.
    """

    def __init__(self, capture=None):
        self._capture = capture or _capture
        self._entries: OrderedDict = OrderedDict()
        self._tensors = None  # _registered(model) when the entries were captured
        self._shared: dict = {}  # device -> what its captures share
        self._lock = threading.Lock()

    def __reduce__(self):  # a copy of the model starts with no graph
        return type(self), (self._capture,)

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> list:
        """The keys held, least recently used first."""
        with self._lock:
            return list(self._entries)

    def run(self, model, x):
        key = (tuple(x.shape), x.dtype, x.device)
        with self._lock:
            if self._tensors is None or not all(
                    d.get(k) is v and (p is None or v.data_ptr() == p)
                    for d, k, v, p in self._tensors):
                self._entries.clear()
                self._tensors = _registered(model)
            entry = self._entries.pop(key, None)
            if entry is None:
                entry, outs = self._capture(model, x, self._shared.setdefault(x.device, {}))
                count("stage1.graph_captures", 1)
            else:
                outs = entry.replay(x)
                count("stage1.graph_frames", x.shape[0])
            self._entries[key] = entry
            while len(self._entries) > MAX_GRAPHS:
                self._entries.popitem(last=False)
            return outs


class _Graph:
    """One captured forward: the graph, its static input and outputs, the
    event after the model's last replay on the device (shared by the
    model's graphs there), and the launches of each of :data:`COUNTED`'s
    kernels it holds."""

    def __init__(self, graph, static_in, outs, done, launches: tuple):
        self.graph, self.static_in, self.outs = graph, static_in, outs
        self.done, self.launches = done, launches

    def replay(self, x):
        """Copy ``x`` in, replay, and return clones of the outputs on the
        current stream, after the model's last replay on any stream."""
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device)
            stream.wait_event(self.done)
            self.static_in.copy_(x)
            self.graph.replay()
            outs = tuple(t.clone() for t in self.outs)
            self.done.record(stream)
        for ops, n in zip(COUNTED, self.launches):
            ops.launches += n
        return outs


def _capture(model, x, shared: dict):
    """Run the eager forward on a side stream (it fills the cube pad's
    index tables, lets cuDNN pick its plans and builds the kernels; its outputs
    answer this call), then capture it on the same stream into the pool
    the model's graphs on ``x``'s device share.  Host work inside the
    captured region would break it: the forward's index tables are made by
    the eager run, and the caller's normalisation stays outside."""
    dev = x.device
    with torch.cuda.device(dev):
        if not shared:
            shared.update(pool=torch.cuda.graph_pool_handle(), done=torch.cuda.Event())
        caller = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            outs = cam_forward_eager(model, x)
        caller.wait_stream(side)
        for t in outs:
            t.record_stream(caller)
        static_in = torch.empty(x.shape, dtype=x.dtype, device=dev)
        before = [ops.launches for ops in COUNTED]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=shared["pool"], stream=side,
                              capture_error_mode="thread_local"):
            static_outs = cam_forward_eager(model, static_in)
        launches = tuple(ops.launches - b for ops, b in zip(COUNTED, before))
        for ops, n in zip(COUNTED, launches):
            ops.launches -= n  # the capture launched nothing
    return _Graph(graph, static_in, static_outs, shared["done"], launches), outs
