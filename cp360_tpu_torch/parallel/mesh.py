"""Scale-out: the process grid, batch rows, tensor-parallel convs, local replicas.

The port of ``cp360_tpu/parallel/mesh.py``.  JAX scales out with one
controller over a (data, model) device mesh and lets GSPMD insert the
collectives.  The port runs one process (rank) per card under
``torch.distributed`` and issues the collectives itself:

- :func:`maybe_init_distributed` joins the job when ``CP360_DIST`` is set
  (the launcher, ``cli/launch.py``, sets it), on ``nccl`` for CUDA tensors
  and ``gloo`` for host tensors; ``CP360_DIST_BACKEND=gloo`` puts every
  collective on gloo, so several ranks can share one card (a rehearsal:
  NCCL refuses two ranks on one device).
- :class:`ProcessGrid` is the (data x model) grid of ranks that training
  runs on: rank r sits at data index r // mesh_model and model index
  r % mesh_model, as ``make_mesh`` lays devices out, and each axis has its
  own subgroup.  Data parallelism all-reduces the gradients over the data
  group (the losses are sums, so the sum of the ranks' gradients is the
  gradient of the global batch); tensor parallelism splits every ConvLSTM
  conv's output channels over the model group (:func:`shard_clstm_params`,
  the layout of ``clstm_param_sharding``) and gathers the activations
  (:func:`gather_channels`).
- :class:`LocalReplicas` is the single-process form of a data mesh over
  local devices (``local_data_mesh`` and the server's mesh): one copy of a
  model per device, each batch split into equal row blocks.
- :func:`stripe_jobs` deals independent jobs (videos) round-robin to ranks.

Under the gloo backend a collective on a CUDA tensor stages the tensor
through host memory (explicitly, here and nowhere else); NCCL takes CUDA
tensors as they are.
"""

from __future__ import annotations

import atexit
import copy
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

LAUNCH_HINT = "python -m cp360_tpu_torch.cli.launch --nprocs {n} -- ..."

_state: dict = {"backend": None, "local_rank": 0}


# ---- joining the job ----------------------------------------------------------


def dist_requested() -> bool:
    """Whether ``CP360_DIST`` asks this process to join a multi-process job."""
    return os.environ.get("CP360_DIST", "").lower() in ("1", "true")


def env_process_count() -> int:
    """The job's process count from the environment, before any init."""
    for key in ("CP360_NUM_PROCESSES", "WORLD_SIZE", "SLURM_NTASKS"):
        if os.environ.get(key):
            return int(os.environ[key])
    return 1


def choose_backend(device_type: str) -> str:
    """``nccl`` for CUDA tensors (host tensors on gloo) on the card, ``gloo``
    on the CPU; ``CP360_DIST_BACKEND=gloo`` puts everything on gloo."""
    override = os.environ.get("CP360_DIST_BACKEND", "").strip().lower()
    if override not in ("", "gloo"):
        raise ValueError(f"CP360_DIST_BACKEND={override!r}: the one override is 'gloo' "
                         "(ranks sharing a card); unset it for nccl on the card")
    if device_type == "cpu" or override == "gloo":
        return "gloo"
    if not dist.is_nccl_available():
        raise RuntimeError("this torch has no NCCL: set CP360_DIST_BACKEND=gloo to run the "
                           "job's collectives on gloo, or run on the CPU (--device cpu)")
    return "cpu:gloo,cuda:nccl"


def maybe_init_distributed(device="cuda", log_fn=print) -> bool:
    """Env-gated multi-process initialisation.

    ``CP360_DIST=1`` plus ``CP360_COORDINATOR`` (host:port of rank 0),
    ``CP360_NUM_PROCESSES`` and ``CP360_PROCESS_ID`` rendezvous over TCP;
    with none of the three, ``env://`` takes torchrun's variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; SLURM's
    ``SLURM_PROCID``/``SLURM_NTASKS``/``SLURM_LOCALID`` fill the last ones).
    The rank's card is ``cuda:(local_rank % device_count)``, the local rank
    from ``CP360_LOCAL_RANK`` (the launcher), ``LOCAL_RANK`` or
    ``SLURM_LOCALID``.  Unset, this is a no-op and everything stays one
    process.  Called once per process; later calls are no-ops.
    """
    if not dist_requested():
        return False
    if dist.is_initialized():
        return True
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    backend = choose_backend(device.type)
    coord = os.environ.get("CP360_COORDINATOR")
    nproc = os.environ.get("CP360_NUM_PROCESSES")
    pid = os.environ.get("CP360_PROCESS_ID")
    if coord or nproc or pid:  # explicit rendezvous; else torchrun/SLURM env://
        if not (coord and nproc and pid is not None):
            raise SystemExit(
                "CP360_DIST explicit rendezvous needs ALL of CP360_COORDINATOR, "
                "CP360_NUM_PROCESSES and CP360_PROCESS_ID (or none, to use the "
                "env:// variables of torchrun or SLURM)")
        world, rank = int(nproc), int(pid)
        init = f"tcp://{coord}"
    else:
        for ours, slurm in (("RANK", "SLURM_PROCID"), ("WORLD_SIZE", "SLURM_NTASKS"),
                            ("LOCAL_RANK", "SLURM_LOCALID")):
            if ours not in os.environ and slurm in os.environ:
                os.environ[ours] = os.environ[slurm]
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        init = "env://"
    local = int(os.environ.get("CP360_LOCAL_RANK", os.environ.get(
        "LOCAL_RANK", os.environ.get("SLURM_LOCALID", rank))))
    _state.update(backend=backend, local_rank=local)
    card = None
    if device.type == "cuda":
        card = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    atexit.register(dist.destroy_process_group)
    log_fn(f"torch.distributed initialized: process {rank}/{world}, backend {backend}, "
           f"device {card or 'cpu'}")
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device) -> torch.device:
    """This rank's device: its own card (``cuda:(local_rank % count)``)
    in a multi-process job on the card, else ``device`` itself."""
    device = torch.device(device)
    if device.type == "cuda" and dist.is_initialized() and device.index is None:
        return torch.device("cuda", _state["local_rank"] % torch.cuda.device_count())
    return device


def stripe_jobs(jobs) -> list:
    """Round-robin independent jobs (videos) across processes: rank r takes
    every world_size-th job starting at r.  One process: the list as is."""
    if process_count() <= 1:
        return list(jobs)
    return list(jobs)[process_index()::process_count()]


# ---- host collectives (the same on every backend) ------------------------------


def host_barrier() -> None:
    """Every rank waits here; a host tensor's all-reduce, so it runs on gloo
    whatever the device backend is, and orders files, not tensors."""
    if process_count() > 1:
        dist.all_reduce(torch.zeros(1))


def global_any(flag: bool) -> bool:
    """Whether any rank's flag is set; every rank must call it at the same
    point (a preemption signal landing on one rank a step early would
    otherwise have the ranks issue mismatched collectives)."""
    if process_count() <= 1:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0])
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item() > 0)


# ---- device collectives, staged through the host under gloo -------------------


def _staged(t: torch.Tensor) -> bool:
    return t.is_cuda and "nccl" not in (_state["backend"] or "")


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over ``group``."""
    if _staged(t):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host, non_blocking=False)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group=None, dim: int = -1) -> torch.Tensor:
    """The ranks' tensors of ``group`` concatenated along ``dim``, in rank order."""
    n = dist.get_world_size(group)
    src = t.contiguous().cpu() if _staged(t) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if _staged(t) else out


class _GatherChannels(torch.autograd.Function):
    """Forward: all-gather along the last dim.  Backward: this rank's slice
    of the output gradient, with no collective: everything downstream of the
    gather runs replicated on the model group, so every rank holds the same,
    whole output gradient.  (``torch.distributed.nn.functional.all_gather``
    sums the ranks' output gradients instead, which is right only when each
    rank holds a partial one, and would count a replicated gradient n times.)"""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.width = x.shape[-1]
        return all_gather_cat(x, group, dim=-1)

    @staticmethod
    def backward(ctx, dy):
        r = dist.get_rank(ctx.group)
        return dy[..., r * ctx.width:(r + 1) * ctx.width].contiguous(), None


class _ReduceGrad(torch.autograd.Function):
    """Forward: identity.  Backward: the sum of the ranks' input gradients
    over the model group (each rank's conv sees only its output channels, so
    its input gradient is a partial sum), summed in f32 and rounded once to
    the gradient's dtype, as the whole conv's kernel accumulates."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        total = all_reduce_(dx.float().contiguous(), ctx.group)  # .float() copies bf16
        return total.to(dx.dtype), None


def gather_channels(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherChannels.apply(x, group)


def reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceGrad.apply(x, group)


# ---- the (data x model) grid for training -------------------------------------


class ProcessGrid:
    """The (data x model) grid of ranks, one rank per card.

    Rank r sits at (r // n_model, r % n_model).  ``data_group`` holds the
    ranks at this rank's model index (they all-reduce gradients),
    ``model_group`` the ranks at its data index (they split the conv
    channels).  Every rank builds every subgroup, in one order, as
    ``new_group`` requires.
    """

    def __init__(self, n_data: int, n_model: int):
        world = process_count()
        if n_data * n_model != world:
            if world == 1:
                raise ValueError(
                    f"mesh {n_data}x{n_model} needs {n_data * n_model} ranks (one per card), "
                    f"but this is one process: start it with "
                    f"`{LAUNCH_HINT.format(n=n_data * n_model)}`")
            raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} ranks, "
                             f"the job has {world}")
        self.n_data, self.n_model = n_data, n_model
        rank = process_index()
        self.data_index, self.model_index = divmod(rank, n_model)
        self.data_group = self.model_group = None
        for j in range(n_model):
            g = dist.new_group([i * n_model + j for i in range(n_data)])
            if j == self.model_index:
                self.data_group = g
        for i in range(n_data):
            g = dist.new_group([i * n_model + j for j in range(n_model)])
            if i == self.data_index:
                self.model_group = g

    def __repr__(self) -> str:
        return (f"ProcessGrid({self.n_data}x{self.n_model}, rank {process_index()} at "
                f"({self.data_index}, {self.model_index}))")


def grid_from_config(cfg) -> Optional[ProcessGrid]:
    """The grid of the ``mesh_data``/``mesh_model`` config keys; None for
    1x1, so callers keep the one-card path."""
    if cfg.mesh_data * cfg.mesh_model <= 1:
        return None
    return ProcessGrid(cfg.mesh_data, cfg.mesh_model)


def local_rows_slice(grid: ProcessGrid, n_rows: int) -> slice:
    """The contiguous [lo, hi) span of a global batch of ``n_rows`` that
    this rank's data index computes on (ranks of one model group share it).
    A loader reads only these rows (``PrefetchLoader(rows=...)``) and the
    train loop takes them as they are (:func:`shard_batch_per_host`)."""
    if n_rows % grid.n_data:
        raise ValueError(
            f"batch dim {n_rows} not divisible by the mesh data axis ({grid.n_data} "
            f"devices); pick batch_size as a multiple of mesh_data")
    per = n_rows // grid.n_data
    return slice(grid.data_index * per, (grid.data_index + 1) * per)


def _rows(leaf, sl: slice):
    from cp360_tpu_torch.ops.quantize import Quantized

    if isinstance(leaf, Quantized):
        return Quantized(leaf.q[sl], leaf.scales[sl])
    return leaf[sl]


def shard_batch(grid: ProcessGrid, batch):
    """This rank's rows of the FULL global batch (an array, a
    :class:`~cp360_tpu_torch.ops.quantize.Quantized` pair, or a tuple of
    them): every rank passes the identical global batch."""
    if isinstance(batch, tuple) and not hasattr(batch, "q"):
        return tuple(shard_batch(grid, b) for b in batch)
    n = (batch.q if hasattr(batch, "q") else batch).shape[0]
    return _rows(batch, local_rows_slice(grid, n))


def shard_batch_per_host(grid: ProcessGrid, batch):
    """A batch that holds this rank's rows already (a per-host loader's).

    CONTRACT WARNING: do not pass per-host rows to :func:`shard_batch` -- it
    expects the FULL global batch on every rank and would slice your local
    rows again whenever their count happens to divide the data axis.
    Per-host loaders come here, where the rows pass as they are.
    """
    return batch


def shard_clstm_params(params: dict, n_model: int, model_index: int) -> dict:
    """The tensor-parallel shard of a ConvLSTM param tree (numpy leaves):
    every conv's HWIO output channels and its bias split contiguously over
    the model axis (``clstm_param_sharding``); inputs stay whole."""
    out = {}
    for name, leaf in params.items():
        cout = leaf["w"].shape[-1]
        if cout % n_model:
            raise ValueError(f"{name}: {cout} output channels do not split over "
                             f"mesh_model={n_model}")
        per = cout // n_model
        sl = slice(model_index * per, (model_index + 1) * per)
        out[name] = {"w": np.ascontiguousarray(np.asarray(leaf["w"])[..., sl]),
                     "b": np.ascontiguousarray(np.asarray(leaf["b"])[sl])}
    return out


# ---- replicas on local devices (one process) ------------------------------------


def local_devices(device, n: int) -> List[torch.device]:
    """The first ``n`` local devices of ``device``'s kind: cards
    ``cuda:0..n-1`` (raising when fewer exist), or on the CPU ``n`` times
    the CPU, whose one device runs any number of replicas (the port's
    counterpart of the JAX package's virtual CPU devices)."""
    device = torch.device(device)
    if device.type == "cpu":
        return [torch.device("cpu")] * n
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f"mesh {n}x1 needs {n} devices, only {have} available")
    return [torch.device("cuda", i) for i in range(n)]


def check_divisible(n: int, n_devices: int, what: str, why: str) -> None:
    """The JAX package's refusal of a batch that ``n_devices`` replicas
    cannot split evenly (``what`` names it, e.g. ``batch_frames=8``)."""
    if n % n_devices:
        raise ValueError(f"{what} must be divisible by the mesh data axis "
                         f"({n_devices} devices) {why}")


def _module_device(module: torch.nn.Module) -> torch.device:
    return next(iter([*module.buffers(), *module.parameters()])).device


def _key(d: torch.device):
    return ("cpu", 0) if d.type == "cpu" else (d.type, d.index or 0)


class LocalReplicas:
    """One copy of a model on each of N local devices, each batch split
    into N equal row blocks.

    ``devices`` may name one device more than once (every entry is a
    replica; entries on one device share one copy).  :meth:`run` issues
    every block's work before it waits on any, and concatenates the blocks'
    results on the first device.
    """

    def __init__(self, model: torch.nn.Module, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("LocalReplicas needs at least one device")
        for d in self.devices:
            if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
                raise ValueError(f"mesh {len(self.devices)}x1 names {d}, only "
                                 f"{torch.cuda.device_count()} device(s) available")
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"replica devices are cuda or cpu, got {d}")
        copies = {_key(_module_device(model)): model}
        for d in self.devices:
            if _key(d) not in copies:
                copies[_key(d)] = copy.deepcopy(model).to(d)
        self.models = [copies[_key(d)] for d in self.devices]

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def run(self, fn: Callable, split: Sequence[torch.Tensor] = (),
            shared: Sequence[torch.Tensor] = ()):
        """``fn(model_i, *shared, *split_i)`` on every replica i, where
        ``split_i`` is row block i of each ``split`` tensor and ``shared``
        goes whole to every device.  Returns the results (a tensor or a
        tuple of tensors) concatenated along dim 0 on the first device."""
        n = len(self)
        rows = {t.shape[0] for t in split}
        if len(rows) != 1:
            raise ValueError(f"the split tensors need one row count, got {sorted(rows)}")
        total = rows.pop()
        if total % n:
            raise ValueError(f"batch dim {total} not divisible by the mesh data axis "
                             f"({n} devices)")
        per = total // n
        shared_on: dict = {}
        outs = []
        for i, (d, model) in enumerate(zip(self.devices, self.models)):
            if _key(d) not in shared_on:
                shared_on[_key(d)] = [t.to(d, non_blocking=True) for t in shared]
            blocks = [t[i * per:(i + 1) * per].to(d, non_blocking=True) for t in split]
            outs.append(fn(model, *shared_on[_key(d)], *blocks))
        first = self.devices[0]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([o[k].to(first, non_blocking=True) for o in outs])
                         for k in range(len(outs[0])))
        return torch.cat([o.to(first, non_blocking=True) for o in outs])
