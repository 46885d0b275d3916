"""Temporal-model training on one GPU: the train step, Adam, checkpoints.

The port of ``cp360_tpu/train/loop.py`` (reference training script
temporal_model/train_temporal.py:33-193).  One step normalizes each window,
rolls the ConvLSTM over it (every cube-padded conv forward is the K1
kernel, every input gradient the dx kernel, ops/cube_conv.py), projects the
last 4 hidden states to equirectangular maps, takes the three weak
supervision losses (train/losses.py), back-propagates and applies Adam.

Weights live as f32 ``nn.Parameter`` masters in a trainable
``models.clstm.ConvLSTM``; the rollout casts them to ``compute_dtype`` once
per step.  The optimizer is ``torch.optim.Adam`` with optax's defaults,
optionally behind a global-norm clip written as optax's
``clip_by_global_norm`` and under an optax-indexed learning-rate schedule.
Checkpoints are the JAX package's flat ``.npz`` trees, with its naming
scheme CLSTM_{epoch:02}_{iter:06} (train_temporal.py:182-185), and the full
train state keeps optax's leaf order.

A batch may come as contiguous frame runs (``segment_windows`` > 1,
re-windowed on the device by :func:`expand_segments`) and its CAM windows
int8 (``transfer_codec: int8``, dequantized on the device first).  With
``eval_every_epochs`` > 0 the epoch loop scores the weights on validation
artifacts (train/validate.py), keeps ``best.npz`` and stops early after
``eval_patience`` passes without a better AUC; ``profile_dir`` writes a
``torch.profiler`` trace of the epoch loop.

Scale-out (``parallel/``): ``pipeline_stages`` > 1 pipelines the rollout
over a device list (``parallel/pipeline.py``); ``mesh_data`` x
``mesh_model`` > 1 trains on a grid of ranks, one per card
(``parallel/mesh.py::ProcessGrid``): each rank takes its rows of the
global batch, the gradients are summed over the data group, and under
tensor parallelism each rank holds a slice of every conv's output channels
(the Adam moments stay sliced too).  Rank 0 alone writes the metrics, the
``.npz`` files (after gathering the slices) and prunes; the ``orbax``
backend writes a sharded ``torch.distributed.checkpoint`` directory from
every rank (train/checkpoint.py).
"""

from __future__ import annotations

import json
import math
import os
import re
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from cp360_tpu_torch.compat.jax_params import (
    clstm_from_params, init_clstm_params, save_npz)
from cp360_tpu_torch.config import Config
from cp360_tpu_torch.models.clstm import CONV_NAMES, ConvLSTM, clstm_rollout
from cp360_tpu_torch.ops.quantize import Quantized, maybe_dequantize
from cp360_tpu_torch.ops.resample import cube_to_equi
from cp360_tpu_torch.parallel import mesh as pmesh
from cp360_tpu_torch.parallel.pipeline import make_pipe_devices, pipelined_rollout
from cp360_tpu_torch.train import losses as L

TMP_LOSS_LEN = 3  # pairs of consecutive predictions entering the losses
PARTS = ("smooth", "temporal", "mask")
# params/{i} and the Adam moments in jax.tree.flatten order (sorted keys)
PARAM_ORDER = tuple((name, key) for name in sorted(CONV_NAMES) for key in ("b", "w"))


def check_config(cfg: Config) -> None:
    """Raise on training options the step cannot run."""
    if cfg.pipeline_stages > 1:
        # the losses consume the trailing TMP_LOSS_LEN+1 hidden steps and the
        # pipelined rollout returns only the last T/P chunk
        t, p = cfg.seq_len, cfg.pipeline_stages
        if t % p or t // p < TMP_LOSS_LEN + 1:
            raise ValueError(
                f"pipeline_stages={p} needs seq_len divisible by it with "
                f"seq_len/stages >= {TMP_LOSS_LEN + 1} (losses consume the "
                f"trailing {TMP_LOSS_LEN + 1} steps of the last pipe chunk); "
                f"seq_len={t} cannot pipeline — the published seq_len=5 "
                f"protocol trains dp/tp (see PARITY.md walls)")
    if cfg.checkpoint_backend not in ("npz", "orbax"):
        raise ValueError(f"unknown checkpoint_backend {cfg.checkpoint_backend!r} (npz | orbax)")
    if cfg.transfer_codec not in ("none", "int8"):
        raise ValueError(f"transfer_codec={cfg.transfer_codec!r} is not one of 'none', 'int8'")
    if cfg.segment_windows < 1:
        raise ValueError(f"segment_windows must be >= 1, got {cfg.segment_windows}")


# ---- learning rate and optimizer ---------------------------------------------


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: constant ``init`` when steps <= 0."""
    if steps <= 0:
        return lambda count: init

    def sched(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return sched


def _join(first: Callable, second: Callable, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules with one boundary."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def lr_schedule_from_config(cfg: Config) -> Union[float, Callable[[int], float]]:
    """``lr`` (the reference's constant) or a schedule count -> lr with
    optax's step indexing: count is the number of updates applied so far,
    so the first update uses schedule(0)."""
    warm = cfg.lr_warmup_steps
    if cfg.lr_schedule == "constant":
        if warm <= 0:
            return cfg.lr
        return _join(_linear(0.0, cfg.lr, warm), lambda count: cfg.lr, warm)
    if cfg.lr_total_steps <= 0:
        raise ValueError(f"lr_schedule={cfg.lr_schedule!r} needs lr_total_steps > 0")
    if cfg.lr_schedule == "cosine":
        decay = cfg.lr_total_steps - warm
        if decay <= 0:
            raise ValueError(f"the cosine schedule needs lr_total_steps > lr_warmup_steps, "
                             f"got {cfg.lr_total_steps}, {warm}")

        def cosine(count):
            count = min(count, decay)
            return cfg.lr * (0.5 * (1 + math.cos(math.pi * count / decay)))

        return _join(_linear(0.0, cfg.lr, warm), cosine, warm)
    if cfg.lr_schedule == "linear":
        decay = max(1, cfg.lr_total_steps - warm)
        return _join(_linear(0.0, cfg.lr, warm), _linear(cfg.lr, 0.0, decay), warm)
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


def make_optimizer(cfg: Config, model: ConvLSTM) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8; the
    reference's bare Adam(lr), train_temporal.py:256).  The train step sets
    each update's learning rate from :func:`lr_schedule_from_config` and
    clips the gradients first when ``grad_clip_norm > 0``."""
    lr = lr_schedule_from_config(cfg)
    return torch.optim.Adam(model.parameters(), lr=lr if not callable(lr) else lr(0),
                            betas=(0.9, 0.999), eps=1e-8)


def clip_by_global_norm_(grads, max_norm: float, group=None) -> None:
    """optax.clip_by_global_norm in place: when the global norm g is not
    below ``max_norm`` each gradient becomes (grad / g) * max_norm.  (Not
    ``clip_grad_norm_``, which divides by g + 1e-6.)  ``group``: the model
    group whose ranks hold disjoint slices of the gradients; their squared
    norms are summed first."""
    sq = sum(torch.sum(g * g) for g in grads)
    if group is not None:
        sq = pmesh.all_reduce_(sq.reshape(1), group)[0]
    g_norm = torch.sqrt(sq)
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / g_norm) * max_norm))


def update_count(optimizer: torch.optim.Adam) -> int:
    """Updates applied so far (optax's ``count``)."""
    for p in optimizer.param_groups[0]["params"]:
        state = optimizer.state.get(p)
        if state and "step" in state:
            return int(state["step"])
    return 0


# ---- the train step -----------------------------------------------------------


def trainable_clstm(cfg: Config, params: dict, device, grid=None) -> ConvLSTM:
    """The ConvLSTM to train: f32 masters on ``device`` from a param tree
    (under tensor parallelism, this rank's slice of it)."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    if grid is not None and grid.n_model > 1:
        params = pmesh.shard_clstm_params(params, grid.n_model, grid.model_index)
    model = clstm_from_params(params, dtype, cfg.cube_pad, cfg.clstm_conv_impl,
                              device=device, trainable=True)
    if grid is not None and grid.n_model > 1:
        model.shard_over(grid.model_group, grid.n_model)
    return model


def host_params(model: ConvLSTM) -> dict:
    """The whole param tree of a possibly sliced model, as
    ``clstm_to_params`` gives it (f32 numpy copies): a collective over the
    model group under tensor parallelism (every rank calls it)."""
    return {name: {key: _whole(getattr(model, f"{name}_{key}").detach(), model)
                   for key in ("w", "b")} for name in CONV_NAMES}


def _whole(t: torch.Tensor, model: ConvLSTM) -> np.ndarray:
    """A host copy of a leaf, its slices gathered under tensor parallelism."""
    if model.model_group is not None:
        t = pmesh.all_gather_cat(t, model.model_group, dim=-1)
    return t.to("cpu", torch.float32, copy=True).numpy()


def predictions_from_hiddens(hiddens: torch.Tensor, batch: int) -> torch.Tensor:
    """Last K+1 hidden states -> channel-maxed equi maps [K+1, B, 2h, 4w]
    (train_temporal.py:105-107)."""
    hs = hiddens[-(TMP_LOSS_LEN + 1):]  # [K+1, B*6, h, w, C]
    t = hs.shape[0]
    equi = cube_to_equi(hs.reshape(t * batch, 6, *hs.shape[2:]))  # [t*B, 2h, 4w, C]
    preds = torch.amax(equi, dim=-1)
    return preds.reshape(t, batch, *preds.shape[1:])


def expand_segments(x: torch.Tensor, group: int) -> torch.Tensor:
    """[S, F, ...] contiguous frame runs -> [S*group, T, ...] stride-1
    windows, T = F - group + 1 (``cp360_tpu/train/loop.py:93``): window
    (s, k) lands at index s*group + k, the enumeration order of
    data/dataset.py::SegmentWindowDataset."""
    t = x.shape[1] - group + 1
    w = torch.stack([x[:, k:k + t] for k in range(group)], dim=1)
    return w.reshape(x.shape[0] * group, t, *x.shape[2:])


def make_loss_fn(cfg: Config, model: ConvLSTM, pipe_devices=None) -> Callable:
    """loss_fn(seq [B,T,6,h,w,C], flows [B,T,H,W,2]) -> (loss, parts) on
    the model's device; either batch may be f16 or a
    :class:`~cp360_tpu_torch.ops.quantize.Quantized` (the math is f32).
    With ``segment_windows`` = G > 1 the batches are frame runs [S, F, ...]
    (F = G + T - 1) and the S*G windows are rebuilt here.  With
    ``pipeline_stages`` P > 1 the rollout is pipelined over P devices of
    the model's kind (``parallel/pipeline.py::make_pipe_devices``), or
    over ``pipe_devices`` when given (a list may name one card more than
    once), in gcd(B, ``pipeline_microbatches``) microbatches."""
    group = cfg.segment_windows
    if cfg.pipeline_stages > 1 and pipe_devices is None:
        pipe_devices = make_pipe_devices(cfg.pipeline_stages, model.gates_w.device)
    if pipe_devices is not None and len(pipe_devices) != cfg.pipeline_stages:
        raise ValueError(f"pipeline_stages={cfg.pipeline_stages} but {len(pipe_devices)} "
                         "pipe devices were given")

    def loss_fn(seq, flows):
        seq = maybe_dequantize(seq)
        flows = maybe_dequantize(flows)
        if group > 1:
            # dequantize FIRST: the scales are per frame plane, so expanding
            # after dequantization equals quantizing each window's own copy
            seq = expand_segments(seq, group)
            flows = expand_segments(flows, group)
        b, t = seq.shape[0], seq.shape[1]
        # Intra-window normalization, per sample over axes 1..5
        # (cp360_tpu/train/loop.py:171-177; the reference's at batch 1).  A
        # constant window normalizes to zeros instead of the reference's NaN.
        mn = seq.reshape(b, -1).amin(dim=1).reshape(b, 1, 1, 1, 1, 1)
        rng = (seq - mn).reshape(b, -1).amax(dim=1).reshape(b, 1, 1, 1, 1, 1)
        rng = torch.where(rng > 0, rng, torch.ones_like(rng))
        seqn = (seq - mn) / rng

        x = seqn.movedim(1, 0).reshape(t, b * 6, *seq.shape[3:])  # [T, B*6, h, w, C]
        if pipe_devices is not None:
            # the last T/P chunk: >= TMP_LOSS_LEN+1 steps by check_config
            n_micro = max(1, math.gcd(b, cfg.pipeline_microbatches))
            hiddens, _, _ = pipelined_rollout(model, x, x[0], x[0], pipe_devices, n_micro,
                                              remat=cfg.train_remat)
        else:
            hiddens, _, _ = clstm_rollout(model, x, x[0], x[0], remat=cfg.train_remat)
        preds = predictions_from_hiddens(hiddens, b)  # [K+1, B, 2h, 4w]
        # pairs use the flows at window positions 1..K (train_temporal.py:104-124)
        flows_sel = flows[:, 1:1 + TMP_LOSS_LEN].movedim(1, 0)
        parts = L.weak_supervision_losses(preds, flows_sel, mm_th=cfg.mm_th,
                                          flow_h=cfg.flow_h)
        return L.total_loss(parts, cfg.l_s, cfg.l_t, cfg.l_m), parts

    return loss_fn


def make_train_step(cfg: Config, model: ConvLSTM, optimizer: torch.optim.Adam,
                    grid=None, pipe_devices=None) -> Callable:
    """step(seq, flows) -> metrics {'loss', 'smooth', 'temporal', 'mask'}
    (device scalars, no host sync): one Adam update of ``model`` in place.

    seq [B, T, 6, h, w, C] CAM cubes (T = cfg.seq_len; a Quantized pair
    with the int8 codec) and flows [B, T, H, W, 2] are tensors on the
    model's device; with ``segment_windows`` = G > 1, frame runs
    [B/G, G + T - 1, ...] instead.

    On a :class:`~cp360_tpu_torch.parallel.mesh.ProcessGrid` the batch is
    this rank's rows; the losses are sums over the batch, so the gradients
    and the metrics are summed over the data group, and the update and the
    metrics equal the one-device step's on the global batch.
    ``pipe_devices``: the pipe's stages (see :func:`make_loss_fn`).
    """
    check_config(cfg)
    loss_fn = make_loss_fn(cfg, model, pipe_devices)
    sched = lr_schedule_from_config(cfg)
    params = [p for group in optimizer.param_groups for p in group["params"]]
    data_group = grid.data_group if grid is not None and grid.n_data > 1 else None
    model_group = grid.model_group if grid is not None and grid.n_model > 1 else None

    def step(seq, flows) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        loss, parts = loss_fn(seq, flows)
        loss.backward()
        if data_group is not None:
            for p in params:
                pmesh.all_reduce_(p.grad, data_group)
            vals = torch.stack([loss.detach(), *(parts[k].detach() for k in PARTS)])
            vals = pmesh.all_reduce_(vals, data_group)
            loss, parts = vals[0], dict(zip(PARTS, vals[1:]))
        if cfg.grad_clip_norm > 0.0:
            clip_by_global_norm_([p.grad for p in params], cfg.grad_clip_norm, model_group)
        if callable(sched):
            lr = sched(update_count(optimizer))
            for group in optimizer.param_groups:
                group["lr"] = lr
        optimizer.step()
        return {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}

    return step


# ---- checkpoints -------------------------------------------------------------


def save_train_state(path: str, model: ConvLSTM, optimizer: torch.optim.Adam,
                     step: int, epoch: int, schedule: bool = False) -> None:
    """Full training-state checkpoint (params + Adam moments + counters) as
    a flat .npz, in the JAX package's layout (``save_train_state``):
    ``params/{i}`` and ``opt_state/{i}`` are the leaves of the param tree
    and of optax's Adam state (count, mu, nu; a second count under a
    schedule) in jax.tree.flatten order.  Under tensor parallelism the
    slices are gathered first (every rank calls this); rank 0 alone writes."""
    flat = {"step": np.asarray(step), "epoch": np.asarray(epoch)}
    count = np.asarray(update_count(optimizer), np.int32)
    opt = [count]
    for moment in ("exp_avg", "exp_avg_sq"):
        for name, key in PARAM_ORDER:
            p = getattr(model, f"{name}_{key}")
            st = optimizer.state.get(p, {})
            opt.append(_whole(st[moment].detach(), model) if moment in st
                       else _whole(torch.zeros_like(p.detach()), model))
    if schedule:
        opt.append(count)
    for i, (name, key) in enumerate(PARAM_ORDER):
        flat[f"params/{i}"] = _whole(getattr(model, f"{name}_{key}").detach(), model)
    for i, leaf in enumerate(opt):
        flat[f"opt_state/{i}"] = leaf
    if pmesh.process_index() != 0:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"  # atomic: a killed writer must not tear the resume file
    with open(tmp, "wb") as f:
        np.savez(f, **flat)  # uncompressed, as compat/jax_params.py::save_npz
    os.replace(tmp, path)


def _my_slice(a: np.ndarray, model: ConvLSTM) -> np.ndarray:
    """This rank's output-channel slice of a whole leaf (itself untiled)."""
    if model.model_group is None:
        return a
    per = a.shape[-1] // model.n_model
    r = torch.distributed.get_rank(model.model_group)
    return a[..., r * per:(r + 1) * per]


def load_train_state(path: str, model: ConvLSTM, optimizer: torch.optim.Adam):
    """Restore a :func:`save_train_state` file into ``model`` and
    ``optimizer`` in place (shapes checked leaf by leaf; a sliced model
    takes its slice); returns (step, epoch)."""
    with np.load(path) as f:
        data = dict(f)
    n = len(PARAM_ORDER)
    count = int(data["opt_state/0"])
    for i, (name, key) in enumerate(PARAM_ORDER):
        p = getattr(model, f"{name}_{key}")
        leaves = [_my_slice(data[k], model) for k in
                  (f"params/{i}", f"opt_state/{1 + i}", f"opt_state/{1 + n + i}")]
        for leaf in leaves:
            if leaf.shape != tuple(p.shape):
                raise ValueError(f"{name}/{key}: checkpoint shape {leaf.shape} != "
                                 f"model {tuple(p.shape)}")
        val, mu, nu = (torch.from_numpy(np.array(a, np.float32)).to(p.device)
                       for a in leaves)
        set_train_leaf(optimizer, p, val, mu, nu, count)
    return int(data["step"]), int(data["epoch"])


def set_train_leaf(optimizer: torch.optim.Adam, p: torch.Tensor, val, mu, nu,
                   count: int) -> None:
    """One parameter's value and Adam moments (``count`` updates applied)."""
    with torch.no_grad():
        p.copy_(val)
    if count > 0:
        optimizer.state[p] = {"step": torch.tensor(float(count)),
                              "exp_avg": mu, "exp_avg_sq": nu}
    else:
        optimizer.state.pop(p, None)


def checkpoint_dir(cfg: Config) -> str:
    # Reference naming (train_temporal.py:225-228).
    return os.path.join(cfg.checkpoint_path,
                        "CLSTM_s_{0:04}_t_{1:04}_m_{2:04}".format(cfg.l_s, cfg.l_t, cfg.l_m))


def checkpoint_name(epoch: int, it: int) -> str:
    return "CLSTM_{0:02}_{1:06}.npz".format(epoch, it)


def save_checkpoint(path: str, model: ConvLSTM) -> None:
    """The whole weights as an ``.npz`` (a collective under tensor
    parallelism; rank 0 alone writes)."""
    params = host_params(model)
    if pmesh.process_index() != 0:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save_npz(path, params)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Newest weight snapshot by training order, for weights-only resume:
    CLSTM_{epoch}_{iter}.npz and epoch_{n}.npz (which closes epoch n) order
    numerically; best.npz and the train state are never returned; other
    .npz names win only when no structured snapshot exists."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [f for f in os.listdir(ckpt_dir)
             if f.endswith(".npz") and not f.startswith("train_state") and f != "best.npz"]

    def order(f):
        m = re.match(r"CLSTM_(\d+)_(\d+)\.npz$", f)
        if m:
            return (1, int(m.group(1)), float(m.group(2)))
        m = re.match(r"epoch_(\d+)\.npz$", f)
        if m:
            return (1, int(m.group(1)), float("inf"))
        return (0, -1, -1.0)

    cands.sort(key=lambda f: (order(f), f))
    return os.path.join(ckpt_dir, cands[-1]) if cands else None


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Delete all but the newest ``keep`` CLSTM_* weight snapshots (config
    ``keep_checkpoints``; 0 keeps all, the reference's behaviour).  Epoch-end
    snapshots and the train state are never pruned.  Rank 0 alone prunes."""
    if keep <= 0 or not os.path.isdir(ckpt_dir) or pmesh.process_index() != 0:
        return

    def age_key(name):
        m = re.match(r"CLSTM_(\d+)_(\d+)\.npz$", name)
        return (int(m.group(1)), int(m.group(2))) if m else (-1, -1)

    snaps = sorted((f for f in os.listdir(ckpt_dir)
                    if f.startswith("CLSTM_") and f.endswith(".npz")), key=age_key)
    for f in snaps[:-keep]:
        os.remove(os.path.join(ckpt_dir, f))


class GracefulShutdown:
    """The first SIGTERM/SIGINT asks the epoch loop to finish the step in
    flight, save the full train state and return; a second signal falls
    through to the previous handlers.  A no-op outside the main thread
    (CPython installs handlers there only)."""

    def __init__(self, log_fn=print):
        self.requested = False
        self._prev: dict = {}
        self._log = log_fn

    def __enter__(self):
        import signal

        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, self._handle)
        except ValueError:  # not the main thread
            self._prev = {}
        return self

    def _handle(self, signum, frame):
        self.requested = True
        self._log(f"signal {signum}: finishing the current step, saving the train "
                  "state, then exiting (send again to stop immediately)")
        self._restore()

    def _restore(self):
        import signal

        for sig, h in self._prev.items():
            signal.signal(sig, h)
        self._prev = {}

    def __exit__(self, *exc):
        self._restore()
        return False


# ---- the epoch loop ------------------------------------------------------------


def batch_to_device(batch, device: torch.device):
    """A numpy (or Quantized numpy) batch -> tensors on ``device``."""
    if isinstance(batch, Quantized):
        return batch.to(device)
    return torch.as_tensor(batch).to(device)


def _read_best(ckdir: str, log_fn):
    """(best AUC, evals since best) from the ``best_val.json`` sidecar,
    while ``best.npz`` exists beside it: ``best.npz`` stays monotone across
    restarts and runs sharing the directory.  An unreadable sidecar starts
    over from -inf."""
    path = os.path.join(ckdir, "best_val.json")
    if os.path.exists(path) and os.path.exists(os.path.join(ckdir, "best.npz")):
        try:
            with open(path) as f:
                meta = json.load(f)
            best, since = float(meta["auc"]), int(meta.get("evals_since_best", 0))
            log_fn(f"existing best.npz at AUC {best:.4f} (kept unless validation beats it)")
            return best, since
        except (ValueError, KeyError, OSError):
            pass
    return float("-inf"), 0


def train(cfg: Config, loader, params: Optional[dict] = None, device="cuda",
          log_fn=print, metrics_jsonl: Optional[str] = None,
          resume_state: Optional[str] = None, grid=None,
          per_host_batches: bool = False) -> dict:
    """Epoch loop (reference train_temporal.py:33-193).

    ``loader.iter_epoch(epoch, skip_batches)`` yields numpy (seq
    [B,T,6,h,w,C], flows [B,T,H,W,2]) batches in an order fixed by the
    epoch, so a resume continues mid-epoch exactly (data/dataset.py::
    PrefetchLoader).  ``resume_state``: "latest" resumes the checkpoint directory's full
    train state; a path loads that file.  Every ``eval_every_epochs``
    epochs the weights are scored on ``eval_dir`` (train/validate.py): a
    ``val`` record, ``best.npz`` with its ``best_val.json`` sidecar when
    the AUC improves, a ``train_early_stop`` record and the end of training
    after ``eval_patience`` passes without improvement, and a
    ``val_error`` record (training goes on) when the pass raises.

    ``grid`` (``parallel/mesh.py::grid_from_config``) trains on a grid of
    ranks: each rank's batch is its rows of the global batch, cut here
    from the full batch, or taken as it comes when ``per_host_batches``
    (the loader read this rank's rows alone, ``PrefetchLoader(rows=...)``).
    Every rank runs this loop; rank 0 alone writes the metrics and the
    ``.npz`` files, and a shutdown or early stop is agreed by all ranks at
    one step.  Returns the trained param tree (numpy, whole).
    """
    from contextlib import ExitStack

    from cp360_tpu_torch.train.checkpoint import make_checkpointer
    from cp360_tpu_torch.utils.logging import MetricLogger
    from cp360_tpu_torch.utils.profiling import maybe_profile

    check_config(cfg)
    device = torch.device(device)
    if params is None:
        params = init_clstm_params(0, cfg.input_size, cfg.hidden_size)
    model = trainable_clstm(cfg, params, device, grid)
    optimizer = make_optimizer(cfg, model)
    step_fn = make_train_step(cfg, model, optimizer, grid)
    lr_sched = lr_schedule_from_config(cfg)
    put = None
    if grid is not None:
        put = pmesh.shard_batch_per_host if per_host_batches else pmesh.shard_batch

    ckdir = checkpoint_dir(cfg)
    ck = make_checkpointer(cfg.checkpoint_backend, ckdir, schedule=callable(lr_sched))
    it, start_epoch = 0, 0
    restored = None
    if resume_state == "latest":
        restored = ck.restore(model, optimizer)
    elif resume_state:
        # a missing explicit path fails instead of silently retraining
        if not os.path.exists(resume_state):
            raise FileNotFoundError(f"resume_state={resume_state!r} does not exist "
                                    "(use resume_state='latest' for best-effort resume)")
        restored = load_train_state(resume_state, model, optimizer)
    if restored is not None:
        it, start_epoch = restored
        log_fn(f"resumed full train state from {ck.path if resume_state == 'latest' else resume_state}"
               f" (iter {it}, epoch {start_epoch})")
    if metrics_jsonl and pmesh.process_index() != 0:
        metrics_jsonl = None  # one writer; every rank still echoes

    def epoch_batches(epoch):
        skip, spe = 0, len(loader)
        if restored is not None and epoch == start_epoch and spe:
            skip = it - epoch * spe
            if not 0 <= skip <= spe:
                log_fn(f"resume: iter {it} does not align with {spe} batches/epoch "
                       f"(dataset or batch size changed?); re-running epoch {epoch}")
                skip = 0
            elif skip:
                log_fn(f"resume: epoch {epoch} continues at batch {skip}/{spe}")
        return loader.iter_epoch(epoch, skip_batches=skip)

    def save_all(name: str, step: int, epoch: int) -> None:
        save_checkpoint(os.path.join(ckdir, name), model)
        ck.save(model, optimizer, step, epoch)

    with ExitStack() as stack:
        # an exception mid-epoch must not leave an async save half written
        stack.callback(ck.close)
        logger = stack.enter_context(MetricLogger(metrics_jsonl, echo=log_fn))
        stack.enter_context(maybe_profile(cfg.profile_dir))
        shutdown = stack.enter_context(GracefulShutdown(log_fn))
        best_auc, evals_since_best = _read_best(ckdir, log_fn)
        for epoch in range(start_epoch, cfg.epochs):
            # the running loss stays on the device: the host syncs once per
            # summary, not once per step
            running = torch.zeros((), device=device)
            n_since = 0
            t_sum = time.time()
            for seq, flows in epoch_batches(epoch):
                if put is not None:
                    seq, flows = put(grid, (seq, flows))
                metrics = step_fn(batch_to_device(seq, device), batch_to_device(flows, device))
                running = running + metrics["loss"]
                n_since += 1
                it += 1
                if it % cfg.summary_freq == 0:
                    loss_avg = float(running) / n_since
                    if not np.isfinite(loss_avg):
                        raise FloatingPointError(
                            f"non-finite training loss ({loss_avg}) at iter {it} (epoch "
                            f"{epoch}); the last good checkpoint resumes with --resume")
                    now = time.time()
                    logger.log("train", epoch=epoch, iter=it, loss_avg=loss_avg,
                               loss_smooth=cfg.l_s * float(metrics["smooth"]),
                               loss_temporal=cfg.l_t * float(metrics["temporal"]),
                               loss_mask=cfg.l_m * float(metrics["mask"]),
                               batch_time_avg=(now - t_sum) / n_since,
                               lr=lr_sched(it - 1) if callable(lr_sched) else lr_sched)
                    running = torch.zeros((), device=device)
                    n_since = 0
                    t_sum = now
                if it % cfg.save_freq == 0:
                    save_all(checkpoint_name(epoch, it), it, epoch)
                    prune_checkpoints(ckdir, cfg.keep_checkpoints)
                # every rank takes this branch at the same step, even when
                # the signals land skewed: the saves below are collective
                if pmesh.global_any(shutdown.requested):
                    save_all(checkpoint_name(epoch, it), it, epoch)
                    logger.log("train_interrupted", epoch=epoch, iter=it)
                    log_fn(f"graceful shutdown at iter {it} (epoch {epoch}); "
                           "resume with resume_state='latest'")
                    return host_params(model)
            save_all(f"epoch_{epoch:02}.npz", it, epoch + 1)

            if cfg.eval_every_epochs > 0 and (epoch + 1) % cfg.eval_every_epochs == 0:
                best_auc, evals_since_best, stop = _validate_epoch(
                    cfg, model, device, ckdir, epoch, it, best_auc, evals_since_best,
                    logger, log_fn)
                # the decision lives on rank 0: every rank stops at one epoch
                if pmesh.global_any(stop):
                    logger.log("train_early_stop", epoch=epoch, iter=it, best_auc=best_auc)
                    log_fn(f"early stop at epoch {epoch}: no validation AUC improvement in "
                           f"{cfg.eval_patience} passes (best {best_auc:.4f} -> best.npz)")
                    break
    return host_params(model)


def _validate_epoch(cfg: Config, model: ConvLSTM, device, ckdir: str, epoch: int, it: int,
                    best_auc: float, evals_since_best: int, logger, log_fn):
    """One validation pass after an epoch (``cp360_tpu/train/loop.py:651-697``):
    returns (best AUC, evals since best, stop).  The pass reads a host copy
    of the weights (gathered from every rank) and builds its own serving
    cell on rank 0, so the trainable model and the Adam state are not
    touched; a pass that raises is logged as ``val_error`` and training
    goes on."""
    from cp360_tpu_torch.train.validate import run_validation

    params_host = host_params(model)
    if pmesh.process_index() != 0:
        return best_auc, evals_since_best, False
    try:
        agg = run_validation(params_host, cfg, device=device, log_fn=log_fn)
    except Exception as e:  # noqa: BLE001 -- an opt-in side pass must not end training
        logger.log("val_error", epoch=epoch, iter=it, error=f"{type(e).__name__}: {e}")
        log_fn(f"validation pass failed (training continues): {type(e).__name__}: {e}")
        return best_auc, evals_since_best, False
    if agg is None:
        return best_auc, evals_since_best, False
    improved = agg["AUC"] > best_auc
    os.makedirs(ckdir, exist_ok=True)
    if improved:
        best_auc, evals_since_best = agg["AUC"], 0
        save_npz(os.path.join(ckdir, "best.npz"), params_host)
    else:
        evals_since_best += 1
    with open(os.path.join(ckdir, "best_val.json"), "w") as f:
        json.dump({"auc": best_auc, "evals_since_best": evals_since_best,
                   "epoch": epoch, "iter": it}, f)
    logger.log("val", epoch=epoch, iter=it, best=improved, **agg)
    stop = cfg.eval_patience > 0 and evals_since_best >= cfg.eval_patience
    return best_auc, evals_since_best, stop
