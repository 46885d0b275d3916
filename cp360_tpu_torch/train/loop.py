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

Not ported yet (each raises ``NotImplementedError`` from
:func:`check_config`): segment windows, pipeline stages, data/model meshes,
the orbax backend, in-training validation and profiling.
"""

from __future__ import annotations

import math
import os
import re
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from cp360_tpu_torch.compat.jax_params import (
    clstm_from_params, clstm_to_params, init_clstm_params, save_npz)
from cp360_tpu_torch.config import Config
from cp360_tpu_torch.models.clstm import CONV_NAMES, ConvLSTM, clstm_rollout
from cp360_tpu_torch.ops.resample import cube_to_equi
from cp360_tpu_torch.train import losses as L

TMP_LOSS_LEN = 3  # pairs of consecutive predictions entering the losses
# params/{i} and the Adam moments in jax.tree.flatten order (sorted keys)
PARAM_ORDER = tuple((name, key) for name in sorted(CONV_NAMES) for key in ("b", "w"))


def check_config(cfg: Config) -> None:
    """Raise on the training options this port does not run yet."""
    unported = [  # (hit, option, the ROADMAP.md item that ports it)
        (cfg.segment_windows > 1, "segment_windows > 1 (segment ingestion)", "trainer options"),
        (cfg.transfer_codec != "none", f"transfer_codec={cfg.transfer_codec!r} (int8 codec)",
         "trainer options"),
        (cfg.pipeline_stages > 1, "pipeline_stages > 1 (pipeline parallelism)", "parallel"),
        (cfg.mesh_data > 1 or cfg.mesh_model > 1,
         "mesh_data/mesh_model > 1 (multi-card training)", "parallel"),
        (cfg.checkpoint_backend == "orbax", "checkpoint_backend: orbax", "parallel"),
        (cfg.eval_every_epochs > 0, "eval_every_epochs > 0 (in-training validation)",
         "trainer options"),
        (bool(cfg.profile_dir), "profile_dir (training profiles)", "trainer options"),
    ]
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError(
                f'{what} is not ported to cp360_tpu_torch yet; see ROADMAP.md, "{item}"')
    if cfg.checkpoint_backend != "npz":
        raise ValueError(f"unknown checkpoint_backend {cfg.checkpoint_backend!r} (npz)")


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


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: when the global norm g is not
    below ``max_norm`` each gradient becomes (grad / g) * max_norm.  (Not
    ``clip_grad_norm_``, which divides by g + 1e-6.)"""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
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


def trainable_clstm(cfg: Config, params: dict, device) -> ConvLSTM:
    """The ConvLSTM to train: f32 masters on ``device`` from a param tree."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    return clstm_from_params(params, dtype, cfg.cube_pad, cfg.clstm_conv_impl,
                             device=device, trainable=True)


def predictions_from_hiddens(hiddens: torch.Tensor, batch: int) -> torch.Tensor:
    """Last K+1 hidden states -> channel-maxed equi maps [K+1, B, 2h, 4w]
    (train_temporal.py:105-107)."""
    hs = hiddens[-(TMP_LOSS_LEN + 1):]  # [K+1, B*6, h, w, C]
    t = hs.shape[0]
    equi = cube_to_equi(hs.reshape(t * batch, 6, *hs.shape[2:]))  # [t*B, 2h, 4w, C]
    preds = torch.amax(equi, dim=-1)
    return preds.reshape(t, batch, *preds.shape[1:])


def make_loss_fn(cfg: Config, model: ConvLSTM) -> Callable:
    """loss_fn(seq [B,T,6,h,w,C], flows [B,T,H,W,2]) -> (loss, parts) on
    the model's device; either batch may be f16 (the math is f32)."""

    def loss_fn(seq, flows):
        seq = seq.float()
        flows = flows.float()
        b, t = seq.shape[0], seq.shape[1]
        # Intra-window normalization, per sample over axes 1..5
        # (cp360_tpu/train/loop.py:171-177; the reference's at batch 1).  A
        # constant window normalizes to zeros instead of the reference's NaN.
        mn = seq.reshape(b, -1).amin(dim=1).reshape(b, 1, 1, 1, 1, 1)
        rng = (seq - mn).reshape(b, -1).amax(dim=1).reshape(b, 1, 1, 1, 1, 1)
        rng = torch.where(rng > 0, rng, torch.ones_like(rng))
        seqn = (seq - mn) / rng

        x = seqn.movedim(1, 0).reshape(t, b * 6, *seq.shape[3:])  # [T, B*6, h, w, C]
        hiddens, _, _ = clstm_rollout(model, x, x[0], x[0], remat=cfg.train_remat)
        preds = predictions_from_hiddens(hiddens, b)  # [K+1, B, 2h, 4w]
        # pairs use the flows at window positions 1..K (train_temporal.py:104-124)
        flows_sel = flows[:, 1:1 + TMP_LOSS_LEN].movedim(1, 0)
        parts = L.weak_supervision_losses(preds, flows_sel, mm_th=cfg.mm_th,
                                          flow_h=cfg.flow_h)
        return L.total_loss(parts, cfg.l_s, cfg.l_t, cfg.l_m), parts

    return loss_fn


def make_train_step(cfg: Config, model: ConvLSTM, optimizer: torch.optim.Adam) -> Callable:
    """step(seq, flows) -> metrics {'loss', 'smooth', 'temporal', 'mask'}
    (device scalars, no host sync): one Adam update of ``model`` in place.

    seq [B, T, 6, h, w, C] CAM cubes (T = cfg.seq_len) and flows
    [B, T, H, W, 2] are tensors on the model's device.
    """
    check_config(cfg)
    loss_fn = make_loss_fn(cfg, model)
    sched = lr_schedule_from_config(cfg)
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(seq, flows) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        loss, parts = loss_fn(seq, flows)
        loss.backward()
        if cfg.grad_clip_norm > 0.0:
            clip_by_global_norm_([p.grad for p in params], cfg.grad_clip_norm)
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
    schedule) in jax.tree.flatten order."""
    flat = {"step": np.asarray(step), "epoch": np.asarray(epoch)}
    count = np.asarray(update_count(optimizer), np.int32)
    opt = [count]
    for moment in ("exp_avg", "exp_avg_sq"):
        for name, key in PARAM_ORDER:
            p = getattr(model, f"{name}_{key}")
            st = optimizer.state.get(p, {})
            opt.append(st[moment].detach().cpu().numpy() if moment in st
                       else np.zeros(tuple(p.shape), np.float32))
    if schedule:
        opt.append(count)
    for i, (name, key) in enumerate(PARAM_ORDER):
        flat[f"params/{i}"] = getattr(model, f"{name}_{key}").detach().cpu().numpy()
    for i, leaf in enumerate(opt):
        flat[f"opt_state/{i}"] = leaf
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"  # atomic: a killed writer must not tear the resume file
    with open(tmp, "wb") as f:
        np.savez(f, **flat)  # uncompressed, as compat/jax_params.py::save_npz
    os.replace(tmp, path)


def load_train_state(path: str, model: ConvLSTM, optimizer: torch.optim.Adam):
    """Restore a :func:`save_train_state` file into ``model`` and
    ``optimizer`` in place (shapes checked leaf by leaf); returns
    (step, epoch)."""
    with np.load(path) as f:
        data = dict(f)
    n = len(PARAM_ORDER)
    count = int(data["opt_state/0"])
    for i, (name, key) in enumerate(PARAM_ORDER):
        p = getattr(model, f"{name}_{key}")
        leaves = [data[f"params/{i}"], data[f"opt_state/{1 + i}"],
                  data[f"opt_state/{1 + n + i}"]]
        for leaf in leaves:
            if leaf.shape != tuple(p.shape):
                raise ValueError(f"{name}/{key}: checkpoint shape {leaf.shape} != "
                                 f"model {tuple(p.shape)}")
        val, mu, nu = (torch.from_numpy(np.asarray(a, np.float32)).to(p.device)
                       for a in leaves)
        with torch.no_grad():
            p.copy_(val)
        if count > 0:
            optimizer.state[p] = {"step": torch.tensor(float(count)),
                                  "exp_avg": mu, "exp_avg_sq": nu}
        else:
            optimizer.state.pop(p, None)
    return int(data["step"]), int(data["epoch"])


def checkpoint_dir(cfg: Config) -> str:
    # Reference naming (train_temporal.py:225-228).
    return os.path.join(cfg.checkpoint_path,
                        "CLSTM_s_{0:04}_t_{1:04}_m_{2:04}".format(cfg.l_s, cfg.l_t, cfg.l_m))


def checkpoint_name(epoch: int, it: int) -> str:
    return "CLSTM_{0:02}_{1:06}.npz".format(epoch, it)


def save_checkpoint(path: str, model: ConvLSTM) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save_npz(path, clstm_to_params(model))


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
    snapshots and the train state are never pruned."""
    if keep <= 0 or not os.path.isdir(ckpt_dir):
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


def train(cfg: Config, loader, params: Optional[dict] = None, device="cuda",
          log_fn=print, metrics_jsonl: Optional[str] = None,
          resume_state: Optional[str] = None) -> dict:
    """Epoch loop on one device (reference train_temporal.py:33-193).

    ``loader.iter_epoch(epoch, skip_batches)`` yields numpy (seq
    [B,T,6,h,w,C], flows [B,T,H,W,2]) batches in an order fixed by the
    epoch, so a resume continues mid-epoch exactly (data/dataset.py::
    PrefetchLoader).  ``resume_state``:
    "latest" resumes the checkpoint directory's full train state; a path
    loads that file.  Returns the trained param tree (numpy).
    """
    from cp360_tpu_torch.train.checkpoint import make_checkpointer
    from cp360_tpu_torch.utils.logging import MetricLogger

    check_config(cfg)
    device = torch.device(device)
    if params is None:
        params = init_clstm_params(0, cfg.input_size, cfg.hidden_size)
    model = trainable_clstm(cfg, params, device)
    optimizer = make_optimizer(cfg, model)
    step_fn = make_train_step(cfg, model, optimizer)
    lr_sched = lr_schedule_from_config(cfg)

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

    def to_device(a):
        return torch.from_numpy(a).to(device)

    with MetricLogger(metrics_jsonl, echo=log_fn) as logger, GracefulShutdown(log_fn) as shutdown:
        for epoch in range(start_epoch, cfg.epochs):
            skip, spe = 0, len(loader)
            if restored is not None and epoch == start_epoch and spe:
                skip = it - epoch * spe
                if not 0 <= skip <= spe:
                    log_fn(f"resume: iter {it} does not align with {spe} batches/epoch "
                           f"(dataset or batch size changed?); re-running epoch {epoch}")
                    skip = 0
                elif skip:
                    log_fn(f"resume: epoch {epoch} continues at batch {skip}/{spe}")
            batches = loader.iter_epoch(epoch, skip_batches=skip)
            # the running loss stays on the device: the host syncs once per
            # summary, not once per step
            running = torch.zeros((), device=device)
            n_since = 0
            t_sum = time.time()
            for seq, flows in batches:
                metrics = step_fn(to_device(seq), to_device(flows))
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
                    save_checkpoint(os.path.join(ckdir, checkpoint_name(epoch, it)), model)
                    ck.save(model, optimizer, it, epoch)
                    prune_checkpoints(ckdir, cfg.keep_checkpoints)
                if shutdown.requested:
                    save_checkpoint(os.path.join(ckdir, checkpoint_name(epoch, it)), model)
                    ck.save(model, optimizer, it, epoch)
                    logger.log("train_interrupted", epoch=epoch, iter=it)
                    log_fn(f"graceful shutdown at iter {it} (epoch {epoch}); "
                           "resume with resume_state='latest'")
                    return clstm_to_params(model)
            save_checkpoint(os.path.join(ckdir, f"epoch_{epoch:02}.npz"), model)
            ck.save(model, optimizer, it, epoch + 1)
    return clstm_to_params(model)
