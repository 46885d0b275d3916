"""Training-state checkpoint backends: portable ``.npz`` and sharded DCP.

The port of ``cp360_tpu/train/checkpoint.py``, selected by the config key
``checkpoint_backend``:

- ``npz`` (default): the full train state (params + Adam moments +
  counters) in one flat ``.npz`` (``train/loop.py::save_train_state``),
  synchronous, in the JAX package's layout; under tensor parallelism the
  slices are gathered and rank 0 writes.
- ``orbax``: the JAX package's name for its asynchronous, sharded backend.
  The port's form is a ``torch.distributed.checkpoint`` (DCP) directory per
  step under ``<checkpoint dir>/orbax/<step>/``: every rank writes its own
  slices (ranks holding the same slice write it once) and ``--resume``
  reads each rank's slices back, so a sliced state is never gathered.  The
  save is asynchronous: the state is copied to host memory, then written by
  a background thread over a gloo group of its own (the training loop's
  collectives keep the default group).  The format is the port's own; JAX
  orbax trees are not read.

Both restore exactly (bitwise params and moments).
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Optional, Tuple

import torch

from cp360_tpu_torch.parallel import mesh as pmesh
from cp360_tpu_torch.train.loop import (
    PARAM_ORDER, load_train_state, save_train_state, set_train_leaf, update_count)


class NpzCheckpointer:
    """save_train_state/load_train_state with latest-state bookkeeping."""

    name = "npz"

    def __init__(self, directory: str, schedule: bool = False):
        self.path = os.path.join(directory, "train_state_latest.npz")
        self.schedule = schedule  # optax keeps a second count under a schedule

    def save(self, model, optimizer, step: int, epoch: int) -> None:
        save_train_state(self.path, model, optimizer, step, epoch, self.schedule)

    def restore(self, model, optimizer) -> Optional[Tuple[int, int]]:
        """Load the latest state into model and optimizer in place; returns
        (step, epoch), or None when there is none."""
        if not self.has_state():
            return None
        return load_train_state(self.path, model, optimizer)

    def has_state(self) -> bool:
        return os.path.exists(self.path)

    def close(self) -> None:  # synchronous: nothing in flight
        pass


def _shard_tag(model) -> str:
    if model.model_group is None:
        return "whole"
    return f"shard{torch.distributed.get_rank(model.model_group)}of{model.n_model}"


class DcpCheckpointer:
    """Asynchronous, sharded train-state checkpoints (``checkpoint_backend:
    orbax``) as ``torch.distributed.checkpoint`` directories, one per step;
    the newest ``max_to_keep`` are kept."""

    name = "orbax"

    def __init__(self, directory: str, schedule: bool = False, max_to_keep: int = 3):
        self.directory = os.path.abspath(os.path.join(directory, "orbax"))
        self.path = self.directory
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._group = None

    def _pg(self):
        """The writer's own gloo group, built at the first save or restore
        (on the main thread: ``new_group`` is collective, and every rank
        saves and restores at the same points)."""
        if self._group is None and pmesh.process_count() > 1:
            self._group = torch.distributed.new_group(backend="gloo")
        return self._group

    def _steps(self):
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(os.path.join(self.directory, d,
                                                                     ".metadata")))

    def _state(self, model, optimizer, host: bool) -> dict:
        """The flat state dict: each leaf keyed by its slice, so ranks that
        hold different slices write different keys."""
        tag = _shard_tag(model)
        out = {"count": torch.tensor(update_count(optimizer), dtype=torch.int64)}
        for name, key in PARAM_ORDER:
            p = getattr(model, f"{name}_{key}")
            st = optimizer.state.get(p, {})
            leaves = {"params": p.detach(),
                      "mu": st["exp_avg"].detach() if "exp_avg" in st else torch.zeros_like(p),
                      "nu": st["exp_avg_sq"].detach() if "exp_avg_sq" in st
                      else torch.zeros_like(p)}
            for kind, t in leaves.items():
                out[f"{kind}/{name}_{key}/{tag}"] = t.to("cpu", copy=True) if host else t
        return out

    def save(self, model, optimizer, step: int, epoch: int) -> None:
        import torch.distributed.checkpoint as dcp

        self.wait()  # one save in flight
        state = self._state(model, optimizer, host=True)  # the copy the thread writes
        state["step"] = torch.tensor(step, dtype=torch.int64)
        state["epoch"] = torch.tensor(epoch, dtype=torch.int64)
        path = os.path.join(self.directory, str(step))
        group = self._pg()

        def write():
            try:
                dcp.save(state, checkpoint_id=path, process_group=group)
                if pmesh.process_index() == 0:
                    for old in self._steps()[:-self.max_to_keep]:
                        shutil.rmtree(os.path.join(self.directory, str(old)),
                                      ignore_errors=True)
            except BaseException as e:  # noqa: BLE001 -- raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=write, name="dcp-save", daemon=True)
        self._thread.start()

    def restore(self, model, optimizer) -> Optional[Tuple[int, int]]:
        """Load this rank's slices of the newest step into model and
        optimizer in place; returns (step, epoch), or None when there is
        none."""
        import torch.distributed.checkpoint as dcp

        self.wait()
        steps = self._steps()
        if not steps:
            return None
        state = self._state(model, optimizer, host=True)
        for key in ("step", "epoch"):
            state[key] = torch.zeros((), dtype=torch.int64)
        dcp.load(state, checkpoint_id=os.path.join(self.directory, str(steps[-1])),
                 process_group=self._pg())
        count = int(state["count"])
        tag = _shard_tag(model)
        for name, key in PARAM_ORDER:
            p = getattr(model, f"{name}_{key}")
            val, mu, nu = (state[f"{kind}/{name}_{key}/{tag}"].to(p.device)
                           for kind in ("params", "mu", "nu"))
            set_train_leaf(optimizer, p, val, mu, nu, count)
        return int(state["step"]), int(state["epoch"])

    def has_state(self) -> bool:
        return bool(self._steps())

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"asynchronous checkpoint save failed: {err}") from err

    def close(self) -> None:
        self.wait()


def make_checkpointer(backend: str, directory: str, schedule: bool = False):
    if backend == "orbax":
        return DcpCheckpointer(directory, schedule)
    if backend == "npz":
        return NpzCheckpointer(directory, schedule)
    raise ValueError(f"unknown checkpoint_backend {backend!r} (npz | orbax)")
