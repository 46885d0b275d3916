"""Training-state checkpoints: the portable ``.npz`` backend.

The port of ``cp360_tpu/train/checkpoint.py``'s ``NpzCheckpointer``: the
full train state (params + Adam moments + counters) in one flat ``.npz``
(``train/loop.py::save_train_state``), synchronous, restored exactly.  The
JAX package's async, sharded ``orbax`` backend is not ported (ROADMAP.md,
"parallel").
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from cp360_tpu_torch.train.loop import load_train_state, save_train_state


class NpzCheckpointer:
    """save_train_state/load_train_state with latest-state bookkeeping."""

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


def make_checkpointer(backend: str, directory: str, schedule: bool = False):
    if backend == "orbax":
        raise NotImplementedError("checkpoint_backend: orbax is not ported to "
                                  'cp360_tpu_torch yet; see ROADMAP.md, "parallel"')
    if backend == "npz":
        return NpzCheckpointer(directory, schedule)
    raise ValueError(f"unknown checkpoint_backend {backend!r} (npz)")
