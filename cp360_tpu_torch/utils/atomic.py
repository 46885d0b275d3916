"""Crash-atomic numpy file writes for resumable pipelines.

The port's copy of ``cp360_tpu/utils/atomic.py``.  Resume treats an
EXISTING artifact (an extracted frame, a stage-2 ``_done.npz`` marker) as a
completed unit of work, so a write interrupted mid-``np.save`` must never
leave a truncated file under the final name.  Each write goes to a
same-directory ``*.tmp`` name, then ``os.replace`` (atomic on POSIX).

The temp name does NOT carry the .npy/.npz extension (numpy is handed an
open file object, which skips its suffix-appending): artifact listers
select on ``NNNN.npy``, and a stale temp from a crashed run must never be
listed as a frame.
"""

from __future__ import annotations

import os

import numpy as np


def atomic_save(path: str, arr) -> None:
    """``np.save(path, arr)`` that lands atomically (path must end .npy)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, path)


def atomic_savez(path: str, **arrays) -> None:
    """``np.savez(path, **arrays)`` that lands atomically (path ends .npz)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
