"""Profiling hooks (``torch.profiler``).

The port of ``cp360_tpu/utils/profiling.py``: an optional trace of a span
(config ``profile_dir`` / the train CLI's ``--profile-dir``) and named
spans inside it.  The trace is Chrome-trace JSON
(``chrome://tracing``, Perfetto); on a card it holds the CUDA kernels,
the hand kernels of ``csrc/`` included.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str]):
    """Trace the enclosed span with ``torch.profiler`` (CPU activity, and
    CUDA when a card is present) if ``profile_dir`` is given, and write
    ``<profile_dir>/trace_<pid>_<time>.json`` when the span ends, however
    it ends.  The profiler keeps its events in host memory until then, so
    profile a bounded span (the train loop profiles its epochs only)."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities, acc_events=True)  # one cycle: keep its events
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(profile_dir, f"trace_{os.getpid()}_{int(time.time())}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named span (shows in the profiler timeline)."""
    import torch

    with torch.profiler.record_function(name):
        yield
