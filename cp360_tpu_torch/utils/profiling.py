"""Profiling hooks (``torch.profiler``), the port's span and counter
recorder, and a step timer.

The port of ``cp360_tpu/utils/profiling.py``: an optional trace of a span
(config ``profile_dir`` / the train CLI's ``--profile-dir``), named
spans inside it, and :class:`StepTimer`.  The trace is Chrome-trace JSON
(``chrome://tracing``, Perfetto); on a card it holds the CUDA kernels,
the hand kernels of ``csrc/`` included.

Recording follows the profiler: spans and counters are kept while a
``torch.profiler`` runs in the process (torch's own process-wide flag,
``torch.autograd.profiler._is_profiler_enabled``, set from the
profiler's start to its stop).  A span (:func:`annotate`) on a thread the
profiler records lands in its trace as a ``user_annotation`` event, on
the clock of the trace's CUDA kernels, and in the in-memory
:data:`STORE`.  The profiler records the thread that started it, not the
pools and workers that thread feeds, so a span on any other thread goes
to the store alone.  A counter (:func:`count`) adds under the same gate.
With nothing profiling, a span costs one check and records nothing.

A span given a CUDA ``device`` (``annotate(name, device=...)``) also puts a
pair of timing events on that device's current stream at its edges, and
adds the device milliseconds between them to the counter
``<name>.device_ms``.  A pair is resolved once its end event has
completed: a later device span takes the completed pairs without waiting,
and reading :func:`counters` waits for the rest.  Nothing on the timed
path synchronizes.  On a CPU device the span records its host edges alone.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import Dict, List, NamedTuple, Optional

MAX_SPANS = 1 << 17  # the store's bound: later spans are dropped and counted
MAX_PENDING = 1 << 12  # device-timed spans whose events have not been read yet


class Span(NamedTuple):
    """One recorded span, on the host's ``time.perf_counter_ns`` clock."""
    name: str
    tid: int  # the native thread id, as the profiler's trace names threads
    start_ns: int
    end_ns: int
    traced: bool  # also in the profiler's trace (entered on a profiled thread)


class SpanStore:
    """Spans and counters recorded while a profiler records.  Holds at most
    ``max_spans`` spans (:data:`MAX_SPANS`, about 25 MB) and
    ``max_pending`` unread event pairs of device-timed spans
    (:data:`MAX_PENDING`); ``dropped`` counts the spans and pairs that came
    after."""

    def __init__(self, max_spans: int = MAX_SPANS, max_pending: int = MAX_PENDING):
        self.max_spans = max_spans
        self.max_pending = max_pending
        self.dropped = 0
        self._spans: List[Span] = []
        self._counters: Dict[str, float] = {}
        self._pending: List[tuple] = []  # (counter, start event, end event), in record order
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(span)
            else:
                self.dropped += 1

    def count(self, name: str, n: float) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def add_events(self, counter: str, start, end) -> None:
        """Keep a recorded pair of timing events until ``end`` completes,
        then add ``start.elapsed_time(end)`` (ms) to ``counter``; the pairs
        already completed are taken first, without waiting."""
        with self._lock:
            self._resolve(wait=False)
            if len(self._pending) < self.max_pending:
                self._pending.append((counter, start, end))
            else:
                self.dropped += 1

    def _resolve(self, wait: bool) -> None:
        """Add the pending pairs' times to their counters, in record order:
        all of them (waiting for each end event), or those up to the first
        whose end has not completed.  Called with the lock held."""
        done = 0
        for counter, start, end in self._pending:
            if wait:
                end.synchronize()
            elif not end.query():
                break
            self._counters[counter] = self._counters.get(counter, 0) + start.elapsed_time(end)
            done += 1
        del self._pending[:done]

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def counters(self) -> Dict[str, float]:
        """The counters, each device-timed span's time included (this waits
        for the device to finish the pending spans)."""
        with self._lock:
            self._resolve(wait=True)
            return dict(self._counters)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()
            self._pending.clear()
            self.dropped = 0


STORE = SpanStore()


def _recording() -> bool:
    """Whether a torch profiler runs in this process (torch unloaded: no)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def _profiled() -> bool:
    """Whether a torch profiler records this thread."""
    return sys.modules["torch"].autograd._profiler_enabled()


class _Annotation:
    __slots__ = ("name", "device", "_fn", "_t0", "_ev0")

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = device
        self._fn = self._t0 = self._ev0 = None

    def __enter__(self):
        if _recording():
            if _profiled():
                import torch

                self._fn = torch.profiler.record_function(self.name)
                self._fn.__enter__()
            if self.device is not None and self.device.type == "cuda":
                self._ev0 = _timing_event(self.device)
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            t1 = time.perf_counter_ns()
            STORE.add(Span(self.name, threading.get_native_id(), self._t0, t1,
                           self._fn is not None))
            if self._ev0 is not None:
                STORE.add_events(f"{self.name}.device_ms", self._ev0,
                                 _timing_event(self.device))
        if self._fn is not None:
            self._fn.__exit__(*exc)
        return False


def _timing_event(device):
    """A timing event recorded now on ``device``'s current stream."""
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def annotate(name: str, *, device=None):
    """Named span: in the profiler's timeline on a profiled thread, and in
    :data:`STORE` wherever it runs while a profiler runs.  With a CUDA
    ``device`` (a ``torch.device``), the device time between the span's
    edges on that device's current stream is added to the counter
    ``<name>.device_ms``; it includes any stretch in which the device
    waited for the host to launch the span's next kernel."""
    return _Annotation(name, device)


def count(name: str, n: float) -> None:
    """Add ``n`` to the counter ``name`` while a profiler runs."""
    if _recording():
        STORE.count(name, n)


def spans() -> List[Span]:
    return STORE.spans()


def counters() -> Dict[str, float]:
    return STORE.counters()


def clear() -> None:
    STORE.clear()


def _add_untraced_spans(path: str, since_ns: int) -> None:
    """Add the store's spans from ``since_ns`` on that are not in the trace
    at ``path`` (those of unprofiled threads) to it.  The trace's
    ``ts + baseTimeNanoseconds / 1000`` is the wall clock in microseconds,
    so each span is placed by the wall clock's offset from
    ``perf_counter_ns``."""
    extra = [s for s in STORE.spans() if not s.traced and s.start_ns >= since_ns]
    if not extra:
        return
    offset_ns = time.time_ns() - time.perf_counter_ns()
    with open(path) as f:
        trace = json.load(f)
    base_us = trace.get("baseTimeNanoseconds", 0) / 1000
    pid = os.getpid()
    trace.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "user_annotation", "name": s.name, "pid": pid, "tid": s.tid,
         "ts": (s.start_ns + offset_ns) / 1000 - base_us, "dur": (s.end_ns - s.start_ns) / 1000}
        for s in extra)
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str]):
    """Trace the enclosed span with ``torch.profiler`` (CPU activity, and
    CUDA when a card is present) if ``profile_dir`` is given, and write
    ``<profile_dir>/trace_<pid>_<time>.json`` when the span ends, however
    it ends, with the spans of the threads the profiler does not record
    (the loader's worker, the stream's remap pool) added from the store,
    which is then cleared.  The profiler keeps its events in host memory
    until then, so profile a bounded span (the train loop profiles its
    epochs only)."""
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
    since = time.perf_counter_ns()
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(profile_dir, f"trace_{os.getpid()}_{int(time.time())}.json")
        prof.export_chrome_trace(path)
        _add_untraced_spans(path, since)
        STORE.clear()


class StepTimer:
    """Running mean/last step timer for train/infer loops, on the host's
    clock (``time.time()``).  CUDA work is asynchronous: to time a device
    step, synchronize (``torch.cuda.synchronize()``) before the block
    ends."""

    def __init__(self):
        self.n = 0
        self.total = 0.0
        self.last = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.last = time.time() - self._t0
        self.total += self.last
        self.n += 1

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0
