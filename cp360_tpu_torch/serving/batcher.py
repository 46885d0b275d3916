"""Dynamic request batching for the serving layer.

The reference has no serving story (SURVEY.md §2 — batch research pipeline
only).  Concurrent HTTP requests are coalesced into ONE device step so the
GPU sees a real batch instead of a stream of batch-1 launches, and each
batcher's device work stays on its own worker thread.  A copy of the JAX
package's batcher (stdlib only; the port imports nothing of that package).

Shape discipline: callers bucket the collected batch up to a power-of-two
size (see ``SaliencyModel._run_stage1_batch``) so the device sees a
handful of batch shapes (cuDNN picks its algorithms per shape) instead of
one per observed batch size.

Protocol: ``submit(item)`` blocks until the worker has run ``run_batch`` on
a group containing the item and returns this item's result.  ``run_batch``
receives the list of items (in arrival order) and must return one result
per item, in order.  A ``run_batch`` exception is re-raised in every
waiting caller.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, List, Sequence


class _Slot:
    __slots__ = ("event", "result", "exc")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.exc: BaseException | None = None


_SHUTDOWN = object()


class DynamicBatcher:
    """Coalesces concurrent ``submit`` calls into batched ``run_batch`` calls.

    Args:
      run_batch: list of items -> sequence of per-item results (same order).
      max_batch: largest group handed to ``run_batch``.
      window_ms: after the first request of a group arrives, how long the
        worker waits for more before dispatching.  The latency cost is paid
        only when the queue is shallower than ``max_batch``; a backlogged
        queue dispatches full groups immediately.
    """

    def __init__(self, run_batch: Callable[[List[Any]], Sequence[Any]],
                 max_batch: int = 8, window_ms: float = 5.0,
                 name: str = "batcher"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._run_batch = run_batch
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1000.0
        # batches/items/max_group are written only by the worker thread;
        # timeouts by caller threads (GIL-atomic enough for monitoring) —
        # readers see a consistent-enough snapshot for /healthz and tests
        self.stats = {"batches": 0, "items": 0, "max_group": 0, "timeouts": 0,
                      "busy_s": 0.0}  # cumulative seconds inside run_batch
        # (occupancy: busy_s / wall — how loaded the device worker is)
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._busy_since: float | None = None
        self._worker = threading.Thread(
            target=self._loop, name=f"{name}-worker", daemon=True)
        self._worker.start()

    def submit(self, item: Any, timeout_s: float | None = None) -> Any:
        """Block until the item's group has run; return its result.

        With ``timeout_s``, raise TimeoutError instead of waiting forever
        on a stalled device step (the worker thread cannot be killed, but
        callers must not hang with it).  A timed-out item may still be
        computed later; its result is dropped.
        """
        if self._closed:
            raise RuntimeError("batcher is closed")
        slot = _Slot()
        self._q.put((item, slot))
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        # poll the worker's liveness: a submit that enqueues between
        # close()'s drain and the worker exiting would otherwise block
        # forever (its slot is never served).  The poll interval respects a
        # sub-second deadline (don't quantize timeouts up to 0.5 s).
        while True:
            wait = 0.5
            if deadline is not None:
                wait = max(0.0, min(wait, deadline - time.monotonic()))
            if slot.event.wait(wait):
                break
            if self._closed and not self._worker.is_alive():
                raise RuntimeError("batcher is closed")
            if deadline is not None and time.monotonic() > deadline:
                self.stats["timeouts"] += 1
                busy = self.busy_for_s()
                detail = (f" (device step stalled {busy:.0f}s)"
                          if busy > timeout_s else "")
                raise TimeoutError(
                    f"request timed out after {timeout_s:.0f}s{detail}")
        if slot.exc is not None:
            raise slot.exc
        return slot.result

    def busy_for_s(self) -> float:
        """Seconds the worker has spent inside the CURRENT run_batch call
        (0.0 when idle) — a stalled device step shows up here."""
        t0 = self._busy_since
        return 0.0 if t0 is None else time.monotonic() - t0

    def close(self) -> None:
        """Stop the worker; pending/future submits fail with RuntimeError."""
        self._closed = True
        self._q.put(_SHUTDOWN)
        self._worker.join(timeout=30)

    # ---- worker ----------------------------------------------------------

    def _collect(self):
        """One group: first item blocks, then drain up to the window/cap."""
        first = self._q.get()
        if first is _SHUTDOWN:
            return None
        group = [first]
        deadline = time.monotonic() + self.window_s
        while len(group) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                nxt = (self._q.get_nowait() if remaining <= 0
                       else self._q.get(timeout=remaining))
            except queue.Empty:
                break
            if nxt is _SHUTDOWN:
                # serve what we already collected, then shut down
                self._q.put(_SHUTDOWN)
                break
            group.append(nxt)
        return group

    def _loop(self):
        while True:
            group = self._collect()
            if group is None:
                # fail anything still queued behind the shutdown sentinel
                while True:
                    try:
                        entry = self._q.get_nowait()
                    except queue.Empty:
                        return
                    if entry is _SHUTDOWN:
                        continue
                    entry[1].exc = RuntimeError("batcher is closed")
                    entry[1].event.set()
            items = [item for item, _ in group]
            self._busy_since = t0 = time.monotonic()
            try:
                results = self._run_batch(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"run_batch returned {len(results)} results for "
                        f"{len(items)} items")
            except BaseException as e:  # noqa: BLE001 — must unblock callers
                for _, slot in group:
                    slot.exc = e
                    slot.event.set()
                continue
            finally:
                self._busy_since = None
                self.stats["busy_s"] += time.monotonic() - t0
            self.stats["batches"] += 1
            self.stats["items"] += len(items)
            self.stats["max_group"] = max(self.stats["max_group"], len(items))
            for (_, slot), res in zip(group, results):
                slot.result = res
                slot.event.set()


def bucket_size(n: int, max_batch: int) -> int:
    """Smallest power-of-two >= n, capped at max_batch (which is always a
    valid bucket even when not a power of two)."""
    if n >= max_batch:
        return max_batch
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)
