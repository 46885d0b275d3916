"""Process-level supervision of long resumable jobs: restart on stall or crash.

The port's copy of ``cp360_tpu/utils/supervise.py`` (host only).  On a
card the reasons to supervise are a job that is preempted or hangs (a
wedged kernel, a stuck data read): a fresh process is the cure, and the
pipelines are resumable (extraction skips written artifacts, the test CLI
skips finished videos, training resumes its full train state, the stream
CLI continues at the first missing map), so the missing piece is a parent
that notices "no forward progress" and relaunches the child until the job
completes.

Progress signals (either resets the stall clock):
  * a new/updated file under any of ``watch_paths`` (artifact writes);
  * any child stdout/stderr output (per-video banners, train records).

The child runs in its own process group; a stalled child gets SIGTERM (the
training loop's GracefulShutdown saves the full train state on it), then
SIGKILL after ``grace_s``.  The escalation matters on a card: a killed
child holds the card until it has exited, and a relaunched one would
contend with it.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence


def _newest_mtime(paths: Sequence[str]) -> float:
    """Newest activity timestamp under the watched paths.

    Stats DIRECTORY mtimes (a dir's mtime updates on every file create/
    rename inside it), not every file — a long extraction run accumulates
    tens of thousands of artifacts and a per-file sweep every poll would
    hammer the filesystem.  In-place file overwrites/appends don't bump
    the dir mtime, so watch such files explicitly (a file path stats the
    file itself, e.g. the training metrics JSONL) — and child stdout
    counts as progress independently of this.
    """
    newest = 0.0
    for root in paths:
        if not os.path.exists(root):
            continue
        if os.path.isfile(root):  # e.g. a metrics JSONL path
            try:
                newest = max(newest, os.stat(root).st_mtime)
            except OSError:
                pass
            continue
        for dirpath, _dirnames, _filenames in os.walk(root):
            try:
                newest = max(newest, os.stat(dirpath).st_mtime)
            except OSError:
                pass  # dir vanished mid-walk
    return newest


def supervise(
    cmd: List[str],
    watch_paths: Sequence[str],
    stall_timeout_s: float = 420.0,
    max_restarts: int = 5,
    grace_s: float = 10.0,
    poll_s: float = 2.0,
    fast_fail_backoff_s: float = 30.0,
    env: Optional[dict] = None,
    log=None,
) -> int:
    """Run ``cmd`` to completion, restarting it on stall or crash.

    Returns the final exit code (0 on success).  A run counts as stalled
    when ``stall_timeout_s`` passes with no child output AND no file
    activity under ``watch_paths``.  The default timeout clears a first
    call's kernel builds and a full-width checkpoint write.
    """
    if log is None:
        def log(msg):
            print(msg, file=sys.stderr, flush=True)

    restarts = 0
    while True:
        t_launch = time.time()
        last_activity = [time.time()]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            start_new_session=True, env=env,
        )

        def pump(p=proc, la=last_activity):
            # child output counts as progress and is forwarded verbatim
            for line in iter(p.stdout.readline, b""):
                la[0] = time.time()
                sys.stdout.buffer.write(line)
                sys.stdout.flush()

        reader = threading.Thread(target=pump, daemon=True)
        reader.start()

        stalled = False
        mtime_seen = _newest_mtime(watch_paths)
        while True:
            rc = proc.poll()
            if rc is not None:
                reader.join(timeout=5)
                break
            time.sleep(poll_s)
            mtime_now = _newest_mtime(watch_paths)
            if mtime_now > mtime_seen:
                mtime_seen = mtime_now
                last_activity[0] = time.time()
            if time.time() - last_activity[0] > stall_timeout_s:
                stalled = True
                log(f"supervise: no progress for {stall_timeout_s:.0f}s "
                    f"(pid {proc.pid}) — restarting")
                _kill_group(proc, grace_s)
                reader.join(timeout=5)
                rc = proc.poll()
                break

        if rc == 0 and not stalled:
            if restarts:
                log(f"supervise: completed after {restarts} restart(s)")
            return 0
        restarts += 1
        if restarts > max_restarts:
            log(f"supervise: giving up after {max_restarts} restarts "
                f"(last rc={rc})")
            return rc if isinstance(rc, int) and rc != 0 else 1
        reason = "stall" if stalled else f"exit rc={rc}"
        # a crash within seconds of launch is deterministic (bad flag,
        # missing file) — restarting would loop on it; brief backoff keeps
        # the supervisor from spinning while still retrying transient
        # device-init failures
        if not stalled and time.time() - t_launch < 15:
            log(f"supervise: fast failure ({reason}); backing off "
                f"{fast_fail_backoff_s:.0f}s")
            time.sleep(fast_fail_backoff_s)
        log(f"supervise: restart {restarts}/{max_restarts} after {reason}")


def strip_supervise_flag(argv: List[str]) -> List[str]:
    """Remove ``--supervise [STALL_S]`` / ``--supervise=STALL_S`` from an
    argv — the relaunched child must not re-enter the supervisor."""
    out, skip = [], False
    for i, tok in enumerate(argv):
        if skip:
            skip = False
            continue
        if tok == "--supervise":
            nxt = argv[i + 1] if i + 1 < len(argv) else ""
            try:
                float(nxt)
                skip = True  # consume the optional STALL_S value
            except ValueError:
                pass
            continue
        if tok.startswith("--supervise="):
            continue
        out.append(tok)
    return out


def run_supervised(module: str, argv: Optional[List[str]], watch_paths: Sequence[str],
                   stall_timeout_s: float, resume: bool = False, grace_s: float = 10.0) -> int:
    """Relaunch the CLI ``python -m <module>`` under :func:`supervise` with
    this process's arguments (``argv``, or ``sys.argv[1:]``) minus
    ``--supervise``; ``resume`` adds ``--resume`` so a restart continues
    instead of redoing.  ``module`` must be one of the port's CLIs.  One
    worker of a multi-process job is refused: supervise the whole launch."""
    if not module.startswith("cp360_tpu_torch."):
        raise ValueError(f"supervised child {module!r} is not a cp360_tpu_torch module")
    refuse_multiprocess_worker()
    child = strip_supervise_flag(list(argv) if argv is not None else sys.argv[1:])
    if resume and "--resume" not in child:
        child.append("--resume")
    return supervise([sys.executable, "-m", module] + child, watch_paths=watch_paths,
                     stall_timeout_s=stall_timeout_s, grace_s=grace_s)


def refuse_multiprocess_worker() -> None:
    """Exit when this process is one worker of a multi-process job: a
    relaunched worker cannot rejoin the running job, and every peer would
    hang in its next collective."""
    from cp360_tpu_torch.parallel.mesh import dist_requested, env_process_count

    if dist_requested() and env_process_count() > 1:
        raise SystemExit(
            "--supervise cannot wrap ONE worker of a multi-process job: "
            "a relaunched worker cannot rejoin the running "
            "torch.distributed job and every peer would hang in "
            "its next collective. Supervise the whole launch instead "
            "(wrap `python -m cp360_tpu_torch.cli.launch ...`).")


def _kill_group(proc: subprocess.Popen, grace_s: float) -> None:
    """SIGTERM the child's process group, escalate to SIGKILL."""
    try:
        pgid = os.getpgid(proc.pid)
    except ProcessLookupError:
        return
    try:
        os.killpg(pgid, signal.SIGTERM)
        t0 = time.time()
        while proc.poll() is None and time.time() - t0 < grace_s:
            time.sleep(0.2)
    finally:
        if proc.poll() is None:
            os.killpg(pgid, signal.SIGKILL)
            proc.wait(timeout=30)
