"""Multi-process launcher: starts N workers of one job on this host.

    python -m cp360_tpu_torch.cli.launch --nprocs 2 -- \
        python -m cp360_tpu_torch.cli.train_temporal --input arts --data-parallel 2

The port of ``cp360_tpu/cli/launch.py``.  Every CLI of the port joins a
``torch.distributed`` job when the rendezvous environment is set
(``parallel/mesh.py::maybe_init_distributed``); this launcher sets it for
each worker (``CP360_DIST``, ``CP360_COORDINATOR``,
``CP360_NUM_PROCESSES``, ``CP360_PROCESS_ID`` and ``CP360_LOCAL_RANK``, the
worker's index on this host, which picks its card), streams each worker's
output with a ``[pN]`` prefix, and takes the job down when the first worker
fails, or when the launcher itself gets SIGINT or SIGTERM: SIGTERM to the
rest (the training CLI saves its train state on it), SIGKILL after 30 s.  Across several hosts, run one launcher per host with
``--coordinator`` at host 0, ``--num-processes`` and ``--proc-id-offset``.

One card per rank is the rule; ``CP360_DIST_BACKEND=gloo`` in the
environment (passed on to the workers) lets ranks share a card, which NCCL
refuses.  The JAX launcher's ``--devices-per-proc`` (virtual CPU devices
per worker) has no meaning in torch and is refused.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading

KILL_AFTER_S = 30.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        own, cmd = argv[:split], argv[split + 1:]
    else:
        own, cmd = argv, []
    parser = argparse.ArgumentParser(description=__doc__,
                                     prog="python -m cp360_tpu_torch.cli.launch")
    parser.add_argument("--nprocs", type=int, required=True,
                        help="number of worker processes on this host")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="host:port of process 0 (default: a free local port, one host)")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="global process count (default: --nprocs; set it when "
                             "launching across several hosts)")
    parser.add_argument("--proc-id-offset", type=int, default=0,
                        help="first global process id owned by this host")
    parser.add_argument("--devices-per-proc", type=int, default=None,
                        help="refused: virtual CPU devices have no torch counterpart")
    args = parser.parse_args(own)
    if args.devices_per_proc is not None:
        parser.error("--devices-per-proc forces virtual CPU devices in the JAX package and "
                     "has no torch counterpart: a rank owns one card (or the CPU); set "
                     "CP360_DIST_BACKEND=gloo to have ranks share a card")
    if not cmd:
        parser.error("no worker command given (separate it with `--`)")

    coordinator = args.coordinator or f"127.0.0.1:{_free_port()}"
    num_processes = args.num_processes or args.nprocs

    procs: list = []
    pumps: list = []
    failed: list = []
    lock = threading.Lock()

    def pump(p, pid):
        for line in iter(p.stdout.readline, b""):
            sys.stdout.buffer.write(f"[p{pid}] ".encode() + line)
            sys.stdout.flush()

    for i in range(args.nprocs):
        pid = args.proc_id_offset + i
        env = dict(os.environ, CP360_DIST="1", CP360_COORDINATOR=coordinator,
                   CP360_NUM_PROCESSES=str(num_processes), CP360_PROCESS_ID=str(pid),
                   CP360_LOCAL_RANK=str(i))
        p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, start_new_session=True)
        procs.append(p)
        pumps.append(threading.Thread(target=pump, args=(p, pid), daemon=True))
        pumps[-1].start()

    def reap(p, pid):
        rc = p.wait()
        with lock:
            if rc != 0:
                failed.append((pid, rc))

    def on_term(signum, frame):  # a supervisor's SIGTERM takes the workers down too
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, on_term)
    reapers = [threading.Thread(target=reap, args=(p, args.proc_id_offset + i))
               for i, p in enumerate(procs)]
    for t in reapers:
        t.start()

    try:
        while any(t.is_alive() for t in reapers):
            for t in reapers:
                t.join(timeout=0.5)
            if failed:
                break
    except KeyboardInterrupt:
        failed.append(("launcher", "interrupted"))

    if failed:
        # take the survivors down; SIGTERM first (training checkpoints on it)
        print(f"launch: worker failure {failed[0]} — terminating the rest", file=sys.stderr)
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(os.getpgid(p.pid), signal.SIGTERM)
                except ProcessLookupError:
                    pass
        for p in procs:
            try:
                p.wait(timeout=KILL_AFTER_S)
            except subprocess.TimeoutExpired:
                try:
                    # the child can die (and be reaped) between the timeout and this kill
                    os.killpg(os.getpgid(p.pid), signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.wait()
        return 1
    for t in reapers + pumps:  # the pumps end at their worker's last line
        t.join()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
