"""GPipe-style temporal pipelining of the ConvLSTM over a list of devices.

The port of ``cp360_tpu/parallel/pipeline.py``.  A recurrence cannot be
split over time without changing its result, but P devices can pipeline
microbatches of independent sequences: stage p holds time chunk p of the
rollout, and microbatch m is in stage p at tick m + p, so microbatch m + 1
runs in stage p - 1 while m runs in stage p.  The fill/drain bubble is
(P-1)/(n_micro + P - 1) of the ticks.

JAX runs the stages in one ``shard_map`` over a mesh axis and hands the
state down the pipe with ``ppermute``.  The port runs them in one process
over a device list, stage p on ``devices[p]``: every JAX caller of the pipe
(streaming, window inference, training) drives it from one controller, the
launches are asynchronous, so the stages on different cards run at once,
and the same code runs on ``["cpu"] * P`` in the tests and on
``[cuda:0] * P`` on one card.  The state (h, c) passes from stage p to
p + 1 by a copy between devices ordered by a CUDA event (no host sync), and
the backward comes from autograd through those copies.  Each stage runs the
serial rollout's ops in the serial order on its microbatch, so the result
equals ``clstm_rollout``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from cp360_tpu_torch.models.clstm import ConvLSTM, clstm_step


def make_pipe_devices(n_pipe: int, device="cuda") -> list:
    """The stages' devices: ``cuda:0..n_pipe-1`` on the card, raising when
    fewer cards exist; on the CPU, ``n_pipe`` times the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return [torch.device("cpu")] * n_pipe
    have = torch.cuda.device_count()
    if n_pipe > have:
        # fail here, not downstream: a silent truncation would run serial
        # while the user believes the job is pipelined
        raise ValueError(f"pipeline_stages={n_pipe} but only {have} device(s) are "
                         f"available on this host/runtime")
    return [torch.device("cuda", i) for i in range(n_pipe)]


def _hand_over(t: torch.Tensor, dst: torch.device) -> torch.Tensor:
    """``t`` on ``dst``: between two cards, a copy that the destination's
    stream starts after an event recorded on the source's stream."""
    src = t.device
    if src == dst or (src.type == dst.type == "cpu"):
        return t
    if src.type == dst.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(src))
        torch.cuda.current_stream(dst).wait_event(ev)
    return t.to(dst, non_blocking=True)


def pipelined_rollout(cell: ConvLSTM, seq: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                      devices: Sequence, n_micro: int, remat: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Roll the ConvLSTM over ``seq``, the time axis pipelined over
    ``devices`` (stage p on ``devices[p]``), the batch split into
    ``n_micro`` microbatches.

    Args:
      seq: [T, B, h, w, C] face-flattened batch (B = windows*6), time first.
        T must divide by the number of stages, B by n_micro.
      h0, c0: [B, h, w, Ch] initial state.
      remat: recompute each step in the backward pass, as ``clstm_rollout``
        does (``train_remat``).

    Returns (hiddens of the last chunk [T/P, B, ...], h_final, c_final) on
    ``seq``'s device; ``hiddens`` equals ``clstm_rollout(...)[0][-T/P:]``.
    """
    devices = [torch.device(d) for d in devices]
    n_pipe = len(devices)
    t, b = seq.shape[0], seq.shape[1]
    if t % n_pipe:
        raise ValueError(f"T={t} must divide over {n_pipe} pipe devices")
    if b % n_micro:
        raise ValueError(f"B={b} must divide into {n_micro} microbatches")
    if (b // n_micro) % 6:
        raise ValueError(
            f"microbatch size {b // n_micro} must be a multiple of 6 "
            f"(face-flattened batch; cube padding regroups faces)")
    tc, bm = t // n_pipe, b // n_micro
    weights = cell.weights()  # one cast of each weight per rollout, as serial
    stage_w, chunks = [], []
    for p, d in enumerate(devices):
        stage_w.append({name: tuple(w.to(d, non_blocking=True) for w in ws)
                        for name, ws in weights.items()})
        chunks.append(seq[p * tc:(p + 1) * tc].to(d, non_blocking=True))

    def step(x, h, c, w):
        return clstm_step(cell, x, (h, c), w)

    def run_chunk(p, x_chunk, h, c):
        hs = []
        for x in x_chunk:
            if remat:
                h, c = checkpoint(step, x, h, c, stage_w[p], use_reentrant=False)
            else:
                h, c = step(x, h, c, stage_w[p])
            hs.append(h)
        return torch.stack(hs), h, c

    state = {}  # microbatch -> (h, c) waiting on the next stage's device
    outs = [None] * n_micro
    for k in range(n_micro + n_pipe - 1):  # the tick schedule
        for p in range(n_pipe):
            m = k - p  # the microbatch in stage p at tick k
            if not 0 <= m < n_micro:
                continue
            rows = slice(m * bm, (m + 1) * bm)
            if p == 0:
                h, c = (_hand_over(s[rows], devices[0]) for s in (h0, c0))
            else:
                h, c = state.pop(m)
            hs, h, c = run_chunk(p, chunks[p][:, rows], h, c)
            if p == n_pipe - 1:
                outs[m] = (hs, h, c)
            else:
                state[m] = (_hand_over(h, devices[p + 1]), _hand_over(c, devices[p + 1]))
    home = seq.device
    hiddens = torch.cat([_hand_over(o[0], home) for o in outs], dim=1)
    h_f = torch.cat([_hand_over(o[1], home) for o in outs])
    c_f = torch.cat([_hand_over(o[2], home) for o in outs])
    return hiddens, h_f, c_f
