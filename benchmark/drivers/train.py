"""Training the ConvLSTM through ``train/loop.py::make_train_step``, fed by
the port's own loader (``data/dataset.py``: ``WindowDataset`` and
``PrefetchLoader`` with the ``Config`` defaults for threads and depth),
each batch copied as ``train/loop.py::batch_to_device`` copies it: the
trainers' step.

Mix keys: ``videos`` of ``frames`` stage-1 artifacts each, written in
set-up into the run's temporary directory as extraction writes them (f16
CAM cubes [6, C, h, w] in ``cube_feat/``, f32 flows [flow_h, 2 flow_h, 2]
in ``motion/``), each video with its own CAM contrast and change, motion
and still share drawn from the ranges ``cam_contrast``, ``cam_change``,
``flow_px`` and ``still_share``; ``batch`` windows a step;
``check_steps`` steps checked.  The loader shuffles from the seed and
cycles epochs until the time is up.

Set-up builds the step, its model and its Adam state once and drives it
through ``check_steps`` steps on the loader's first batches (warming every
shape); that same object runs the window.  It keeps each of those steps'
loss, the first gradient's norm per leaf (from Adam's first moment after
one step) and the norm of each leaf's change after the last.  The check
replays those steps with the plain float32 reference from the artifact
files themselves (the loader's seeded order worked out again) and the same
initial weights.
"""

from __future__ import annotations

import sys
import time
from typing import List

import numpy as np
import torch

from benchmark.harness import Check, Run
from benchmark.lib import k1, port, weights
from benchmark.reference import model as ref

LEAVES = ("conv1", "conv2", "gates")
ZERO_GRAD_SHARE = 1e-3  # a leaf whose reference gradient is below this share
#   of the median leaf's moves by round-off alone under Adam: not compared


def videos(run: Run) -> List[str]:
    return [f"vid{v:03}" for v in range(run.traffic["videos"])]


def write_artifacts(run: Run) -> str:
    """``<tmp>/artifacts/<video>/{cube_feat,motion}/NNNNNN.npy``, frames
    0 .. frames-1 of each video.  Each video draws its own CAM contrast,
    frame-to-frame change, motion (a few tenths of a pixel to ten pixels)
    and still share, log-uniform over the mix's ranges, so that windows
    differ as a training set's scenes do."""
    import torch.nn.functional as F

    cfg, mix = run.config["config"], run.traffic
    n, c, h = mix["frames"], cfg["input_size"], cfg["cube_dim"] // 32
    fh = cfg["flow_h"]
    root = run.tmp / "artifacts"
    gen = torch.Generator(device=run.device)
    gen.manual_seed(run.seed + 3)

    def draw(lo, hi):
        u = float(torch.rand((), generator=gen, device=run.device))
        return lo * (hi / lo) ** u

    for vid in videos(run):
        feat, motion = root / vid / "cube_feat", root / vid / "motion"
        feat.mkdir(parents=True)
        motion.mkdir(parents=True)
        contrast, change = draw(*mix["cam_contrast"]), draw(*mix["cam_change"])
        px, still = draw(*mix["flow_px"]), draw(*mix["still_share"])
        base = torch.rand((6, c, h, h), generator=gen, device=run.device) * contrast
        drift = torch.randn((n, 6, c, h, h), generator=gen, device=run.device)
        cams = torch.relu(base + change * drift).to(torch.float16).cpu().numpy()
        coarse = torch.randn((n, 2, fh // 32, fh // 16), generator=gen, device=run.device)
        flows = F.interpolate(coarse, size=(fh, 2 * fh), mode="bilinear",
                              align_corners=False) * px
        flows[:, :, :, : int(2 * fh * still)] = 0.0  # still columns: the motion mask's work
        flows = flows.permute(0, 2, 3, 1).contiguous().cpu().numpy()
        for i in range(n):
            np.save(feat / f"{i:06}.npy", cams[i])
            np.save(motion / f"{i:06}.npy", flows[i])
    return str(root)


def loader_seed(run: Run) -> int:
    return run.seed % (2 ** 31)


class State:
    pass


def _norms(tensors) -> List[float]:
    return [float(torch.linalg.vector_norm(t.float())) for t in tensors]


def setup(run: Run) -> State:
    from cp360_tpu_torch.data.dataset import PrefetchLoader, WindowDataset
    from cp360_tpu_torch.train import loop

    st = State()
    st.cfg = cfg = port.program_config(run.config)
    st.root = write_artifacts(run)
    run.note("artifacts written")
    cl = weights.for_config(run.config, run.seed, run.device, backbone=False,
                            clstm_dtype=torch.float32)["cl"]
    run.note("weights made")
    st.model = port.clstm(run.config, cl, trainable=True)
    del cl
    st.opt = loop.make_optimizer(cfg, st.model)
    run.note("optimizer built")
    st.step = loop.make_train_step(cfg, st.model, st.opt)
    ds = WindowDataset(st.root, None, videos(run), cfg.seq_len)
    st.loader = PrefetchLoader(ds, batch_size=run.traffic["batch"], shuffle=True,
                               seed=loader_seed(run), num_threads=cfg.processes,
                               transfer_codec=cfg.transfer_codec)
    st.batches = _epochs(st.loader)
    run.note("step, model, optimizer and loader built")
    params = [getattr(st.model, f"{n}_{k}") for n in LEAVES for k in ("w", "b")]
    st.losses = []
    for i in range(run.traffic["check_steps"]):
        st.losses.append(float(_run_step(run, st)["loss"]))
        if i == 0:  # Adam's first moment after one step is 0.1 of the gradient
            st.grad_norms = _norms(st.opt.state[p]["exp_avg"] / 0.1 for p in params)
    p0 = weights.for_config(run.config, run.seed, run.device, backbone=False,
                            clstm_dtype=torch.float32)["cl"]
    st.change_norms = _norms(getattr(st.model, f"{n}_{k}").detach() - p0[n][k]
                             for n in LEAVES for k in ("w", "b"))
    del p0
    run.note("first steps run")
    if run.trace:
        k1.record_calls(run)
    return st


def _epochs(loader):
    while True:
        yield from loader


def _run_step(run: Run, st: State):
    from cp360_tpu_torch.train.loop import batch_to_device

    with run.span("loader.next"):
        batch = next(st.batches)
    return st.step(*(batch_to_device(x, run.device) for x in batch))


def window(run: Run, st: State) -> dict:
    run.spans.clear()
    t0 = time.perf_counter()
    end = t0 + run.seconds
    losses = []
    while True:
        losses.append(_run_step(run, st)["loss"])
        run.tick()
        if time.perf_counter() >= end:
            break
    total = torch.stack(losses).float()
    bad = int((~torch.isfinite(total)).sum())  # waits for the last step
    run.window_s = time.perf_counter() - t0
    n = len(losses) * run.traffic["batch"]
    run.counters["windows"] = n
    return {"metrics": {"train_windows_per_s": n / run.window_s},
            "attempted": len(losses), "failed": bad}


def release(run: Run, st: State) -> None:
    st.batches.close()
    st.model = st.opt = st.step = st.loader = st.batches = None


def reference_batches(run: Run, st: State):
    """The loader's first ``check_steps`` batches, read from the files: in
    each video (in name order) a window starts at every frame with
    seq_len - 1 after it, and ``RandomState(seed).shuffle`` orders them."""
    cfg = run.config["config"]
    seq_len, bsz = cfg["seq_len"], run.traffic["batch"]
    starts = [(vid, i) for vid in videos(run) for i in range(run.traffic["frames"] - seq_len)]
    order = np.arange(len(starts))
    np.random.RandomState(loader_seed(run)).shuffle(order)
    for b in range(run.traffic["check_steps"]):
        wins = [starts[k] for k in order[b * bsz:(b + 1) * bsz]]

        def read(kind):
            return np.stack([[np.load(f"{st.root}/{vid}/{kind}/{s + t:06}.npy")
                              for t in range(seq_len)] for vid, s in wins])

        seq = torch.from_numpy(read("cube_feat")).to(run.device).float()
        yield seq.permute(0, 1, 2, 4, 5, 3), torch.from_numpy(read("motion")).to(run.device)


def replay(run: Run, st: State, quant=None, half: bool = False):
    """(losses, first gradient norms, change norms) of the reference; with
    ``half``, each step on the first half of its batch, the loss scaled to
    the whole batch (the fault of a step that leaves half the batch out)."""
    cfg = run.config["config"]
    cl = weights.for_config(run.config, run.seed, run.device, backbone=False,
                            clstm_dtype=torch.float32)["cl"]
    leaves = [cl[n][k].clone().requires_grad_(True) for n in LEAVES for k in ("w", "b")]
    p0 = [t.detach().clone() for t in leaves]
    params = {n: {"w": leaves[2 * i], "b": leaves[2 * i + 1]} for i, n in enumerate(LEAVES)}
    adam = ref.Adam(leaves, run.config["config"].get("lr", 1e-6))
    kw = {k: cfg.get(k, d) for k, d in (("l_s", 0.7), ("l_t", 1.0), ("l_m", 0.01),
                                        ("mm_th", 0.15), ("flow_h", 480))}
    losses, g1 = [], None
    for seq, flows in reference_batches(run, st):
        b = seq.shape[0] // 2 if half else seq.shape[0]
        loss = ref.train_loss(params, seq[:b], flows[:b], quant=quant, **kw) * (seq.shape[0] / b)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if g1 is None:
            g1 = _norms(grads)
        adam.step(grads)
    return losses, g1, _norms(p.detach() - q for p, q in zip(leaves, p0))


def leaf_gap(got: List[float], want: List[float], keep: List[bool]) -> float:
    """The worst leaf's gap of norms, over the larger of that leaf's
    reference norm and the median leaf's."""
    med = float(np.median([w for w, k in zip(want, keep) if k]))
    return max(abs(g - w) / max(w, med) for g, w, k in zip(got, want, keep) if k)


def check(run: Run, st: State) -> List[Check]:
    """The first step's loss (the later steps' follow Adam's first update,
    lr * sign(g) on every element, so the sign of each near-zero gradient
    element moves them; PERF.md gives both readings), the first gradient's
    norm by the worst leaf and the change's norm after the set-up's steps by
    the worst leaf."""
    ref.exact_f32()
    want = replay(run, st)
    if run.control == "fp8":
        got = replay(run, st, ref.quantize_fp8)
    elif run.control == "half":
        got = replay(run, st, half=True)
    else:
        got = (st.losses, st.grad_norms, st.change_norms)
    med = float(np.median(want[1]))
    keep = [g >= ZERO_GRAD_SHARE * med for g in want[1]]
    steps = [abs(g - w) / abs(w) for g, w in zip(got[0], want[0])]
    print(f"train check: loss gaps by step {steps}; losses {got[0]} vs {want[0]}; gradient "
          f"norms {got[1]} vs {want[1]}; changes {got[2]} vs {want[2]}; leaves compared "
          f"{keep}", file=sys.stderr, flush=True)
    lim = run.cell["limits"]
    return [Check("loss_gap", steps[0], lim["loss_gap"]),
            Check("grad_gap", leaf_gap(got[1], want[1], keep), lim["grad_gap"]),
            Check("change_gap", leaf_gap(got[2], want[2], keep), lim["change_gap"])]
