"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase (what a chip check runs)
    python3 chip_smoke.py --phases kernels

Phases, in order; any failure exits non-zero before the result lines:

1. build: compile every kernel of ``cp360_tpu_torch/csrc/`` (one nvcc per
   source, all started together), print each kernel's register and
   shared-memory use, and fail if ptxas spilled registers anywhere.
2. kernels: hold each hand kernel against its plain PyTorch version on the
   card at the shapes the serving and training paths give it, and time
   kernel, plain version and (where one exists) the library call.
   - K1 ``cube_conv3x3``: bf16 [8,6,7,7,2000]->4000, [8,6,7,7,4000]->4000
     (a full bucket of 8 windows), [1,6,7,7,4000]->4000 and
     [1,6,7,7,2000]->4000 (one window) (kernel on bf16 inputs vs the plain
     version in f32 on the same bf16-rounded inputs: max|err| <= 1e-2
     max|ref|; both accumulate in f32, so they differ by summation order and
     the kernel's one bf16 rounding, at most one bf16 ulp ~0.4%), and f32
     [2,6,7,7,2000]->4000 (max|err| <= 1e-4 max|ref| + 1e-4).
   - K1 dx ``cube_conv3x3_dx`` (the input gradient): bf16 dy [8,6,7,7,4000]
     -> dx at Cin 4000 and 2000, bf16 [1,...,4000] -> 4000 and f32
     [2,...,4000] -> 2000, against autograd of the plain cube pad + conv in
     f32 on the same inputs, at the forward's tolerances.
   - For each K1 and dx shape also: TFLOP/s, the depth splits the wrapper
     chose, and a second launch that must equal the first bit for bit.
     Then the bf16 forward and dx at every split count, at 8 windows and at
     one (the evidence for ``cube_conv.depth_splits``).
   - K2 ``equi_to_cube``: u8 [8,960,1920,3] -> [8,6,224,224,3] f32,
     max|err| <= 1e-6.
   - K3 ``cube_pool3x3s2`` (the stem's cube-padded 3x3/s2 max pool): bf16
     [8,6,112,112,64] (a serving bucket), [16,6,112,112,64] (an extraction
     batch), f32 [2,6,112,112,64], and bf16 [8,...] with +-inf and NaN
     planted on face edges and corners: bit for bit (equal bits wherever
     the plain version is not NaN, NaN where it is).  Its plain version,
     cube pad + ``F.max_pool2d``, is also the only PyTorch yardstick, so
     library ms is the plain version's time.
3. slice: ``SaliencyModel(device="cuda")`` at full width (ResNet-50,
   224 faces of 960x1920 frames, 1000-class CAM, ConvLSTM 1000/1000,
   seq_len 5, bf16, all-device stage 1, seeded random weights) serves
   ``predict`` calls and two temporal sessions from several threads.  It
   checks shapes and finite values, that every ConvLSTM conv went through
   K1 and every stage-1 equi->cube and stem pool through K2 and K3 (launch
   counts against the batchers' batch counts), that each session's prediction equals offline
   ``window_infer`` on the session's cubes, and that one frame and one
   window recomputed in f32 on the card agree with the plain f32 path on
   the CPU.
4. train: seeded synthetic stage-1 artifacts (two train_60 videos of 8
   frames: [6,1000,7,7] f16 CAM cubes, [480,960,2] f32 flows) feed
   ``cli.train_temporal.main(["--device", "cuda", ...])`` at full width
   (ConvLSTM 1000/1000, seq_len 5, flow_h 480, bf16 convs, f32 masters,
   batch 1): 6 Adam steps.  It checks finite losses, changed weights, the
   epoch checkpoint read back by ``load_npz``, 15 K1 launches and 14 dx
   launches per step (the first conv of a rollout reads data only: its
   input x[0] needs no gradient).  Then it times the step at batch 1 and 8
   (median of 3 after warm-up), profiles one step of each, and runs one f32
   step (TF32 off) at ConvLSTM 64/64 on the card and on the CPU's plain
   path: loss parts within 1e-4 relative, gradients within 1e-3 of each
   tensor's largest, updated weights within 0.2 lr where the gradient's
   sign is well defined (|g| > 1e-4 max|g|) and within 2 lr everywhere.

5. video: the offline pipeline at full width (ResNet-50, 1000 classes,
   960x1920 frames, 224 faces, ConvLSTM 1000/1000, seq_len 5, bf16,
   ``host_cube_remap: false``, seeded weights).
   - ``extract_frames`` on two test_25 videos of 24 seeded frames with
     ``-of -oi`` (batches of 16: one full, one padded tail each): names
     from 000002, [6,1000,7,7] f16 artifacts, one K2 and one K3 launch per
     batch, and the first batch equal to ``stage1_batch`` on its frames.
   - ``cli.extract_features`` on ``tests/golden/e2e_full``'s mp4s (cv2) in
     f32: CAMs within 0.02 relative of the golden's, as
     ``tests/test_e2e_golden_full.py``, once all on the device (K2 + K3)
     and once with the host cv2 remap and the int8 codec (K3 only).
   - ``cli.test_temporal`` in f32 on the scaled golden's feats
     (``tests/golden/e2e``): predictions to atol 2e-5 / rtol 1e-4 and the
     aggregate to 1e-4, as ``tests/test_e2e_golden.py``.
   - the same CLI at full width on ``e2e_full``'s f16-stored feats, in f32:
     within the drift that f16 storage alone causes in the JAX package
     (``tools/e2e_full_f16_drift.py``) plus a margin; then in bf16, printed
     against the card's f32 run.
   - the same CLI in bf16 on the extracted artifacts with seeded synthetic
     GT: finite metrics, 15 K1 launches per window batch.
   - then, outside the counted runs: frames/s of extraction with artifacts
     only, windows/s of ``infer_video`` at 64 windows per batch (disk reads
     included), and a profile of a 16-frame stage-1 step with K3's row.

The last lines are ``{"kernels": [...]}``, the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.  TF32 is switched off throughout, so every f32 product on the card
is a true f32 product.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
SEED = 0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    """(least time in ms, what bounds it) at the H100's published peaks."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- phase 1: build ----------------------------------------------------------


def phase_build() -> None:
    from cp360_tpu_torch.ops import _build

    t0 = time.monotonic()
    logs = _build.build()
    spills = []
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"[ptxas {name}] {line.strip()}")
            if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                spills.append(f"{name}: {line.strip()}")
    print(f"build: {sorted(logs) or 'cached'} in {time.monotonic() - t0:.1f} s",
          flush=True)
    if spills:
        fail(f"ptxas spilled registers: {spills}")


# ---- phase 2: kernels vs their plain versions --------------------------------


def check_cube_conv(n: int, cin: int, cout: int, dtype: torch.dtype, gen) -> dict:
    from cp360_tpu_torch.ops import cube_conv

    dev = "cuda"
    x = torch.randn(n, 6, 7, 7, cin, generator=gen, device=dev).to(dtype)
    w = (torch.randn(3, 3, cin, cout, generator=gen, device=dev)
         * (2.0 / (9 * cin)) ** 0.5).to(dtype)
    b = (torch.randn(cout, generator=gen, device=dev) * 0.1).to(dtype)
    xf, wf, bf = x.float(), w.float(), b.float()

    got = cube_conv.cube_conv3x3(x, w, b)
    again = cube_conv.cube_conv3x3(x, w, b)
    ref = cube_conv.cube_conv3x3_plain(xf, wf, bf)
    torch.cuda.synchronize()
    repeat_equal = torch.equal(got, again)  # bit for bit, NaN-free outputs
    got = got.float()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    if dtype == torch.bfloat16:
        tol = 1e-2 * scale
    else:
        tol = 1e-4 * scale + 1e-4
    ok = bool(err <= tol) and bool(torch.isfinite(got).all()) and repeat_equal

    ms = cuda_ms(lambda: cube_conv.cube_conv3x3(x, w, b))
    plain_ms = cuda_ms(lambda: cube_conv.cube_conv3x3_plain(xf, wf, bf), iters=5)
    # yardstick only (never called by the port): cube pad + cuDNN conv in
    # the working dtype
    library_ms = cuda_ms(lambda: cube_conv.cube_conv3x3_plain(x, w, b))
    m = n * 6 * 49
    size = x.element_size()
    n_bytes = (x.numel() + w.numel() + b.numel() + m * cout) * size
    n_ops = 2.0 * m * 9 * cin * cout
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    bms, by = bound_ms(n_bytes, n_ops, peak)
    res = {"shape": f"{str(dtype).split('.')[-1]} x[{n},6,7,7,{cin}] -> {cout}",
           "max_abs_err": err, "max_abs_ref": scale, "tol": tol, "passed": ok,
           "repeat_bit_equal": repeat_equal, "splits": depth_splits(dtype, cout, cin),
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bms, "bound_by": by,
           "tflops": n_ops / (ms * 1e-3) / 1e12}
    print(f"K1 cube_conv3x3 {json.dumps(res)}", flush=True)
    return res


def depth_splits(dtype: torch.dtype, n: int, k: int) -> int:
    """The depth splits the wrapper picks for a conv on 7x7 cubes (1 in f32)."""
    from cp360_tpu_torch.ops import cube_conv

    if dtype != torch.bfloat16:
        return 1
    return cube_conv.depth_splits(294, n, k, torch.cuda.get_device_properties(0).multi_processor_count)


def split_sweep(n: int, cin: int, cout: int, gen) -> dict:
    """ms of the bf16 forward and dx at every depth split count, outside
    the counted runs: the evidence for ``cube_conv.depth_splits``."""
    from cp360_tpu_torch.ops import cube_conv

    x = torch.randn(n, 6, 7, 7, cin, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(3, 3, cin, cout, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    b = torch.zeros(cout, device="cuda", dtype=torch.bfloat16)
    dy = torch.randn(n, 6, 7, 7, cout, generator=gen, device="cuda").to(torch.bfloat16)
    res = {"shape": f"bf16 [{n},6,7,7,{cin}] -> {cout}",
           "rule": {"fwd": depth_splits(torch.bfloat16, cout, cin),
                    "dx": depth_splits(torch.bfloat16, cin, cout)}}
    for s in range(1, cube_conv.MAX_SPLITS + 1):
        res[f"fwd_ms_{s}"] = cuda_ms(lambda: cube_conv._forward(x, w, b, splits=s), iters=10)
        res[f"dx_ms_{s}"] = cuda_ms(lambda: cube_conv._dx(dy, w, splits=s), iters=10)
    print(f"K1 split sweep {json.dumps(res)}", flush=True)
    return res


def library_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Yardstick only, never called by the port: cuDNN's backward-data on
    the cube-padded faces (``torch.nn.grad.conv2d_input``) in the working
    dtype, then the cube pad's gradient folded back with ``index_add_``."""
    from cp360_tpu_torch.ops.cube_pad import build_cube_pad_index_map

    n, _, h, ww, cout = dy.shape
    cin = w.shape[2]
    dxp = torch.nn.grad.conv2d_input((n * 6, cin, h + 2, ww + 2), w.permute(3, 2, 0, 1),
                                     dy.reshape(n * 6, h, ww, cout).permute(0, 3, 1, 2))
    idx = torch.from_numpy(build_cube_pad_index_map(h, ww, (1, 1, 1, 1)).reshape(-1))
    dxp = dxp.permute(0, 2, 3, 1).reshape(n, -1, cin)
    dx = torch.zeros((n, 6 * h * ww, cin), dtype=dy.dtype, device=dy.device)
    return dx.index_add_(1, idx.to(dy.device).long(), dxp)


def check_cube_conv_dx(n: int, cin: int, cout: int, dtype: torch.dtype, gen) -> dict:
    from cp360_tpu_torch.ops import cube_conv

    dev = "cuda"
    dy = torch.randn(n, 6, 7, 7, cout, generator=gen, device=dev).to(dtype)
    w = (torch.randn(3, 3, cin, cout, generator=gen, device=dev)
         * (2.0 / (9 * cin)) ** 0.5).to(dtype)
    dyf, wf = dy.float(), w.float()

    got = cube_conv.cube_conv3x3_dx(dy, w)
    again = cube_conv.cube_conv3x3_dx(dy, w)
    ref = cube_conv.cube_conv3x3_dx_plain(dyf, wf)
    torch.cuda.synchronize()
    repeat_equal = torch.equal(got, again)
    got = got.float()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    tol = 1e-2 * scale if dtype == torch.bfloat16 else 1e-4 * scale + 1e-4
    ok = bool(err <= tol) and bool(torch.isfinite(got).all()) and repeat_equal

    ms = cuda_ms(lambda: cube_conv.cube_conv3x3_dx(dy, w))
    plain_ms = cuda_ms(lambda: cube_conv.cube_conv3x3_dx_plain(dyf, wf), iters=5)
    library_ms = cuda_ms(lambda: library_dx(dy, w))
    m = n * 6 * 49
    size = dy.element_size()
    n_bytes = (dy.numel() + w.numel() + m * cin) * size
    n_ops = 2.0 * m * 9 * cin * cout
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    bms, by = bound_ms(n_bytes, n_ops, peak)
    res = {"shape": f"{str(dtype).split('.')[-1]} dy[{n},6,7,7,{cout}] -> dx Cin {cin}",
           "max_abs_err": err, "max_abs_ref": scale, "tol": tol, "passed": ok,
           "repeat_bit_equal": repeat_equal, "splits": depth_splits(dtype, cin, cout),
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bms, "bound_by": by,
           "tflops": n_ops / (ms * 1e-3) / 1e12}
    print(f"K1dx cube_conv3x3_dx {json.dumps(res)}", flush=True)
    return res


def check_equi_to_cube(n: int, gen) -> dict:
    from cp360_tpu_torch.ops import equi_gather

    dev = "cuda"
    frames = torch.randint(0, 256, (n, 960, 1920, 3), generator=gen, device=dev,
                           dtype=torch.int64).to(torch.uint8)
    got = equi_gather.equi_to_cube(frames, 224)
    ref = equi_gather.equi_to_cube_plain(frames, 224)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    ok = bool(err <= 1e-6) and tuple(got.shape) == (n, 6, 224, 224, 3)

    ms = cuda_ms(lambda: equi_gather.equi_to_cube(frames, 224), iters=50)
    plain_ms = cuda_ms(lambda: equi_gather.equi_to_cube_plain(frames, 224), iters=5)
    n_out = n * 6 * 224 * 224 * 3
    n_bytes = frames.numel() + 4 * n_out  # u8 frames in, f32 faces out
    # per output value: 4 taps /255, 4 weight products, 3 adds
    n_ops = 11.0 * n_out
    bms, by = bound_ms(n_bytes, n_ops, H100_F32_FLOPS)
    res = {"shape": f"u8 [{n},960,1920,3] -> [{n},6,224,224,3] f32",
           "max_abs_err": err, "tol": 1e-6, "passed": ok, "ms": ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": bms,
           "bound_by": by, "gbytes_per_s": n_bytes / (ms * 1e-3) / 1e9}
    print(f"K2 equi_to_cube {json.dumps(res)}", flush=True)
    return res


def pool_input(n: int, dtype: torch.dtype, gen, specials: bool) -> torch.Tensor:
    """[n,6,112,112,64] stem activations, distinct per face; with
    ``specials``, +-inf and NaN on face edges and corners (they feed the
    neighbours' halos) and in the interior."""
    x = torch.randn(n, 6, 112, 112, 64, generator=gen, device="cuda")
    x += torch.arange(6, device="cuda", dtype=torch.float32).reshape(1, 6, 1, 1, 1)
    if specials:
        nan, inf = float("nan"), float("inf")
        x[0, 0, 0, 0, 0] = nan
        x[0, 5, 0, 111, 1] = inf
        x[n - 1, 3, 111, 0, 2] = -inf
        x[n - 1, 2, 0, 57, 3] = nan
        x[0, 1, 111, 31, 63] = nan
        x[n - 1, 4, :, 0, 40] = -inf
        x[0, 4, 50, 111, 7] = inf
        x[0, 2, 60, 60, 8] = nan
    return x.to(dtype)


def check_cube_pool(n: int, dtype: torch.dtype, gen, specials: bool = False) -> dict:
    from cp360_tpu_torch.ops import cube_pool

    x = pool_input(n, dtype, gen, specials)
    got = cube_pool.cube_pad_max_pool_3x3s2(x)
    ref = cube_pool.cube_pad_max_pool_3x3s2_plain(x)
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    same_nan = torch.equal(torch.isnan(got), nan)
    same_bits = torch.equal(got.view(ints)[~nan], ref.view(ints)[~nan])
    finite = ~nan & torch.isfinite(ref)
    err = (got.float()[finite] - ref.float()[finite]).abs().max().item()
    ok = bool(same_nan and same_bits) and tuple(got.shape) == (n, 6, 56, 56, 64)

    ms = cuda_ms(lambda: cube_pool.cube_pad_max_pool_3x3s2(x), iters=50)
    plain_ms = cuda_ms(lambda: cube_pool.cube_pad_max_pool_3x3s2_plain(x), iters=20)
    n_bytes = (x.numel() + got.numel()) * x.element_size()
    n_ops = 8.0 * got.numel()  # 8 compares per output value
    bms, by = bound_ms(n_bytes, n_ops, H100_F32_FLOPS)
    res = {"shape": f"{str(dtype).split('.')[-1]} [{n},6,112,112,64]"
                    + (" +-inf/NaN" if specials else ""),
           "max_abs_err": err, "tol": 0.0, "bit_equal": bool(same_bits),
           "nan_equal": bool(same_nan), "nans": int(nan.sum().item()), "passed": ok,
           "ms": ms, "plain_ms": plain_ms, "library_ms": plain_ms, "bound_ms": bms,
           "bound_by": by, "gbytes_per_s": n_bytes / (ms * 1e-3) / 1e9}
    print(f"K3 cube_pool3x3s2 {json.dumps(res)}", flush=True)
    return res


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    k1 = [check_cube_conv(8, 2000, 4000, torch.bfloat16, gen),
          check_cube_conv(8, 4000, 4000, torch.bfloat16, gen),
          check_cube_conv(1, 4000, 4000, torch.bfloat16, gen),
          check_cube_conv(1, 2000, 4000, torch.bfloat16, gen),
          check_cube_conv(2, 2000, 4000, torch.float32, gen)]
    k1dx = [check_cube_conv_dx(8, 4000, 4000, torch.bfloat16, gen),
            check_cube_conv_dx(8, 2000, 4000, torch.bfloat16, gen),
            check_cube_conv_dx(1, 4000, 4000, torch.bfloat16, gen),
            check_cube_conv_dx(2, 2000, 4000, torch.float32, gen)]
    for n in (8, 1):
        split_sweep(n, 4000, 4000, gen)
    k2 = check_equi_to_cube(8, gen)
    k3 = [check_cube_pool(8, torch.bfloat16, gen),
          check_cube_pool(16, torch.bfloat16, gen),
          check_cube_pool(2, torch.float32, gen),
          check_cube_pool(8, torch.bfloat16, gen, specials=True)]
    bad = [r["shape"] for r in k1 + k1dx + [k2] + k3 if not r["passed"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    # the JSON line reports the dominant main-path conv (2 of the 3 per
    # step) and the stem pool at an extraction batch of 16
    return {"cube_conv3x3": k1[1], "cube_conv3x3_dx": k1dx[0], "equi_to_cube": k2,
            "cube_pool3x3s2": k3[1]}


# ---- phase 3: the serving slice ----------------------------------------------


def phase_slice() -> dict:
    from cp360_tpu_torch.compat import jax_params
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.ops import cube_conv, cube_pool, equi_gather
    from cp360_tpu_torch.pipelines.extract import stage1_batch
    from cp360_tpu_torch.pipelines.temporal import window_infer
    from cp360_tpu_torch.serving.server import SaliencyModel

    cfg = Config(cube_dim=224, equi_h=1920, equi_w=960, input_size=1000,
                 hidden_size=1000, seq_len=5, compute_dtype="bfloat16",
                 host_cube_remap=False, clstm_conv_impl="pallas",
                 serve_max_batch=8, serve_batch_window_ms=5.0)
    t0 = time.monotonic()
    params = jax_params.init_resnet_params(SEED, "resnet50", 1000)
    clstm_params = jax_params.init_clstm_params(SEED + 1, 1000, 1000)
    model = SaliencyModel(params, cfg, clstm_params=clstm_params, device="cuda")
    print(f"slice: model built in {time.monotonic() - t0:.1f} s", flush=True)
    t0 = time.monotonic()
    model.warmup()
    torch.cuda.synchronize()
    print(f"slice: warmup {time.monotonic() - t0:.1f} s", flush=True)

    rng = np.random.RandomState(SEED)
    h, w = cfg.frame_hw
    frames = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(8)]
    sessions = [[rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(6)]
                for _ in range(2)]
    latency = {"predict": [], "temporal": []}
    lat_lock = threading.Lock()

    def predict(frame):
        t = time.monotonic()
        sal = model.predict(frame)
        with lat_lock:
            latency["predict"].append(time.monotonic() - t)
        return sal

    def run_session(session_frames):
        sid = model.temporal_start()
        out = []
        for frame in session_frames:
            t = time.monotonic()
            idx, sal = model.temporal_push(sid, frame)
            with lat_lock:
                latency["temporal"].append(time.monotonic() - t)
            window = list(model._sessions[sid]["frames"])
            out.append((idx, sal, window))
        model.temporal_close(sid)
        return out

    stage1_b0 = model._batcher.stats["batches"]
    temporal_b0 = model._temporal_batcher.stats["batches"]
    cube_conv.launches = 0
    equi_gather.launches = 0
    cube_pool.launches = 0
    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=6) as pool:
        sess_futs = [pool.submit(run_session, s) for s in sessions]
        pred_futs = [pool.submit(predict, f) for f in frames + frames]
        preds = [f.result() for f in pred_futs]
        sess_out = [f.result() for f in sess_futs]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    k1_launches, k2_launches = cube_conv.launches, equi_gather.launches
    k3_launches = cube_pool.launches
    stage1_batches = model._batcher.stats["batches"] - stage1_b0
    temporal_batches = model._temporal_batcher.stats["batches"] - temporal_b0

    for sal in preds:
        if sal.shape != (14, 28) or not np.isfinite(sal).all():
            fail(f"predict gave shape {sal.shape}, finite={np.isfinite(sal).all()}")
    served = []
    for out in sess_out:
        for idx, sal, window in out:
            if idx < cfg.seq_len - 1:
                if sal is not None:
                    fail(f"session answered frame {idx} before seq_len frames")
                continue
            if sal is None or sal.shape != (14, 28) or not np.isfinite(sal).all():
                fail(f"temporal frame {idx} gave {None if sal is None else sal.shape}")
            served.append((sal, window))
    if len(served) != 4:
        fail(f"expected 4 temporal predictions, got {len(served)}")
    print(f"slice: {len(preds)} predicts + {sum(len(s) for s in sessions)} "
          f"temporal pushes; stage-1 batches {stage1_batches}, window batches "
          f"{temporal_batches}; K1 launches {k1_launches}, K2 launches "
          f"{k2_launches}, K3 launches {k3_launches}", flush=True)
    if k1_launches == 0 or k2_launches == 0 or k3_launches == 0:
        fail("a kernel of the path was never launched")
    if k1_launches != 3 * cfg.seq_len * temporal_batches:
        fail(f"K1 launched {k1_launches} times for {temporal_batches} window batches")
    if k2_launches != stage1_batches or k3_launches != stage1_batches:
        fail(f"K2 launched {k2_launches} and K3 {k3_launches} times for "
             f"{stage1_batches} stage-1 batches")

    # protocol: a session's prediction is offline window_infer on its cubes
    # (to float-rounding: cuBLAS may pick another product kernel for the
    # cube->equi matmul at another batch size)
    with torch.no_grad():
        for sal, window in served:
            offline = window_infer(model.clstm, torch.stack(window)[None])
            offline = offline.cpu().numpy()[0]
            err = float(np.abs(offline - sal).max())
            if err > 1e-5 * float(np.abs(offline).max()):
                fail(f"served prediction differs from offline window_infer by {err}")

    # f32 on the card (kernels, TF32 off) vs the plain f32 path on the CPU
    from cp360_tpu_torch.compat.jax_params import clstm_from_params, resnet_from_params

    errs = {}
    with torch.no_grad():
        frame = torch.from_numpy(frames[0])[None]
        window = torch.stack(served[0][1])[None].float()
        outs = {}
        for dev in ("cuda", "cpu"):
            resnet = resnet_from_params(params, "resnet50", True, torch.float32, dev)
            clstm = clstm_from_params(clstm_params, torch.float32, True, "pallas", dev)
            scores, sal = stage1_batch(resnet, frame.to(dev), 224)
            pred = window_infer(clstm, window.to(dev))
            outs[dev] = [t.cpu().numpy() for t in (scores, sal, pred)]
            del resnet, clstm
        for name, g, r in zip(("cam", "saliency", "window"), outs["cuda"], outs["cpu"]):
            err = float(np.abs(g - r).max())
            errs[name] = (err, float(np.abs(r).max()))
            if not err <= 1e-3 * errs[name][1]:
                fail(f"f32 {name} on the card differs from the CPU by {err} "
                     f"(max|ref| {errs[name][1]})")
    print(f"slice: f32 card vs CPU max|err| (max|ref|): {errs}", flush=True)

    n_req = len(preds) + sum(len(s) for s in sessions)
    stats = {
        "requests": n_req, "wall_s": wall, "requests_per_s": n_req / wall,
        "predict_ms_median": 1e3 * float(np.median(latency["predict"])),
        "predict_ms_max": 1e3 * float(np.max(latency["predict"])),
        "temporal_ms_median": 1e3 * float(np.median(latency["temporal"])),
        "temporal_ms_max": 1e3 * float(np.max(latency["temporal"])),
        "stage1_batches": stage1_batches, "window_batches": temporal_batches,
        "card": gpu_line(),
    }
    print(f"slice: {json.dumps(stats)}", flush=True)

    # one full bucket of each device step, outside the counted run: host
    # clock around the batchers' callbacks (each ends in its copy to host)
    steps = {}
    prep = model._host_prep(frames[0])
    window = tuple(served[0][1])
    for name, fn in (("stage1_batch8", lambda: model._run_stage1_batch([prep] * 8)),
                     ("window_batch8", lambda: model._run_window_batch([window] * 8))):
        fn()
        torch.cuda.synchronize()
        t = time.monotonic()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        steps[name + "_ms"] = 1e3 * (time.monotonic() - t) / 5
        print(f"slice: {name} profile {json.dumps(profile_step(fn))}", flush=True)
    print(f"slice: device steps {json.dumps(steps)}", flush=True)
    model.close()
    return {"cube_conv3x3": k1_launches, "equi_to_cube": k2_launches,
            "cube_pool3x3s2": k3_launches}


# ---- phase 4: the training step ----------------------------------------------


def write_artifacts(root: Path, n_frames: int = 8) -> int:
    """Seeded stage-1 artifacts in the reference's layout: two train_60
    videos, frames numbered from 000002.  Returns the number of windows."""
    from cp360_tpu_torch.data.dataset import builtin_split

    rng = np.random.RandomState(SEED + 2)
    vids = builtin_split("train_60")[:2]
    for vid in vids:
        (root / vid / "cube_feat").mkdir(parents=True)
        (root / vid / "motion").mkdir(parents=True)
        for i in range(2, 2 + n_frames):
            cam = rng.gamma(0.5, 2.0, (6, 1000, 7, 7)).astype(np.float16)
            np.save(root / vid / "cube_feat" / f"{i:06}.npy", cam)
            flow = (rng.standard_normal((480, 960, 2)) * 2.0).astype(np.float32)
            np.save(root / vid / "motion" / f"{i:06}.npy", flow)
    return len(vids) * (n_frames - 5)


def train_batch(b: int, gen, ch: int = 1000, flow_h: int = 480):
    seq = torch.rand(b, 5, 6, 7, 7, ch, generator=gen, device="cuda")
    flows = torch.randn(b, 5, flow_h, 2 * flow_h, 2, generator=gen, device="cuda") * 2.0
    return seq, flows


def f32_card_vs_cpu(gen) -> dict:
    """One f32 train step (TF32 off) at ConvLSTM 64/64 on the card's
    kernels and on the CPU's plain path, from the same params and batch."""
    from cp360_tpu_torch.compat.jax_params import clstm_to_params, init_clstm_params
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.train import loop

    cfg = Config(input_size=64, hidden_size=64, flow_h=96, compute_dtype="float32", lr=1e-4)
    params = init_clstm_params(SEED + 3, 64, 64)
    for name in params:
        params[name]["b"] = np.full_like(params[name]["b"], 0.05)
    seq, flows = train_batch(1, gen, ch=64, flow_h=96)
    outs = {}
    for dev in ("cuda", "cpu"):
        model = loop.trainable_clstm(cfg, params, dev)
        opt = loop.make_optimizer(cfg, model)
        metrics = loop.make_train_step(cfg, model, opt)(seq.to(dev), flows.to(dev))
        outs[dev] = ({k: float(v) for k, v in metrics.items()},
                     {n: p.grad.detach().cpu().numpy() for n, p in model.named_parameters()},
                     clstm_to_params(model))
    (m_g, g_g, p_g), (m_c, g_c, p_c) = outs["cuda"], outs["cpu"]
    res = {"loss_rel_err": max(abs(m_g[k] - m_c[k]) / abs(m_c[k]) for k in m_c)}
    res["grad_rel_err"] = max(float(np.abs(g_g[n] - g_c[n]).max() / np.abs(g_c[n]).max())
                              for n in g_c)
    upd_err, upd_err_all = 0.0, 0.0
    for name in p_c:
        for k in ("w", "b"):
            g = g_c[f"{name}_{k}"]
            diff = np.abs(p_g[name][k] - p_c[name][k])
            sure = np.abs(g) > 1e-4 * np.abs(g).max()
            upd_err = max(upd_err, float(diff[sure].max(initial=0.0)))
            upd_err_all = max(upd_err_all, float(diff.max()))
    res["update_err_over_lr"] = upd_err / cfg.lr
    res["update_err_all_over_lr"] = upd_err_all / cfg.lr
    res["passed"] = bool(res["loss_rel_err"] <= 1e-4 and res["grad_rel_err"] <= 1e-3
                         and upd_err <= 0.2 * cfg.lr and upd_err_all <= 2.0 * cfg.lr + 1e-7)
    return res


def phase_train() -> dict:
    from cp360_tpu_torch.cli import train_temporal
    from cp360_tpu_torch.compat.jax_params import init_clstm_params, load_npz
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.ops import cube_conv
    from cp360_tpu_torch.train import loop

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_", dir=build))
    try:
        t0 = time.monotonic()
        n_windows = write_artifacts(tmp / "art")
        print(f"train: {n_windows} windows of artifacts written in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        metrics = tmp / "metrics.jsonl"
        argv = ["--input", str(tmp / "art"), "--device", "cuda",
                "--metrics-jsonl", str(metrics), "--set", f"checkpoint_path={tmp / 'ck'}",
                "--set", "epochs=1", "--set", "summary_freq=1",
                "--set", "clstm_conv_impl=pallas"]
        cube_conv.launches = 0
        cube_conv.dx_launches = 0
        t0 = time.monotonic()
        trained = train_temporal.main(argv)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        k1, dx = cube_conv.launches, cube_conv.dx_launches

        recs = [json.loads(line) for line in metrics.read_text().splitlines()]
        steps = len(recs)
        print(f"train: CLI ran {steps} steps in {wall:.1f} s (checkpoints included); "
              f"K1 launches {k1}, dx launches {dx}; losses "
              f"{[round(r['loss_avg'], 4) for r in recs]}", flush=True)
        if steps != n_windows or steps < 3:
            fail(f"expected {n_windows} (>= 3) logged steps at batch 1, got {steps}")
        if not all(np.isfinite(r["loss_avg"]) for r in recs):
            fail(f"non-finite training loss: {recs}")
        if k1 != 15 * steps or dx != 14 * steps:
            fail(f"per step K1 ran {k1 / steps}, dx {dx / steps} times (want 15, 14)")
        cfg = Config()
        ckdir = tmp / "ck" / Path(loop.checkpoint_dir(cfg)).name
        saved = load_npz(str(ckdir / "epoch_00.npz"))
        init = init_clstm_params(0, cfg.input_size, cfg.hidden_size)
        for name in init:
            for k in ("w", "b"):
                if not np.array_equal(saved[name][k], trained[name][k]):
                    fail(f"epoch checkpoint {name}/{k} differs from the trained weights")
                if np.array_equal(saved[name][k], init[name][k]):
                    fail(f"training left {name}/{k} unchanged")
        del saved, trained
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # step times at full width (from the CLI's initial weights), outside the
    # counted run
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 4)
    stats = {"card": gpu_line()}
    for b in (1, 8):
        cfg = Config(batch_size=b, clstm_conv_impl="pallas")
        model = loop.trainable_clstm(cfg, init, "cuda")
        step = loop.make_train_step(cfg, model, loop.make_optimizer(cfg, model))
        seq, flows = train_batch(b, gen)
        times = []
        for i in range(5):  # 2 warm-up steps, 3 timed
            torch.cuda.synchronize()
            t = time.monotonic()
            step(seq, flows)
            torch.cuda.synchronize()
            if i >= 2:
                times.append(1e3 * (time.monotonic() - t))
        torch.cuda.reset_peak_memory_stats()
        prof = profile_step(lambda: step(seq, flows), top=14)
        stats[f"step_ms_b{b}"] = float(np.median(times))
        stats[f"step_ms_b{b}_all"] = times
        stats[f"peak_mem_gb_b{b}"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"train: batch {b} profile {json.dumps(prof)}", flush=True)
        del model, step, seq, flows
        torch.cuda.empty_cache()
    del init
    print(f"train: {json.dumps(stats)}", flush=True)

    par = f32_card_vs_cpu(gen)
    print(f"train: f32 card vs CPU {json.dumps(par)}", flush=True)
    if not par["passed"]:
        fail(f"f32 train step on the card differs from the CPU: {par}")
    return {"cube_conv3x3": k1, "cube_conv3x3_dx": dx}


# ---- phase 5: the offline video pipeline ---------------------------------------

GOLDEN_CONFIG = """\
data_vid_path: {root}/dataset
label_path: {root}/Wild360_GT
output_path: {root}/output
checkpoint_path: {root}/checkpoint
test_mode: true
train_mode: false
cube_pad: true
opt_flow: false
equi_h: {cols}
equi_w: {rows}
cube_dim: 224
hidden_size: {classes}
input_size: {classes}
seq_len: {seq}
compute_dtype: float32
host_cube_remap: false
feat_dtype: float32
extract_batch: 4
"""
# how far stage 2 from the full-geometry golden's f16-stored feats lies
# from the golden's own predictions and aggregate, with the JAX package in
# f32 on the CPU (tools/e2e_full_f16_drift.py); the card is held within
# this drift plus a margin
E2E_FULL_F16_PRED_DRIFT = 1.328587532043457e-4  # max |pred - golden|
E2E_FULL_F16_AGG_DRIFT = 6.573300846030028e-5  # max over CC, AUC, AUCB


def synth_tensor(key: str, shape) -> np.ndarray:
    """The goldens' deterministic reference weights (tools/ref_shim.py
    ``synth_tensor``, scheme "v2", as ``tests/test_e2e_golden.py`` rebuilds
    them)."""
    import zlib

    rs = np.random.RandomState(zlib.crc32(("v2:" + key).encode()) % (2**31))
    if key.endswith("num_batches_tracked"):
        return np.zeros(shape, np.int64)
    if key.endswith("running_var"):
        return rs.uniform(0.8, 1.2, size=shape).astype(np.float32)
    if key.endswith("running_mean"):
        return (rs.randn(*shape) * 0.1).astype(np.float32)
    if len(shape) == 1 and key.endswith(".weight"):  # BN gamma
        return rs.uniform(0.9, 1.1, size=shape).astype(np.float32)
    if len(shape) == 1:  # bias
        return (rs.randn(*shape) * 0.1).astype(np.float32)
    if len(shape) == 4:  # conv [O, I, kh, kw]
        o, i, kh, kw = shape
        w = (rs.randn(*shape) * (0.15 / np.sqrt(i * kh * kw))).astype(np.float32)
        w[:, :, kh // 2, kw // 2] += (rs.randn(o, i) * (1.2 / np.sqrt(i))).astype(np.float32)
        return w
    return (rs.randn(*shape) * 0.05).astype(np.float32)


class Golden:
    """One end-to-end golden (``tests/golden/e2e*``) laid out as the CLIs
    read it under ``root``: videos, GT, the reference's feats under
    ``ref_arts``, its weights as ``.npz`` and a config."""

    def __init__(self, name: str, root: Path):
        from cp360_tpu_torch.compat import jax_params

        self.dir = ROOT / "tests" / "golden" / name
        self.g = np.load(self.dir / "e2e_golden.npz")
        self.root = root
        self.vids = [str(v) for v in self.g["vids"]]
        self.seed = int(self.g["metric_seed"])
        classes = int(self.g["num_classes"])
        cols = int(self.g["equi_cols"]) if "equi_cols" in self.g.files else 448
        rows = int(self.g["equi_rows"]) if "equi_rows" in self.g.files else 224
        (root / "dataset" / "test").mkdir(parents=True)
        for vid in self.vids:
            shutil.copy(self.dir / f"{vid}.mp4", root / "dataset" / "test" / f"{vid}.mp4")
            for group, sub in (("gt", Path("Wild360_GT") / f"{vid}.mp4"),
                               ("feat", Path("ref_arts") / vid / "cube_feat")):
                (root / sub).mkdir(parents=True)
                for name_, arr in self.group(group, vid).items():
                    np.save(root / sub / f"{name_}.npy", arr)
        self.config = root / "config.yaml"
        self.config.write_text(GOLDEN_CONFIG.format(
            root=root, cols=cols, rows=rows, classes=classes, seq=int(self.g["seq_len"])))
        jax_params.save_npz(str(root / "resnet50.npz"), jax_params.convert_resnet_state_dict(
            self.weights("resnet"), "resnet50"))
        jax_params.save_npz(str(root / "clstm.npz"),
                            jax_params.convert_clstm_state_dict(self.weights("clstm")))

    def group(self, group: str, vid: str) -> dict:
        pre = f"{group}/{vid}/"
        return {k[len(pre):]: self.g[k] for k in self.g.files if k.startswith(pre)}

    def weights(self, prefix: str) -> dict:
        keys = [str(k) for k in self.g[f"{prefix}_keys"]]
        shapes = [tuple(int(d) for d in s.split(",") if d) for s in self.g[f"{prefix}_shapes"]]
        return {k: synth_tensor(k, sh) for k, sh in zip(keys, shapes)}

    def result(self):
        return parse_result(str(self.g["result_txt"]))


def parse_result(text: str):
    """(CC, AUC, AUCB) from "total result:<CC>, <AUC>, <AUCB>"."""
    return [float(x) for x in text.strip().split("total result:")[1].split(",")]


def run_test_temporal(root: Path, model: Path, art_dir: Path, config: Path, seed: int,
                      *extra: str):
    """``cli.test_temporal.main`` on the card, from ``root``, after
    np.random.seed(seed); returns (result (CC, AUC, AUCB), host seconds,
    K1 launches)."""
    from cp360_tpu_torch.cli import test_temporal
    from cp360_tpu_torch.ops import cube_conv

    cwd = Path.cwd()
    os.chdir(root)
    np.random.seed(seed)
    k1 = cube_conv.launches
    try:
        t0 = time.monotonic()
        test_temporal.main(["--device", "cuda", "--model", str(model), "--dir", str(art_dir),
                            "--config", str(config), *extra])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        result = parse_result((root / f"{art_dir.name}_result.txt").read_text())
    finally:
        os.chdir(cwd)
    return result, wall, cube_conv.launches - k1


def window_batches(art_dir: Path, vids, seq_len: int, batch_windows: int) -> int:
    from cp360_tpu_torch.pipelines.temporal import video_windows

    n = [max(0, len(video_windows(str(art_dir / v / "cube_feat"))) - seq_len) for v in vids]
    return sum(-(-w // batch_windows) for w in n)


def synthetic_gt(root: Path, vid: str, ids, rng) -> None:
    """120x240 GT maps with a few Gaussian blobs, so mean+2*std fixations
    exist."""
    d = root / f"{vid}.mp4"
    d.mkdir(parents=True)
    yy, xx = np.mgrid[0:120, 0:240]
    for i in ids:
        m = np.zeros((120, 240), np.float32)
        for _ in range(3):
            cy, cx = rng.randint(10, 110), rng.randint(10, 230)
            m += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 60.0).astype(np.float32)
        np.save(d / f"{i:05}.npy", m)


def phase_video() -> dict:
    from cp360_tpu_torch.cli import extract_features
    from cp360_tpu_torch.compat import jax_params
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.data.dataset import builtin_split
    from cp360_tpu_torch.ops import cube_conv, cube_pool, equi_gather
    from cp360_tpu_torch.pipelines.extract import extract_frames, stage1_batch
    from cp360_tpu_torch.pipelines.temporal import infer_video

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_video_", dir=build))
    stats = {"card": gpu_line()}
    try:
        # -- extraction at full width: 2 videos x 24 seeded 960x1920 frames
        cfg = Config(cube_dim=224, equi_h=1920, equi_w=960, input_size=1000,
                     hidden_size=1000, seq_len=5, compute_dtype="bfloat16",
                     host_cube_remap=False, extract_batch=16, opt_flow=False,
                     feat_dtype="float16")
        t0 = time.monotonic()
        model = jax_params.resnet_from_params(jax_params.init_resnet_params(SEED, "resnet50"),
                                              "resnet50", True, torch.bfloat16, "cuda")
        rng = np.random.RandomState(SEED + 5)
        vids = builtin_split("test_25")[:2]
        videos = {v: [rng.randint(0, 256, (960, 1920, 3), dtype=np.uint8) for _ in range(24)]
                  for v in vids}
        x16 = torch.from_numpy(np.stack(videos[vids[0]][:16])).cuda()
        with torch.no_grad():  # the reference batch, and the warm-up
            direct = stage1_batch(model, x16, 224, out_dtype=torch.float16)[0].cpu().numpy()
        torch.cuda.synchronize()
        print(f"video: model, frames and warm-up in {time.monotonic() - t0:.1f} s", flush=True)

        art = tmp / "static_resnet50"
        cube_conv.launches = equi_gather.launches = cube_pool.launches = 0
        t0 = time.monotonic()
        written = sum(extract_frames(model, cfg, videos[v], str(art / v), output_img=True,
                                     output_feature=True) for v in vids)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        k2, k3 = equi_gather.launches, cube_pool.launches
        n_batches = 2 * len(vids)  # 23 artifacts per video: 16 + a padded 7
        stats.update(extract_frames=written, extract_s=wall, extract_fps=written / wall,
                     extract_batches=n_batches)
        print(f"video: extract_frames wrote {written} frames (with -oi images) in "
              f"{wall:.2f} s, {written / wall:.2f} frames/s; K2 launches {k2}, "
              f"K3 launches {k3}", flush=True)
        if written != 23 * len(vids):
            fail(f"extract_frames wrote {written} frames, want {23 * len(vids)}")
        if k2 != n_batches or k3 != n_batches:
            fail(f"K2 {k2} and K3 {k3} launches for {n_batches} stage-1 batches")
        for v in vids:
            names = sorted(os.listdir(art / v / "cube_feat"))
            if names != [f"{i:06}.npy" for i in range(2, 25)]:
                fail(f"{v}: artifacts {names[:3]}..{names[-2:]}")
            if len(os.listdir(art / v / "img")) != 23:
                fail(f"{v}: {len(os.listdir(art / v / 'img'))} images, want 23")
        batch_err = 0.0
        for k in range(16):
            a = np.load(art / vids[0] / "cube_feat" / f"{k + 2:06}.npy")
            if a.shape != (6, 1000, 7, 7) or a.dtype != np.float16:
                fail(f"artifact {k + 2:06} is {a.shape} {a.dtype}")
            batch_err = max(batch_err, float(np.abs(a.astype(np.float32) - direct[k].transpose(
                0, 3, 1, 2).astype(np.float32)).max()))
        print(f"video: first batch's artifacts vs stage1_batch on the same frames: "
              f"max|err| {batch_err}", flush=True)
        if batch_err != 0.0:
            fail(f"extracted artifacts differ from stage1_batch by {batch_err}")
        del direct

        # -- the extraction CLI on the full-geometry golden's mp4s (cv2), in
        # both stage-1 forms: all-device (K2 + K3), and the host cv2 remap
        # with the int8 codec (K3 only)
        full = Golden("e2e_full", tmp / "full")
        for out, extra, want_k2 in (("static", [], True),
                                    ("remap", ["--set", "host_cube_remap=true",
                                               "--set", "transfer_codec=int8"], False)):
            cwd = Path.cwd()
            os.chdir(full.root)
            k2, k3 = equi_gather.launches, cube_pool.launches
            try:
                t0 = time.monotonic()
                extract_features.main(["--device", "cuda", "--out", out, "--mode", "resnet50",
                                       "-of", "--weights", str(full.root / "resnet50.npz"),
                                       "--config", str(full.config), *extra])
                torch.cuda.synchronize()
                cli_s = time.monotonic() - t0
            finally:
                os.chdir(cwd)
            worst = 0.0
            for vid in full.vids:
                ours_dir = full.root / "output" / f"{out}_resnet50" / vid / "cube_feat"
                want = full.group("feat", vid)
                if sorted(p[:-4] for p in os.listdir(ours_dir)) != sorted(want):
                    fail(f"{vid}: golden artifact numbering differs")
                for cnt, ref in want.items():
                    ref = ref.astype(np.float32)
                    ours = np.load(ours_dir / f"{cnt}.npy")
                    worst = max(worst, float(np.abs(ours - ref).max() / np.abs(ref).max()))
            k2, k3 = equi_gather.launches - k2, cube_pool.launches - k3
            stats.update({f"golden_extract_{out}_rel_err": worst,
                          f"golden_extract_{out}_s": cli_s})
            print(f"video: extract_features CLI {' '.join(extra) or '(all-device)'} on the "
                  f"e2e_full golden mp4s in {cli_s:.1f} s: max relative CAM error {worst} "
                  f"(limit 0.02); K2 {k2}, K3 {k3} launches", flush=True)
            if not worst < 0.02 or k3 == 0 or k2 != (k3 if want_k2 else 0):
                fail(f"golden extraction ({out}): relative error {worst}, K2 {k2}, K3 {k3}")

        # -- stage 2 + metrics, exact composition, on the scaled golden
        scaled = Golden("e2e", tmp / "scaled")
        result, cli_s, k1 = run_test_temporal(scaled.root, scaled.root / "clstm.npz",
                                              scaled.root / "ref_arts", scaled.config,
                                              scaled.seed, "--batch-windows", "8")
        pred_err = 0.0
        for vid in scaled.vids:
            for fidx, ref in scaled.group("pred", vid).items():
                ours = np.load(scaled.root / "output" / "temporal" / vid / f"{fidx}.npy")
                bad = np.abs(ours - ref) > 2e-5 + 1e-4 * np.abs(ref)
                pred_err = max(pred_err, float(np.abs(ours - ref).max()))
                if bad.any():
                    fail(f"scaled golden {vid}/{fidx}: prediction off by {pred_err}")
        agg_err = max(abs(a - b) for a, b in zip(result, scaled.result()))
        want_k1 = 15 * window_batches(scaled.root / "ref_arts", scaled.vids, 5, 8)
        stats.update(scaled_pred_err=pred_err, scaled_agg_err=agg_err)
        print(f"video: test_temporal f32 on the scaled golden's feats: result {result}, "
              f"golden {scaled.result()}; max|pred err| {pred_err} (atol 2e-5, rtol 1e-4), "
              f"aggregate err {agg_err} (limit 1e-4); K1 {k1} (want {want_k1})", flush=True)
        if not agg_err < 1e-4 or k1 != want_k1:
            fail(f"scaled golden: aggregate off by {agg_err}, K1 {k1} != {want_k1}")

        # -- stage 2 + metrics at full width, on the full golden's f16 feats
        outs = {}
        for dtype in ("float32", "bfloat16"):
            out = full.root / f"out_{dtype}"
            result, cli_s, k1 = run_test_temporal(
                full.root, full.root / "clstm.npz", full.root / "ref_arts", full.config,
                full.seed, "--batch-windows", "4", "--set", f"output_path={out}",
                "--set", f"compute_dtype={dtype}")
            preds = {(vid, f): np.load(out / "temporal" / vid / f"{f}.npy")
                     for vid in full.vids for f in full.group("pred", vid)}
            outs[dtype] = (result, preds, k1, cli_s)
        result, preds, k1, cli_s = outs["float32"]
        gold = {(vid, f): p for vid in full.vids for f, p in full.group("pred", vid).items()}
        pred_err = max(float(np.abs(preds[k] - gold[k]).max()) for k in gold)
        agg_err = max(abs(a - b) for a, b in zip(result, full.result()))
        # margins: the card's f32 sums in another order than the CPU's
        # (2e-5, the scaled golden's own atol) and what that does to the
        # metrics' ranks (1e-4, the scaled golden's aggregate limit)
        pred_tol = E2E_FULL_F16_PRED_DRIFT + 2e-5
        agg_tol = E2E_FULL_F16_AGG_DRIFT + 1e-4
        want_k1 = 15 * window_batches(full.root / "ref_arts", full.vids, 5, 4)
        bf_pred = max(float(np.abs(outs["bfloat16"][1][k] - preds[k]).max()) for k in gold)
        bf_agg = max(abs(a - b) for a, b in zip(outs["bfloat16"][0], result))
        stats.update(full_pred_err=pred_err, full_agg_err=agg_err, full_pred_tol=pred_tol,
                     full_agg_tol=agg_tol, full_bf16_vs_f32_pred=bf_pred,
                     full_bf16_vs_f32_agg=bf_agg)
        print(f"video: test_temporal f32 at full width on the e2e_full golden's f16 feats: "
              f"result {result}, golden {full.result()}; max|pred err| {pred_err} "
              f"(limit {pred_tol}), aggregate err {agg_err} (limit {agg_tol}); K1 {k1} "
              f"(want {want_k1}); bf16 vs the card's f32: max|pred diff| {bf_pred}, "
              f"aggregate diff {bf_agg}", flush=True)
        if not (pred_err <= pred_tol and agg_err <= agg_tol) or k1 != want_k1 \
                or outs["bfloat16"][2] != want_k1:
            fail("full-width golden stage 2 out of its tolerance or K1 miscounted")

        # -- stage 2 + metrics on the extracted artifacts, bf16, synthetic GT
        gt_rng = np.random.RandomState(SEED + 6)
        for v in vids:
            synthetic_gt(tmp / "gt", v, range(4, 22), gt_rng)
        synth_cfg = tmp / "synth.yaml"
        synth_cfg.write_text(f"label_path: {tmp / 'gt'}\noutput_path: {tmp / 'out'}\n"
                             "compute_dtype: bfloat16\n")
        result, cli_s, k1 = run_test_temporal(tmp, full.root / "clstm.npz", art, synth_cfg,
                                              SEED, "--batch-windows", "64")
        want_k1 = 15 * window_batches(art, vids, 5, 64)
        print(f"video: test_temporal bf16 on the extracted artifacts ({2 * 18} windows): "
              f"result {result} in {cli_s:.1f} s (model load and metrics included); "
              f"K1 {k1} (want {want_k1})", flush=True)
        if not all(np.isfinite(result)) or k1 != want_k1:
            fail(f"stage 2 on extracted artifacts: result {result}, K1 {k1}")
        launches = {"cube_conv3x3": cube_conv.launches, "equi_to_cube": equi_gather.launches,
                    "cube_pool3x3s2": cube_pool.launches}

        # -- timings outside the counted runs
        t0 = time.monotonic()  # extraction writing artifacts only (-of)
        written = sum(extract_frames(model, cfg, videos[v], str(tmp / "feat_only" / v),
                                     output_img=False) for v in vids)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        stats.update(extract_of_fps=written / wall, extract_of_s=wall)
        cell = jax_params.clstm_from_params(jax_params.load_npz(str(full.root / "clstm.npz")),
                                            torch.bfloat16, True, "pallas", "cuda")
        long_dir = tmp / "long" / vids[0] / "cube_feat"  # 133 frames: 2 x 64 windows
        long_dir.mkdir(parents=True)
        for i in range(2, 2 + 133):
            np.save(long_dir / f"{i:06}.npy",
                    rng.gamma(0.5, 2.0, (6, 1000, 7, 7)).astype(np.float16))
        infer_video(cell, str(long_dir), 5, batch_windows=64)  # warm-up
        torch.cuda.synchronize()
        t0 = time.monotonic()
        n_win = len(infer_video(cell, str(long_dir), 5, batch_windows=64))
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        stats.update(infer_windows=n_win, infer_s=wall, infer_windows_per_s=n_win / wall)
        with torch.no_grad():
            prof = profile_step(lambda: stage1_batch(model, x16, 224, out_dtype=torch.float16),
                                top=14, match="cube_pool3x3s2")
        print(f"video: stage-1 step, 16 frames, profile {json.dumps(prof)}", flush=True)
        print(f"video: {json.dumps(stats)}", flush=True)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def profile_step(fn, top: int = 12, match: str = "") -> dict:
    """Device time by kernel name over one call of ``fn`` (torch.profiler),
    with the device's busy share of the call's host-clock wall time; rows
    whose name holds ``match`` are listed too, wherever they rank."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t)
    # user annotations (e.g. "Optimizer.step#Adam.step") span kernels that
    # are counted on their own, so they are left out of the busy time
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not dev:
        return {"wall_ms": wall_ms, "device": "not measured (no device events)"}
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    dev.sort(key=lambda e: e.self_device_time_total, reverse=True)
    res = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "top": [[e.key[:90], e.count, e.self_device_time_total / 1e3]
                   for e in dev[:top]]}
    if match:
        res["matched"] = [[e.key[:90], e.count, e.self_device_time_total / 1e3]
                          for e in dev if match in e.key]
    return res


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="build,kernels,slice,train,video",
                        help="comma-separated subset of build,kernels,slice,train,video")
    args = parser.parse_args(argv)
    phases = args.phases.split(",")

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs on the card only")
    if not (ROOT / "cp360_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no cp360_tpu_torch/csrc)")
    sys.path.insert(0, str(ROOT))
    card = gpu_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase_build()  # always: the later phases need the kernels
    kernels = phase_kernels() if "kernels" in phases else {}
    # each path runs with the counts set to 0 just before it, read just after
    by_path = {}
    if "slice" in phases:
        by_path["slice"] = phase_slice()
    if "train" in phases:
        by_path["train"] = phase_train()
    if "video" in phases:
        by_path["video"] = phase_video()

    meta = {
        "cube_conv3x3": ("cp360_tpu_torch/csrc/cube_conv3x3.cu",
                         "cp360_tpu/ops/pallas_kernels.py:136"),
        "cube_conv3x3_dx": ("cp360_tpu_torch/csrc/cube_conv3x3.cu",
                            "cp360_tpu/ops/pallas_kernels.py:258"),
        "equi_to_cube": ("cp360_tpu_torch/csrc/equi_to_cube.cu",
                         "cp360_tpu/ops/slot_gather.py:212"),
        "cube_pool3x3s2": ("cp360_tpu_torch/csrc/cube_pool3x3s2.cu",
                           "tools/bench_pool_pallas.py:39"),
    }
    line = []
    for name, (source, replaces) in meta.items():
        k = kernels.get(name, {})
        paths = {path: n[name] for path, n in by_path.items() if name in n}
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": sum(paths.values()) if paths else None,
                     "launches_by_path": paths,
                     "max_abs_err": k.get("max_abs_err"), "ms": k.get("ms"),
                     "plain_ms": k.get("plain_ms"), "bound_ms": k.get("bound_ms"),
                     "bound_by": k.get("bound_by"),
                     "library_ms": k.get("library_ms"), "passed": k.get("passed")})
    print(json.dumps({"kernels": line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
