"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase (what a chip check runs)
    python3 chip_smoke.py --phases kernels
    python3 chip_smoke.py --phases options,stream
    python3 chip_smoke.py --phases backbones
    python3 chip_smoke.py --phases parallel
    python3 chip_smoke.py --phases loader
    python3 chip_smoke.py --phases bench

Phases, in order; any failure exits non-zero before the result lines:

1. build: compile every source of ``cp360_tpu_torch/csrc/`` (one compiler
   per source, all started together: nvcc for the kernels, g++ for the
   batch ``.npy`` loader), print each kernel's register and shared-memory
   use, and fail if ptxas spilled registers anywhere.
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
   - Channel counts the bf16 kernels take zero-padded (not multiples of 8):
     K1 and dx at [8,6,7,7,1250]->1000 (a ConvLSTM with hidden_size 250)
     and 126->252 (hidden_size 63), and ``cube_conv3x3_train``'s forward,
     dx, dw and db at both, against the plain f32 version at 1e-2 max|ref|.
     Then the bf16 forward and dx at every split count, at 8 windows and at
     one (the evidence for ``cube_conv.depth_splits``).
   - K2 ``equi_to_cube``: u8 [8,960,1920,3] (a serving bucket) and
     [16,...] (an extraction batch) and f32 [2,...] -> [N,6,224,224,3] f32,
     bit for bit against the plain version on the CPU; a repeat launch and
     each frame of a batch of 3 launched alone give the same bits.  Beside
     ``ms`` (CUDA events around back-to-back wrapper calls) it reports the
     device time of one launch from a CUDA graph of 50, the wrapper's host
     time per call, the bound from the distinct source bytes the taps read
     (``equi_gather.source_bytes``) with the touched 32-byte sectors, and
     the library form, never called by the port: the /255 in f32, the
     permute to NCHW and one ``F.grid_sample`` (bilinear, border,
     align_corners) over a grid from the same maps, timed by a CUDA graph
     of 50 whole and as the grid_sample call alone.  It is held to the
     plain version within its f32 coordinates' round trip plus 1e-6, and
     the same call in f64 within 1e-5 (``library_equi_to_cube``).
   - K3 ``cube_pool3x3s2`` (the stem's cube-padded 3x3/s2 max pool): bf16
     [8,6,112,112,64] (a serving bucket), [16,6,112,112,64] (an extraction
     batch), f32 [2,6,112,112,64], and bf16 [8,...] with +-inf and NaN
     planted on face edges and corners: bit for bit (equal bits wherever
     the plain version is not NaN, NaN where it is).  Its plain version,
     cube pad + ``F.max_pool2d``, is also the only PyTorch yardstick, so
     library ms is the plain version's time.
   - ``conv_epilogue`` (each backbone conv's batch norm, bias, residual
     and activation in one pass), with the vectors ``layers.fold`` gives
     under random statistics: bf16 at the stream's batch of 8 on
     VGG16-BN's first convs [48,224,224,64], ResNet-50's layer1 conv3
     [48,56,56,256] (residual) and stem [48,112,112,64] (the shift
     alone), and f32 with a conv bias, scale, shift, residual and ReLU6:
     bit for bit against its plain version, timed against its bytes
     bound; the plain version's time is the library yardstick.  GELU
     (ConvNeXt's W1, bf16 [48,56,56,512] with its conv bias) within one
     bf16 ulp: erff against the plain version's erf.  ConvNeXt's W2
     (bf16 [48,56,56,128] onto an f32 residual, with its conv bias and
     gamma), bit for bit.
   - ``cube_dwconv`` (ConvNeXt's cube-padded depthwise 7x7 with its bias)
     at every ConvNeXt-B shape of a batch of 8 (48 faces of 56/128,
     28/256, 14/512, 7/1024) from f32 faces to bf16 (the main path: the
     residual stream is f32), and at 14/512 in bf16 and in f32, against its
     plain version (pad, f32 grouped conv, bias, one rounding) within one
     ulp of the output dtype; timed against its bound (the f32 rate of the
     CUDA cores and the bytes: x read once, y written once, the kernel and
     bias once), the plain version and the library form, never called by
     the port: the cube pad's copy and cuDNN's grouped conv in the
     working dtype.
   - ``cube_window_attn`` (Swin's window attention on cube faces, bf16)
     at Swin-B's shapes of a batch of 8 (48 faces of 56/128, 28/256,
     14/512 in regular and cube-padded shifted windows, 7/1024 in one
     window) against its plain form within one bf16 ulp plus 1e-2 of the
     largest output; timed against its bytes bound (q and the output once,
     k and v as the windows gather them), the plain form and the library
     form, never called by the port: the gather and SDPA with the
     relative-position bias as its mask.
3. slice: ``SaliencyModel(device="cuda")`` at full width (ResNet-50,
   224 faces of 960x1920 frames, 1000-class CAM, ConvLSTM 1000/1000,
   seq_len 5, bf16, all-device stage 1, seeded random weights) serves
   ``predict`` calls and two temporal sessions from several threads.  It
   checks shapes and finite values, that every ConvLSTM conv went through
   K1 and every stage-1 equi->cube and stem pool through K2 and K3 (launch
   counts against the batchers' batch counts), that each session's prediction equals offline
   ``window_infer`` on the session's cubes, and that one frame and one
   window recomputed in f32 on the card agree with the plain f32 path on
   the CPU, started with cuDNN's TF32 flag at its default (True): the f32
   convs switch it off themselves.  ``stage1_step`` on one frame (resnet50,
   bf16, ``halo``), given the u8 frame and the float frame u8/255, must
   equal ``stage1_batch`` on the u8 frame bit for bit, with one K2 and one
   K3 launch each.
4. train: seeded synthetic stage-1 artifacts (two train_60 videos of 8
   frames: [6,1000,7,7] f16 CAM cubes, [480,960,2] f32 flows) feed
   ``cli.train_temporal.main(["--device", "cuda", ...])`` at full width
   (ConvLSTM 1000/1000, seq_len 5, flow_h 480, bf16 convs, f32 masters,
   batch 1): 6 Adam steps.  It checks finite losses, changed weights, the
   epoch checkpoint read back by ``load_npz``, 15 K1 launches and 14 dx
   launches per step (the first conv of a rollout reads data only: its
   input x[0] needs no gradient).  Then ``loop.train`` runs twice from the
   CLI's initial params: on one epoch of the CLI's loader taken into a
   plain list, and on the loader itself (its ``iter_epoch``); the final
   params must be equal bit for bit (under
   ``torch.use_deterministic_algorithms`` if the first pair differs), and
   it prints both runs' seconds and the largest difference.  Then it times
   the step at batch 1 and 8
   (median of 3 after warm-up), profiles one step of each, and runs one f32
   step (TF32 off) at ConvLSTM 64/64 on the card and on the CPU's plain
   path: loss parts within 1e-4 relative, gradients within 1e-3 of each
   tensor's largest, updated weights within 0.2 lr where the gradient's
   sign is well defined (|g| > 1e-4 max|g|) and within 2 lr everywhere.

5. options: the trainer's options at full width (ConvLSTM 1000/1000, bf16
   convs, flow_h 480, seeded weights and artifacts).
   - One Adam step on 2 segments of G = 4 windows (batch 8) against the
     step on the 8 windows they expand to: the same K1 and dx shapes, so
     the same bits.  The direct step repeats first; if it does not repeat
     bit for bit, the three steps run again under
     ``torch.use_deterministic_algorithms`` and must be bit-equal there.
   - The int8 loader codec on one full-width window: the loader ships
     int8 CAMs with f32 scales and f16 flows, and the loss of that batch
     against the plain batch, forward only, in f32, lies within 2e-4 of
     the gap the JAX package shows on the CPU (``tools/int8_loss_gap.py``:
     1.81e-3 relative) on either side; bf16 printed.
   - ``cli.train_temporal`` on 2 train_60 videos of 9 frames (one segment
     of 4 windows each) with every option at once: ``segment_windows=4``
     at batch 8, ``transfer_codec=int8``, ``--profile-dir`` (one Chrome
     trace that names K1) and 2 epochs of one step with
     ``eval_every_epochs=1``, ``eval_patience=1`` and seeded GT (``val``
     records, ``best.npz``, ``best_val.json``); 15 K1 and 14 dx launches a
     step, 30 K1 a validation pass.
   - ``run_validation`` at ConvLSTM 64/64 in f32 on the card and on the
     CPU: AUC within 1e-6.
   - ``cli.train_temporal --supervise`` as a subprocess, in that run's
     checkpoint directory with 3 epochs: rc 0, and the child resumes that
     train state (the implied ``--resume``) and trains epoch 2 only, one
     step.
   - then, outside the counted runs: the step time at 8 windows from the
     host batch (its copy to the card included) for the direct, segment,
     int8 and segment + int8 forms.

6. video: the offline pipeline at full width (ResNet-50, 1000 classes,
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
   - ``cli.extract_features`` on ``e2e_full`` with the host remap in rgb8
     and in yuv420 (K3 only): yuv420 within the JAX package's bound of rgb8
     (relative max error < 0.08, correlation > 0.998).
   - ``cli.extract_features -om`` on ``e2e_full`` (all-device stage 1):
     Horn-Schunck motion over the f16 link within 2e-3 max|flow| + 1e-4 of
     the f32 link, then the variational and Farneback backends; names from
     000002, [480,960,2] f32.
   - ``extract_frames -of -om`` on 8 frames of a train_60 video, then
     ``cli.train_temporal`` 2 steps on them (15 K1, 14 dx launches a step),
     and ``SaliencyModel`` serving yuv420 within the bound of rgb8.
   - both flow solvers on the card against the port's CPU solve at 240x480
     (1e-3 px), the batch equal to each pair alone.
   - then, outside the counted runs: frames/s of extraction with artifacts
     only, with and without -om, windows/s of ``infer_video`` at 64 windows
     per batch (disk reads included), flow pairs/s of both solvers at 16
     pairs of 480x960 with a profile of a Horn-Schunck solve, and a profile
     of a 16-frame stage-1 step with K3's row.
   - ``extract_video`` with ``output_motion`` left out (JAX's default,
     True) on a seeded 9-frame video, ``opt_flow: true``, Horn-Schunck on
     the card: the motion arrays bit-equal to the explicit
     ``output_motion=True`` call's, each call's seconds printed.

7. backbones: every stage-1 backbone family at its full published width
   (seeded weights, 1000 classes, 8 seeded natural-texture 960x1920
   frames, 224 faces, ``host_cube_remap: false``).
   - resnet18, resnet34, resnet101, resnet152, vgg16, mobilenet_v2 and
     the port's own convnext_base (ConvNeXt-B) and swin_base (Swin-B)
     through ``stage1_batch`` on the 8 frames in bf16 and f32 (swin_base in
     bf16 only: its window-attention kernel takes bf16): one K2
     launch a batch, one K3 for the ResNets and none for the others (no
     stem pool), 36 ``cube_dwconv`` launches for convnext_base and 24
     ``cube_window_attn`` for swin_base and none for the others, one conv
     epilogue a conv (swin_base: the stem's and three a block, 73), CAMs
     [8,6,7,7,1000]; card f32 against the port's f32 on the CPU on the first
     frame within 2e-4 of max|CAM| (TF32 off), card bf16 against card f32
     within 0.02 of max|CAM| (the video phase's limit); swin_base's card
     bf16 against the CPU's f32 on the first frame within 0.05 of max|CAM|
     (``tests/test_torch_swin.py``'s bound of bf16 against the f32
     reference); stage-1 ms at 8 frames in bf16 (CUDA events,
     median of 5 after 2 warm-ups, frames already on the card) and its
     profile (the device's busy time and idle share, the top kernels).
   - resnet50: the bf16 default cube-conv form (``halo``), ``halo`` against
     ``pad`` in f32 features (atol and rtol 1e-3,
     ``tests/test_cube_pad.py:204-221``) and bf16 CAMs (0.02 of max), a
     profile of both forms and their stage-1 ms, paired (pad, halo, halo,
     pad).
   - ``cli.convert_weights`` exports a seeded resnet101 ``.npz`` to
     ``.pth`` and imports it back leaf for leaf; ``cli.extract_features
     --mode resnet101 --max-frames 8`` on an e2e_full mp4 writes the same
     CAMs bit for bit from the ``.pth`` as from the ``.npz``.
   - ``SaliencyModel(arch="mobilenet_v2")`` answers 4 ``predict``
     requests from 4 threads (K2 once a batch, no K3), and
     ``stream_video_saliency`` with a vgg16 backbone (ConvLSTM 1000/1000,
     bf16) streams a seeded 16-frame 960x1920 video (15 K1 a window batch,
     no K2, no K3); then its frames/s (host clock, median of 3).
8. stream: ``pipelines/stream.py`` and ``cli/stream_saliency.py`` at full
   width.
   - ``stream_video_saliency`` on ``tests/golden/e2e_full``'s mp4s with the
     golden's weights, f32: equal to ``cli.extract_features`` (host remap,
     f16 feats, batches of 8) -> ``cli.test_temporal`` id for id within
     1e-4 (absolute and relative), with one extra final window per video;
     then bf16, printed against f32.  Each run: one K3 launch per stage-1
     batch, 15 K1 per window batch, no K2.
   - ``cli.stream_saliency`` on a seeded 64-frame 960x1920 mp4v video
     (bf16), then cut after 23 maps and run again with ``--resume``: the
     suffix bit for bit.
   - then, outside the counted runs: stream frames/s on that video (host
     clock, median of 3) and a profile of a 17-frame stream (two stage-1
     batches) with the device's idle share.

9. parallel: scale-out at full width on the one card (ResNet-50, 1000
   classes, 960x1920 frames, 224 faces, ConvLSTM 1000/1000, seq_len 5,
   bf16, seeded weights).
   - ``window_infer_pipelined`` over ``[cuda:0] * 5`` on 8 windows in 4
     microbatches of 12 faces against ``window_infer``: bit-equal, or
     within 0.02 of max|ref| (it prints which), 4x the serial K1 launches;
     both timed.  A pipelined train step (seq_len 8 over ``[cuda:0] * 2``,
     2 windows in 2 microbatches) against the serial step: loss within
     1e-3, gradients within 0.02 of each tensor's max|g|.
   - ``LocalReplicas([cuda:0, cuda:0])``: ``stage1_batch`` on 8 frames and
     ``window_infer`` on 8 windows against one device (bit-equal or within
     0.02, printed), one K2/K3 and 15 K1 launches per replica;
     ``SaliencyModel`` with ``mesh_data`` 2 on that list answers 4
     predicts and a 6-frame session as one card does (within 0.02).
   - ``cli.launch --nprocs 2`` over ``cli.extract_features`` on
     ``tests/golden/e2e_full``'s mp4s (one video a rank): the CAMs bit for
     bit those of a one-process run; then over ``cli.test_temporal`` on
     them: the merged aggregate against the one-process one (CC 1e-5, AUC
     1e-3, AUC-Borji 0.05, as tests/test_distributed.py).  These issue no
     collective on the card (the merge's barrier is a host all-reduce).
   - With ``CP360_DIST_BACKEND=gloo`` (two ranks share the card; NCCL
     refuses that), ``cli.train_temporal`` for 2 steps as dp 2x1 (npz) and
     as tp 1x2 (``checkpoint_backend: orbax``, the DCP directory, then
     resumed for an epoch): the same losses on both ranks.  The dp and tp
     jobs run at once, and so do the resume and the grid step below, each
     launch on a rendezvous port of its own.  One step on
     each grid (``--worker grid-step``) against the one-device step on the
     same params and batch: in f32 at the CPU test's tolerances (losses
     rel 1e-5, the dp update lr * g within 1e-6 at lr 1e-3, tp gradients by
     cosine > 0.999), in bf16 the losses and the dp gradients within 0.02
     (tp's bf16 gradients printed).  K1 and dx ms at the tensor-parallel
     2000-channel shard beside 4000.
   - NCCL at world size 1 through the launcher (``--worker nccl``): the
     grid, one all-reduce and one autograd all-gather on the card.
   - ``cli.doctor --require-device`` exits 0; its JSON is printed.
10. loader: the batch ``.npy`` loader (``native/``, host C++ threads), the
   platform switches, ``CP360_CUBE_CONV_FORM`` and the public parameters
   ``require_motion``, ``drop_last``, loader iteration, ``prefetch_depth``
   and ``upload_depth`` (about a minute and a half).
   - The library phase 1 built with the local g++ loads; the
     compiler's command and version are printed.
   - Seeded full-width artifacts (two train_60 videos of 13 frames: CAMs
     [6,1000,7,7] f16 and flows [480,960,2] f32, as extraction writes
     them) read as batches of 8 windows through the loader and through its
     plain version (``np.load`` of each file): bit-equal, and each
     reader's host ms per batch at n_threads 1, 4 and 0.
   - Two train steps at batch 8 (ConvLSTM 1000/1000, bf16 convs) in each
     form, direct, ``segment_windows`` 4 and the int8 codec, fed by
     ``PrefetchLoader`` through the loader and through the numpy reader:
     first batches and losses bit for bit (under
     ``torch.use_deterministic_algorithms`` if the default mode does not
     repeat); 15 K1 and 14 dx launches a step.
   - ``infer_video`` on the first video (8 windows, batches of 4): the
     predictions bit-equal between the two readers; 15 K1 a batch.  Then
     in batches of 2 at ``prefetch_depth`` 1 and 3: bit-equal, 15 K1 a
     batch.
   - The CAMs alone (no motion dirs) with ``require_motion=False`` through
     ``WindowDataset`` and ``SegmentWindowDataset`` (G = 4) and
     ``PrefetchLoader`` (batches of 3, ``drop_last=False``, two epochs by
     ``for``): bit-equal to the numpy reader's, each epoch equal to
     ``iter_epoch`` of its number, empty f32 flows, a short last batch.
   - ``extract_video`` at full width (resnet50, bf16, ``host_cube_remap:
     true``, batches of 16) on a seeded 129-frame 960x1920 mp4v video at
     ``upload_depth`` 1, 4, 4, 1 in turns: the 128 artifacts bit-equal,
     one K3 launch a batch and no K2, and each run's frames/s (host clock,
     after a warm-up run) beside the card's name and power limit.
   - ``cli.train_temporal`` in a child (``--worker cli-device``) with a
     config that says ``use_gpu: false`` resolves to the CPU and never
     initialises CUDA; the same child with ``CP360_PLATFORM=cuda`` trains
     on the card (K1 launches).
   - A child with ``CP360_CUBE_CONV_FORM=pad`` (``--worker
     cube-conv-form``): the bf16 resnet50 built without a form takes
     ``pad``, its stage 1 at 8 frames and its features bit-equal to the
     ``cube_conv_form="pad"`` keyword's, its stage-1 ms beside ``halo``'s.

11. bench: each measurement program of ``cp360_tpu_torch/bench/`` through
   its measuring core, at full width with reduced iteration counts, and
   through ``bench/common.py::run`` (the output contract): stage 1 (4
   batches of 16 frames, host remap, yuv420, int8), stage 2 (16 windows, 2
   iterations, one disk pass per form), the train step (batch 8 on the
   card, 2 steps; batch 4 from the host, 1 step per codec), the stream (4
   batches of 8), serving (4 requests, 2 clients, one level of 2), the
   stage-1 and backbone profiles (batch 16, 2 iterations), K1 against the
   library (2 iterations) and the ``pad`` and ``halo`` forms (2 batches, 2
   reps).  Each program must exit 0 with lines that carry their metric
   names and the card's name and hold finite numbers, its headline numbers
   positive and no 504; each must launch the kernels of its path (K1 in
   stage 2, training, the stream, serving and the K1 bench, dx in
   training and the K1 bench, K3 wherever stage 1 runs).

Every phase counts its paths one way, ``counted_run``: each kernel's count
is set to 0 just before a run and read just after, and a phase reports the
sum over its runs.  The last lines are ``{"kernels": [...]}``, the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
{...}}``.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.  TF32 is switched off throughout, so every f32 product on the card
is a true f32 product.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import socket
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
SEED = 0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def gpu_line() -> str:
    from cp360_tpu_torch.bench.common import card_line

    return card_line(torch.device("cuda"))


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


# ---- phase 1: build ----------------------------------------------------------


def counted_run(totals: dict, fn):
    """Run ``fn`` with every kernel's count set to 0 just before it and read
    just after (the one way the phases count a path); adds the counts to
    ``totals`` and returns (result, counts)."""
    from cp360_tpu_torch.ops import (conv_epilogue, cube_conv, cube_dwconv, cube_pool,
                                     cube_window_attn, equi_gather)

    cube_conv.launches = cube_conv.dx_launches = equi_gather.launches = 0
    cube_pool.launches = conv_epilogue.launches = cube_dwconv.launches = 0
    cube_window_attn.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = {"cube_conv3x3": cube_conv.launches, "cube_conv3x3_dx": cube_conv.dx_launches,
           "equi_to_cube": equi_gather.launches, "cube_pool3x3s2": cube_pool.launches,
           "conv_epilogue": conv_epilogue.launches, "cube_dwconv": cube_dwconv.launches,
           "cube_window_attn": cube_window_attn.launches}
    for k, v in got.items():
        totals[k] = totals.get(k, 0) + v
    return out, got


def phase_build() -> None:
    from cp360_tpu_torch.ops import _build

    t0 = time.monotonic()
    logs = _build.build(_build.SOURCES + _build.HOST_SOURCES)  # the loader with g++
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
    from cp360_tpu_torch.bench.common import H100_BF16_FLOPS, H100_F32_FLOPS, bound_ms
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
    """The depth splits the wrapper picks for a conv on 7x7 cubes (1 in f32;
    bf16 channel counts padded to multiples of 8 first)."""
    from cp360_tpu_torch.ops import cube_conv

    if dtype != torch.bfloat16:
        return 1
    return cube_conv.depth_splits(294, cube_conv._padded(n), cube_conv._padded(k),
                                  torch.cuda.get_device_properties(0).multi_processor_count)


def check_padded_train(n: int, cin: int, cout: int, gen) -> dict:
    """bf16 ``cube_conv3x3_train`` at channel counts the kernels take
    zero-padded (Cin or Cout not a multiple of 8): forward, dx and the dw
    and db it returns, against autograd of the plain version in f32 on the
    same bf16-rounded operands, at K1's bf16 tolerance."""
    from cp360_tpu_torch.ops import cube_conv

    dev = "cuda"
    x = torch.randn(n, 6, 7, 7, cin, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(3, 3, cin, cout, generator=gen, device=dev) * (2.0 / (9 * cin)) ** 0.5
    b = torch.randn(cout, generator=gen, device=dev) * 0.1
    wc, bc = w.bfloat16(), b.bfloat16()
    dy = torch.randn(n, 6, 7, 7, cout, generator=gen, device=dev).to(torch.bfloat16)
    xg, wp, bp = x.clone().requires_grad_(), w.clone().requires_grad_(), b.clone().requires_grad_()
    def fwd_bwd():
        y = cube_conv.cube_conv3x3_train(xg, wp, bp, wc=wc, bc=bc)
        y.backward(dy)
        return y

    out, got = counted_run({}, fwd_bwd)
    launched = (got["cube_conv3x3"], got["cube_conv3x3_dx"])
    xf, wf, bf = (t.float().requires_grad_() for t in (x, wc, bc))
    ref = cube_conv.cube_conv3x3_plain(xf, wf, bf)
    ref.backward(dy.float())
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in (("out", out, ref), ("dx", xg.grad, xf.grad),
                            ("dw", wp.grad, wf.grad), ("db", bp.grad, bf.grad)):
        errs[name] = ((got.float() - want).abs().max().item(), want.abs().max().item())
    ok = (all(e <= 1e-2 * m for e, m in errs.values()) and launched == (1, 1)
          and tuple(wp.grad.shape) == (3, 3, cin, cout) and tuple(xg.grad.shape) == tuple(x.shape))
    res = {"shape": f"bf16 train x[{n},6,7,7,{cin}] -> {cout}", "launches": launched,
           "max_abs_err_and_ref": errs, "passed": ok}
    print(f"K1 padded train {json.dumps(res)}", flush=True)
    return res


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


def check_cube_conv_dx(n: int, cin: int, cout: int, dtype: torch.dtype, gen) -> dict:
    from cp360_tpu_torch.bench.common import (H100_BF16_FLOPS, H100_F32_FLOPS, bound_ms,
                                              library_dx)
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


K2_LIBRARY_F64_TOL = 1e-5  # the library form in f64 vs the plain version, on [0, 1]


def library_equi_to_cube(frames: torch.Tensor, fw: int, ref: torch.Tensor) -> dict:
    """K2's function as one PyTorch call, a yardstick the port never calls:
    the /255 of the NHWC u8 batch in f32 (none for an f32 batch), the
    permute to NCHW (a view) and one ``F.grid_sample(mode="bilinear",
    padding_mode="border", align_corners=True)`` over a [N, 6*fw, fw, 2]
    grid built once from ``resample.equi2cube_maps`` (border clamping is
    the plain version's clamped taps).  Both it and the grid_sample call
    alone are timed by a CUDA graph of 50, as K2's device_ms.

    grid_sample takes normalized coordinates and recomputes each in f32
    (``(g + 1) / 2 * (size - 1)``), where an f32 ulp at x = 1919 is 1.2e-4
    px: it cannot place a tap where the f32 maps do, so on random frames the
    f32 form lies up to the coordinates' round trip (times the largest step
    between neighbours, 1 on [0, 1]) from the plain version, and is held to
    that plus 1e-6.  The same call in f64 (frame, grid) is held to
    ``K2_LIBRARY_F64_TOL``: it shows the same function."""
    import torch.nn.functional as F

    from cp360_tpu_torch.bench.equi_gather import graph_ms
    from cp360_tpu_torch.ops import resample

    n, h, w, _ = frames.shape
    xs, ys = resample.equi2cube_maps(fw, h, w, frames.device)
    # normalized in f32 on the host: with IEEE's division there,
    # grid_sample's unnormalize gives the maps back within half the error
    # that a CUDA division by a scalar (a product with its reciprocal) leaves
    gx, gy = ((v.cpu() / (s - 1) * 2 - 1).to(frames.device) for v, s in ((xs, w), (ys, h)))
    grid = torch.stack([gx, gy], -1).reshape(1, 6 * fw, fw, 2).expand(n, -1, -1, -1)
    grid = grid.contiguous()
    u8 = frames.dtype == torch.uint8

    def sample(nchw, g):
        return F.grid_sample(nchw, g, mode="bilinear", padding_mode="border",
                             align_corners=True)

    def form():
        return sample((frames.float() / 255.0 if u8 else frames).permute(0, 3, 1, 2), grid)

    def nhwc(out):  # [N, C, 6*fw, fw] -> the plain version's [N, 6, fw, fw, C]
        return out.reshape(n, -1, 6, fw, fw).permute(0, 2, 3, 4, 1)

    got = nhwc(form())
    err = (got.cpu() - ref).abs().max().item()
    # each coordinate as grid_sample recomputes it, against the map's
    trip = [((g + 1) / 2 * (s - 1) - v).abs().max().item()
            for g, s, v in ((gx, w, xs), (gy, h, ys))]
    tol = sum(trip) + 1e-6
    f64 = frames.double() / 255.0 if u8 else frames.double()
    grid64 = torch.stack([xs.double() / (w - 1) * 2 - 1, ys.double() / (h - 1) * 2 - 1], -1)
    grid64 = grid64.reshape(1, 6 * fw, fw, 2).expand(n, -1, -1, -1).contiguous()
    got64 = nhwc(sample(f64.permute(0, 3, 1, 2), grid64)).cpu()
    err64 = (got64 - ref.double()).abs().max().item()
    del f64, grid64, got64
    library_ms = float(np.median(graph_ms(form)))
    src = (frames.float() / 255.0 if u8 else frames).permute(0, 3, 1, 2)
    grid_sample_ms = float(np.median(graph_ms(lambda: sample(src, grid))))
    return {"library_ms": library_ms, "library_grid_sample_ms": grid_sample_ms,
            "library_max_abs_err": err, "library_tol": tol, "library_coord_round_trip": trip,
            "library_f64_max_abs_err": err64, "library_f64_tol": K2_LIBRARY_F64_TOL,
            "library_passed": err <= tol and err64 <= K2_LIBRARY_F64_TOL}


def check_equi_to_cube(n: int, dtype: torch.dtype, gen) -> dict:
    from cp360_tpu_torch.bench.common import H100_F32_FLOPS, bound_ms
    from cp360_tpu_torch.bench.equi_gather import graph_ms
    from cp360_tpu_torch.ops import equi_gather, resample

    dev, h, w, fw = "cuda", 960, 1920, 224
    frames = torch.randint(0, 256, (n, h, w, 3), generator=gen, device=dev,
                           dtype=torch.int64).to(torch.uint8)
    if dtype == torch.float32:
        frames = frames.float() / 255.0
    got = equi_gather.equi_to_cube(frames, fw)
    again = equi_gather.equi_to_cube(frames, fw)
    three = equi_gather.equi_to_cube(frames[:3], fw)
    alone = [equi_gather.equi_to_cube(frames[i:i + 1], fw) for i in range(three.shape[0])]
    ref = equi_gather.equi_to_cube_plain(frames.cpu(), fw)
    torch.cuda.synchronize()
    bits = torch.int32
    bit_equal = torch.equal(got.cpu().view(bits), ref.view(bits))
    repeat_equal = torch.equal(got.view(bits), again.view(bits))
    batch_equal = all(torch.equal(a.view(bits), three[i:i + 1].view(bits))
                      for i, a in enumerate(alone))
    err = (got.cpu() - ref).abs().max().item()
    ok = bit_equal and repeat_equal and batch_equal and tuple(got.shape) == (n, 6, fw, fw, 3)

    ms = cuda_ms(lambda: equi_gather.equi_to_cube(frames, fw), iters=50)
    device_ms = float(np.median(graph_ms(lambda: equi_gather.equi_to_cube(frames, fw))))
    torch.cuda.synchronize()
    t = time.perf_counter()  # the wrapper's host time per call: enqueue only
    for _ in range(50):
        equi_gather.equi_to_cube(frames, fw)
    host_us = (time.perf_counter() - t) / 50 * 1e6
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: equi_gather.equi_to_cube_plain(frames, fw), iters=5)
    lib = library_equi_to_cube(frames, fw, ref)
    xs, _ = resample.equi2cube_maps(fw, h, w, frames.device)
    n_out = n * 6 * fw * fw * 3
    item = frames.element_size()
    # each distinct tap byte once, both f32 maps once, the f32 faces once
    n_bytes = (n * equi_gather.source_bytes(fw, h, w, 3, item) + 2 * 4 * xs.numel()
               + 4 * n_out)
    # per output value: 4 taps /255, 4 weight products, 3 adds
    n_ops = 11.0 * n_out
    bms, by = bound_ms(n_bytes, n_ops, H100_F32_FLOPS)
    res = {"shape": f"{'u8' if dtype == torch.uint8 else 'f32'} [{n},{h},{w},3] -> "
                    f"[{n},6,{fw},{fw},3] f32",
           "max_abs_err": err, "tol": 0.0, "bit_equal_cpu_plain": bit_equal,
           "repeat_bit_equal": repeat_equal, "batch_of_3_bit_equal": batch_equal,
           "passed": ok and lib["library_passed"], "ms": ms, "device_ms": device_ms,
           "host_us": host_us, "plain_ms": plain_ms, **lib,
           "bound_ms": bms, "bound_by": by, "bound_bytes": n_bytes,
           "source_sectors": equi_gather.source_sectors(fw, h, w, 3, item),
           "frame_sectors": h * w * 3 * item // 32,
           "share_of_bound": bms / device_ms}
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
    from cp360_tpu_torch.bench.common import H100_F32_FLOPS, bound_ms
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


def check_conv_epilogue(shape, dtype: torch.dtype, gen, act="relu", residual=False,
                        conv_bias=False, res_dtype=None) -> dict:
    """The conv epilogue (``ops/conv_epilogue.py``) bit for bit against its
    plain version on the card, in place, with the vectors that
    ``layers.fold`` hands it for a conv of ``dtype`` (with a bias where
    ``conv_bias``) and a batch norm of random statistics: a bf16 conv's
    shift alone, an f32 conv's shift, scale and conv bias; and its time
    against the bytes bound: x (and the residual) read once, y written
    once.  ``res_dtype`` f32 to a bf16 x: ConvNeXt's form, an f32 y."""
    from cp360_tpu_torch.bench.common import H100_F32_FLOPS, bound_ms
    from cp360_tpu_torch.models import layers
    from cp360_tpu_torch.ops import conv_epilogue as ce

    c = shape[-1]
    x = (4 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    res = (4 * torch.randn(shape, generator=gen, device="cuda")).to(res_dtype or dtype) \
        if residual else None

    def rand(lo, hi):
        return lo + (hi - lo) * torch.rand(c, generator=gen, device="cuda")
    bn = {"scale": rand(0.5, 2.0), "bias": rand(-1.0, 1.0), "mean": rand(-1.0, 1.0),
          "var": rand(0.5, 2.0)}
    conv = layers.Conv(torch.randn((c, 8, 1, 1), generator=gen, device="cuda").to(dtype),
                       rand(-1.0, 1.0) if conv_bias else None)
    _, _, shift, scale, pre = layers.fold(conv, layers.BatchNorm(bn), dtype)
    with torch.no_grad():
        want = ce.plain_epilogue(x, shift, scale, pre, res, act)
        got = ce.conv_epilogue(x.clone(), shift, scale, pre, res, act)
        torch.cuda.synchronize()
        ints = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
        same_bits = torch.equal(got.view(ints), want.view(ints))
        err = (got.float() - want.float()).abs().max().item()
        # GELU: erff against erf, so within one ulp of the storage dtype
        tol = 0.0 if act != "gelu" else (2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -20)
        passed = bool(same_bits) or (act == "gelu" and torch.allclose(
            got.float(), want.float(), rtol=tol, atol=1e-6))
        work = x.clone()
        into = None if res is None or res.dtype == x.dtype else res.clone()
        ms = cuda_ms(lambda: ce.conv_epilogue(work, shift, scale, pre, res, act, out=into),
                     iters=50)
        plain_ms = cuda_ms(lambda: ce.plain_epilogue(x, shift, scale, pre, res, act), iters=20)
    n_bytes = x.numel() * (x.element_size() + got.element_size()) + \
        (0 if res is None else res.numel() * res.element_size())
    steps = sum(v is not None for v in (shift, scale, pre, res)) + (act is not None)
    n_ops = float(x.numel()) * steps  # adds, a multiply, the compare
    bms, by = bound_ms(n_bytes, n_ops, H100_F32_FLOPS)
    given = [k for k, v in (("shift", shift), ("scale", scale), ("conv_bias", pre),
                            ("residual", res)) if v is not None]
    kind = str(dtype).split('.')[-1] + ("" if got.dtype == dtype else "->f32")
    res_line = {"shape": f"{kind} {list(shape)} {act} " + "+".join(given),
                "max_abs_err": err, "tol": tol, "bit_equal": bool(same_bits),
                "passed": passed, "ms": ms, "plain_ms": plain_ms,
                "library_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                "gbytes_per_s": n_bytes / (ms * 1e-3) / 1e9, "share_of_bound": bms / ms}
    print(f"conv_epilogue {json.dumps(res_line)}", flush=True)
    return res_line


def check_cube_dwconv(s: int, c: int, dtype: torch.dtype, gen, faces: int = 48,
                      out_dtype=None) -> dict:
    """The cube-padded depthwise 7x7 (``ops/cube_dwconv.py``) from
    ``dtype`` faces to ``out_dtype`` (``dtype`` by default) against its
    plain version on the card, within one ulp of the output dtype (both
    sum in f32 and round once after the bias; only their order differs),
    and its time against its bound, the plain version's and the library
    form's (the cube pad's copy and cuDNN's grouped conv in the faces'
    dtype, never called by the port)."""
    import torch.nn.functional as F

    from cp360_tpu_torch.bench.common import H100_F32_FLOPS, bound_ms
    from cp360_tpu_torch.models import layers
    from cp360_tpu_torch.ops import cube_dwconv as dw

    x = torch.randn((faces, s, s, c), generator=gen, device="cuda").to(dtype)
    w = (0.1 * torch.randn((7, 7, c), generator=gen, device="cuda")).to(dtype).permute(2, 0, 1)
    b = torch.randn(c, generator=gen, device="cuda")
    out_dtype = out_dtype or dtype
    with torch.no_grad():
        got = dw.cube_dwconv(x, w, b, out_dtype=out_dtype)
        want = dw.plain_cube_dwconv(x, w, b, out_dtype=out_dtype)
        torch.cuda.synchronize()
        rtol = 2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-5
        atol = 1e-4 * float(want.float().abs().max())
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
        bias = b.to(dtype)

        def library():
            xp = layers.pad_faces(x, 3).permute(0, 3, 1, 2)
            return F.conv2d(xp, w[:, None], bias, groups=c)

        ms = cuda_ms(lambda: dw.cube_dwconv(x, w, b, out_dtype=out_dtype), iters=50)
        plain_ms = cuda_ms(lambda: dw.plain_cube_dwconv(x, w, b, out_dtype=out_dtype), iters=10)
        library_ms = cuda_ms(library, iters=20)
    item = x.element_size()
    n_bytes = x.numel() * (item + got.element_size()) + 49 * c * item + 4 * c
    n_ops = 2.0 * 49 * x.numel()
    bms, by = bound_ms(n_bytes, n_ops, H100_F32_FLOPS)
    kind = str(dtype).split('.')[-1] + ("" if out_dtype == dtype else "->bf16")
    res = {"shape": f"{kind} [{faces},{s},{s},{c}] 7x7",
           "max_abs_err": err, "rtol": rtol, "atol": atol, "passed": bool(ok),
           "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
           "gbytes_per_s": n_bytes / (ms * 1e-3) / 1e9, "share_of_bound": bms / ms}
    print(f"cube_dwconv {json.dumps(res)}", flush=True)
    return res


def check_cube_window_attn(s: int, c: int, heads: int, shift: bool, gen,
                           faces: int = 48) -> dict:
    """Swin's window attention (``ops/cube_window_attn.py``), bf16, on
    ``faces`` faces of s x s tokens, regular or shifted (cube-padded),
    against its plain form (within one bf16 ulp plus 1e-2 of the largest
    output: both round at the same points and differ in the order of the
    f32 sums and exp2f against exp), timed against its bound (bytes: q and
    the output once, k and v as the windows gather them, the qkv bias and
    the table once), the plain form and the library form, never called by
    the port: the bias add, the gather of the windows, SDPA with the
    relative-position bias as its float mask, and the scatter of the
    own-face slots."""
    import torch.nn.functional as F

    from cp360_tpu_torch.bench.common import H100_BF16_FLOPS, bound_ms
    from cp360_tpu_torch.ops import cube_window_attn as wa

    qkv = torch.randn((faces, s, s, 3 * c), generator=gen, device="cuda").to(torch.bfloat16)
    bias = 0.5 * torch.randn(3 * c, generator=gen, device="cuda")
    table = torch.randn((169, heads), generator=gen, device="cuda")
    src, meta = wa.window_maps(s, 7, shift)
    idx = torch.from_numpy(src.reshape(-1).astype(np.int64)).cuda()
    own = torch.from_numpy(meta.reshape(-1) & 1).cuda().bool()
    rel = table[torch.from_numpy(wa.rel_index(7)).cuda()].permute(2, 0, 1)
    rel = rel.to(torch.bfloat16)[None, None]  # [1, 1, heads, 49, 49]
    n, d = faces // 6, c // heads

    def library():
        t = (qkv + bias.to(torch.bfloat16)).reshape(n, 6 * s * s, 3 * c)[:, idx]
        t = t.reshape(n, -1, 49, 3, heads, d).permute(3, 0, 1, 4, 2, 5)
        o = F.scaled_dot_product_attention(t[0], t[1], t[2], attn_mask=rel)
        out = torch.empty((n, 6 * s * s, c), dtype=torch.bfloat16, device="cuda")
        out[:, idx[own]] = o.permute(0, 1, 3, 2, 4).reshape(n, -1, c)[:, own]
        return out

    with torch.no_grad():
        got = wa.cube_window_attn(qkv, bias, table, heads, 7, shift)
        want = wa.plain_window_attn(qkv, bias, table, heads, 7, shift)
        lib = library().reshape(got.shape)
        torch.cuda.synchronize()
        atol = 1e-2 * float(want.float().abs().max())
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=2.0 ** -7, atol=atol)
        lib_err = (lib.float() - want.float()).abs().max().item()
        ms = cuda_ms(lambda: wa.cube_window_attn(qkv, bias, table, heads, 7, shift), iters=50)
        plain_ms = cuda_ms(lambda: wa.plain_window_attn(qkv, bias, table, heads, 7, shift),
                           iters=5)
        library_ms = cuda_ms(library, iters=20)
    nw = wa.windows_per_face(s, 7, shift)
    n_bytes = 2 * (2 * faces * s * s * c + 2 * faces * nw * 49 * c) + 4 * (3 * c + 169 * heads)
    n_ops = 4.0 * 49 * 49 * c * nw * faces
    bms, by = bound_ms(n_bytes, n_ops, H100_BF16_FLOPS)
    res = {"shape": f"bf16 [{faces},{s},{s},{3 * c}] {heads} heads "
                    f"{'shifted' if shift else 'regular'} ({nw} windows a face)",
           "max_abs_err": err, "atol": atol, "library_max_abs_err": lib_err,
           "passed": bool(ok), "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bms, "bound_by": by, "gbytes_per_s": n_bytes / (ms * 1e-3) / 1e9,
           "tflops": n_ops / (ms * 1e-3) / 1e12, "share_of_bound": bms / ms}
    print(f"cube_window_attn {json.dumps(res)}", flush=True)
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
    # channel counts the bf16 kernels take zero-padded: a ConvLSTM with
    # hidden_size 250 (conv1 Cin 1250 -> 1000) and an odd hidden_size 63
    # (input 63: Cin 126 -> Cout 252)
    padded = [check_cube_conv(8, 1250, 1000, torch.bfloat16, gen),
              check_cube_conv(8, 126, 252, torch.bfloat16, gen),
              check_cube_conv_dx(8, 1250, 1000, torch.bfloat16, gen),
              check_cube_conv_dx(8, 126, 252, torch.bfloat16, gen),
              check_padded_train(2, 1250, 1000, gen), check_padded_train(2, 126, 252, gen)]
    for n in (8, 1):
        split_sweep(n, 4000, 4000, gen)
    k2 = [check_equi_to_cube(8, torch.uint8, gen),
          check_equi_to_cube(16, torch.uint8, gen),
          check_equi_to_cube(2, torch.float32, gen)]
    k3 = [check_cube_pool(8, torch.bfloat16, gen),
          check_cube_pool(16, torch.bfloat16, gen),
          check_cube_pool(2, torch.float32, gen),
          check_cube_pool(8, torch.bfloat16, gen, specials=True)]
    # each backbone conv's epilogue at the stream's batch of 8 (48 faces), as
    # the bf16 trunk calls it (the shift alone): VGG16-BN's first convs,
    # ResNet-50's layer1 conv3 (with its residual) and stem; and an f32
    # conv with a bias, whose epilogue takes the conv bias, scale and shift
    epi = [check_conv_epilogue((48, 224, 224, 64), torch.bfloat16, gen, conv_bias=True),
           check_conv_epilogue((48, 56, 56, 256), torch.bfloat16, gen, residual=True),
           check_conv_epilogue((48, 112, 112, 64), torch.bfloat16, gen),
           check_conv_epilogue((2, 56, 56, 256), torch.float32, gen, "relu6", residual=True,
                               conv_bias=True),
           check_conv_epilogue((48, 56, 56, 512), torch.bfloat16, gen, "gelu", conv_bias=True),
           check_conv_epilogue((48, 56, 56, 128), torch.bfloat16, gen, None, residual=True,
                               conv_bias=True, res_dtype=torch.float32)]
    # ConvNeXt-B's depthwise convs at the stream's batch of 8 (48 faces), from
    # the f32 residual stream to bf16 as the main path runs them
    f32 = torch.float32
    dwc = [check_cube_dwconv(56, 128, f32, gen, out_dtype=torch.bfloat16),
           check_cube_dwconv(28, 256, f32, gen, out_dtype=torch.bfloat16),
           check_cube_dwconv(14, 512, f32, gen, out_dtype=torch.bfloat16),
           check_cube_dwconv(7, 1024, f32, gen, out_dtype=torch.bfloat16),
           check_cube_dwconv(14, 512, torch.bfloat16, gen),
           check_cube_dwconv(14, 512, f32, gen)]
    # Swin-B's window attention at the stream's batch of 8 (48 faces): each
    # stage's regular and shifted (cube-padded) layers; stage 4 is one window
    wat = [check_cube_window_attn(s, c, c // 32, shift, gen)
           for s, c in ((56, 128), (28, 256), (14, 512), (7, 1024))
           for shift in ((False, True) if s > 7 else (False,))]
    bad = [r["shape"] for r in k1 + k1dx + padded + k2 + k3 + epi + dwc + wat
           if not r["passed"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    # the JSON line reports the dominant main-path conv (2 of the 3 per
    # step), equi->cube at a serving bucket of 8 and the stem pool at an
    # extraction batch of 16
    return {"cube_conv3x3": k1[1], "cube_conv3x3_dx": k1dx[0], "equi_to_cube": k2[0],
            "cube_pool3x3s2": k3[1], "conv_epilogue": epi[0], "cube_dwconv": dwc[2],
            "cube_window_attn": wat[1]}


# ---- phase 3: the serving slice ----------------------------------------------


def step_stage1_single_frame(params: dict, frame_u8: np.ndarray, counted: dict) -> None:
    """``stage1_step`` on one full-width frame (resnet50, bf16, ``halo``, on
    the card), on the u8 frame and on the float frame u8/255, which
    quantizes back to the same u8: both bit-equal to ``stage1_batch`` on
    the u8 frame, one K2 and one K3 launch a step (added to ``counted``)."""
    from cp360_tpu_torch.compat.jax_params import backbone_from_params
    from cp360_tpu_torch.pipelines.extract import stage1_batch, stage1_step

    model = backbone_from_params(params, "resnet50", True, torch.bfloat16, "cuda",
                                 cube_conv_form="halo")
    u8 = torch.from_numpy(frame_u8)
    f01 = u8.float() / 255.0
    with torch.no_grad():
        want = [t[0] for t in stage1_batch(model, u8.cuda()[None])]
        outs = {}
        for name, frame in (("u8", u8), ("float", f01)):
            outs[name], n = counted_run(counted, lambda: stage1_step(model, frame))
            if (n["equi_to_cube"], n["cube_pool3x3s2"], n["cube_conv3x3"]) != (1, 1, 0):
                fail(f"stage1_step on the {name} frame launched {n}")
    equal = {name: all(torch.equal(a, b) for a, b in zip(got, want))
             for name, got in outs.items()}
    shapes = [tuple(t.shape) for t in outs["u8"]]
    print(f"slice: stage1_step (resnet50, bf16, halo) bit-equal to stage1_batch: {equal}, "
          f"shapes {shapes}", flush=True)
    if not all(equal.values()) or shapes != [(6, 7, 7, 1000), (14, 28)]:
        fail(f"stage1_step differs from stage1_batch: {equal}, shapes {shapes}")
    del model


def phase_slice() -> dict:
    from cp360_tpu_torch.compat import jax_params
    from cp360_tpu_torch.config import Config
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

    def serve():
        with ThreadPoolExecutor(max_workers=6) as pool:
            sess_futs = [pool.submit(run_session, s) for s in sessions]
            pred_futs = [pool.submit(predict, f) for f in frames + frames]
            return [f.result() for f in pred_futs], [f.result() for f in sess_futs]

    stage1_b0 = model._batcher.stats["batches"]
    temporal_b0 = model._temporal_batcher.stats["batches"]
    counted: dict = {}
    t0 = time.monotonic()
    (preds, sess_out), _ = counted_run(counted, serve)
    wall = time.monotonic() - t0
    k1_launches, k2_launches = counted["cube_conv3x3"], counted["equi_to_cube"]
    k3_launches = counted["cube_pool3x3s2"]
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
          f"{k2_launches}, K3 launches {k3_launches}, dx launches "
          f"{counted['cube_conv3x3_dx']}", flush=True)
    if k1_launches == 0 or k2_launches == 0 or k3_launches == 0 or counted["cube_conv3x3_dx"]:
        fail("a kernel of the path was never launched")
    if k1_launches != 3 * cfg.seq_len * temporal_batches:
        fail(f"K1 launched {k1_launches} times for {temporal_batches} window batches")
    if k2_launches != stage1_batches or k3_launches != stage1_batches:
        fail(f"K2 launched {k2_launches} and K3 {k3_launches} times for "
             f"{stage1_batches} stage-1 batches")

    step_stage1_single_frame(params, frames[0], counted)

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

    # f32 on the card (kernels) vs the plain f32 path on the CPU, with
    # cuDNN's TF32 flag at its default (True): the port's f32 convs switch
    # it off themselves
    from cp360_tpu_torch.compat.jax_params import clstm_from_params, resnet_from_params

    errs = {}
    torch.backends.cudnn.allow_tf32 = True
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
    if torch.backends.cudnn.allow_tf32:
        fail("an f32 stage 1 left cuDNN's TF32 on")
    print(f"slice: f32 card vs CPU, started with cuDNN's flags at their defaults, "
          f"max|err| (max|ref|): {errs}", flush=True)

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
    return counted


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


def list_vs_loader(art: Path, tmp: Path, counted: dict) -> dict:
    """``loop.train`` fed one epoch's batches as a plain list against the
    same batches through the CLI's loader (its ``iter_epoch``), at full
    width (ConvLSTM 1000/1000, seq_len 5, bf16 convs, batch 1) from the same
    initial params.  The final params must be equal bit for bit, as the
    options phase's segment check holds a step; when they are not, both
    runs repeat under ``torch.use_deterministic_algorithms`` and must be
    equal there."""
    from cp360_tpu_torch.compat.jax_params import flatten_params, init_clstm_params
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.data.dataset import PrefetchLoader, WindowDataset, builtin_split
    from cp360_tpu_torch.train import loop

    cfg = Config(epochs=1, summary_freq=10**9, save_freq=10**9, clstm_conv_impl="pallas")
    loader = PrefetchLoader(WindowDataset(str(art), None, builtin_split("train_60"), cfg.seq_len),
                            batch_size=cfg.batch_size, shuffle=True, num_threads=cfg.processes)
    batches = list(loader.iter_epoch(0))
    init = init_clstm_params(0, cfg.input_size, cfg.hidden_size)
    quiet = dict(log_fn=lambda *a, **k: None, device="cuda", params=init)

    def run(tag, feed):
        got: dict = {}
        t0 = time.monotonic()
        out, _ = counted_run(got, lambda: loop.train(
            cfg.replace(checkpoint_path=str(tmp / f"ck_{tag}")), feed, **quiet))
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        for k, v in got.items():
            counted[k] = counted.get(k, 0) + v
        if got["cube_conv3x3"] != 15 * len(batches) or got["cube_conv3x3_dx"] != 14 * len(batches):
            fail(f"train from a {tag}: per step K1 {got['cube_conv3x3'] / len(batches)}, "
                 f"dx {got['cube_conv3x3_dx'] / len(batches)} launches (want 15, 14)")
        return flatten_params(out), seconds

    def both():
        (a, s_list), (b, s_loader) = run("list", batches), run("loader", loader)
        return {"list_s": s_list, "loader_s": s_loader, "bit_equal": trees_equal(a, b),
                "max_abs_diff": max_bits_diff(a, b)}

    res = {"steps": len(batches), "default": both()}
    if not res["default"]["bit_equal"]:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            res["deterministic_algorithms"] = both()
        finally:
            torch.use_deterministic_algorithms(False)
    return res


def phase_train() -> dict:
    from cp360_tpu_torch.cli import train_temporal
    from cp360_tpu_torch.compat.jax_params import init_clstm_params, load_npz
    from cp360_tpu_torch.config import Config
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
        counted: dict = {}
        t0 = time.monotonic()
        trained, _ = counted_run(counted, lambda: train_temporal.main(argv))
        wall = time.monotonic() - t0
        k1, dx = counted["cube_conv3x3"], counted["cube_conv3x3_dx"]

        recs = [json.loads(line) for line in metrics.read_text().splitlines()]
        steps = len(recs)
        print(f"train: CLI ran {steps} steps in {wall:.1f} s (checkpoints included); "
              f"K1 launches {k1}, dx launches {dx}; losses "
              f"{[round(r['loss_avg'], 4) for r in recs]}", flush=True)
        if steps != n_windows or steps < 3:
            fail(f"expected {n_windows} (>= 3) logged steps at batch 1, got {steps}")
        if not all(np.isfinite(r["loss_avg"]) for r in recs):
            fail(f"non-finite training loss: {recs}")
        if k1 != 15 * steps or dx != 14 * steps or counted["equi_to_cube"] \
                or counted["cube_pool3x3s2"]:
            fail(f"per step K1 ran {k1 / steps}, dx {dx / steps} times (want 15, 14); "
                 f"launches {counted}")
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

        plain = list_vs_loader(tmp / "art", tmp, counted)
        final = plain.get("deterministic_algorithms", plain["default"])
        print(f"train: loop.train from a list of {plain['steps']} batches vs the loader: "
              f"{final['list_s']:.2f} s vs {final['loader_s']:.2f} s, largest param difference "
              f"{final['max_abs_diff']:.3g}; {json.dumps(plain)}", flush=True)
        if not final["bit_equal"]:
            fail(f"training from a list differs from training from the loader: {plain}")
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
    return counted


# ---- phase 5: the trainer's options -------------------------------------------

# the int8 loader codec's relative loss gap on int8_gap_window in the JAX
# package, f32 on the CPU (tools/int8_loss_gap.py: losses 58.4737548828125
# plain, 58.57939147949219 int8); the card's f32 gap must lie within
# INT8_GAP_MARGIN of it on either side (a codec that skipped quantizing
# would show a gap of 0): each of its two losses may lie 1e-4 relative
# from the CPU's, the f32 agreement the train phase requires
# (f32_card_vs_cpu)
INT8_GAP_JAX = 1.8065642764244275e-3
INT8_GAP_MARGIN = 2e-4
VAL_AUC_TOL = 1e-6  # validation on the card vs the CPU, ConvLSTM 64/64 f32


def int8_gap_window(seed: int = 13):
    """One seeded full-width window, as tools/int8_loss_gap.py builds it:
    CAM cubes [1, 5, 6, 7, 7, 1000] f16 (the artifacts' dtype), flows
    [1, 5, 480, 960, 2] f32."""
    rng = np.random.RandomState(seed)
    seq = rng.gamma(0.5, 2.0, (1, 5, 6, 7, 7, 1000)).astype(np.float16)
    flows = (rng.standard_normal((1, 5, 480, 960, 2)) * 2.0).astype(np.float32)
    return seq, flows


def max_bits_diff(a: dict, b: dict) -> float:
    """Largest |a - b| over two dicts of f32 arrays (0.0 when bit-equal)."""
    return max(float(np.abs(a[n].astype(np.float64) - b[n]).max()) for n in a)


def trees_equal(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[n].view(np.uint32), b[n].view(np.uint32)) for n in a)


def segment_step_bits(params: dict, gen) -> dict:
    """One full-width Adam step (bf16, batch 8) on 2 segments of G = 4
    windows against the step on the 8 windows they expand to, built here
    by indexing: the same K1 and dx shapes, so the same bits, compared on
    the loss, every gradient and every updated weight (Adam's first update
    is about -lr sign(g), so the weights alone would hide a gradient
    difference).  The direct step runs twice first: if it does not repeat
    bit for bit, the three steps run again under
    ``torch.use_deterministic_algorithms``."""
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.train import loop

    cfg = Config(batch_size=8, clstm_conv_impl="pallas")
    seg = torch.rand(2, 8, 6, 7, 7, 1000, generator=gen, device="cuda").half()
    seg_flows = torch.randn(2, 8, 480, 960, 2, generator=gen, device="cuda") * 2.0
    direct = torch.stack([seg[s, k:k + 5] for s in range(2) for k in range(4)])
    direct_flows = torch.stack([seg_flows[s, k:k + 5] for s in range(2) for k in range(4)])

    def step(c, seq, flows):
        model = loop.trainable_clstm(c, params, "cuda")
        m = loop.make_train_step(c, model, loop.make_optimizer(c, model))(seq, flows)
        out = {}
        for name, p in model.named_parameters():
            out[name] = p.detach().cpu().numpy()
            out[f"{name}.grad"] = p.grad.detach().cpu().numpy()
        del model
        return float(m["loss"]), out

    def three():
        (l1, d1), (l2, d2) = step(cfg, direct, direct_flows), step(cfg, direct, direct_flows)
        ls, s1 = step(cfg.replace(segment_windows=4), seg, seg_flows)
        return {"direct_repeat_bit_equal": trees_equal(d1, d2) and l1 == l2,
                "direct_repeat_max_diff": max_bits_diff(d1, d2),
                "segment_bit_equal": trees_equal(s1, d1) and ls == l1,
                "segment_max_diff": max_bits_diff(s1, d1), "loss": l1, "segment_loss": ls}

    res = {"default": three()}
    if not res["default"]["direct_repeat_bit_equal"]:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            res["deterministic_algorithms"] = three()
        finally:
            torch.use_deterministic_algorithms(False)
    return res


def train_forms_timing(params: dict) -> dict:
    """Full-width train step time at batch 8 windows (bf16), from the host
    numpy batch the loader yields to the updated weights: the copy to the
    card included, since what segments and the int8 codec change is the
    bytes that cross.  Four forms of the same 8 windows: direct (f16 CAMs,
    f32 flows), 2 segments of 4, int8 (int8 CAMs + f32 scales, f16 flows)
    and both.  Host clock between two synchronizes, the mean of 2 steps
    after 1 warm-up step; the forms step one model in turn (the weights'
    values do not change the work)."""
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.ops.quantize import Quantized, quantize_cam_np
    from cp360_tpu_torch.train import loop

    rng = np.random.RandomState(SEED + 16)
    seg = rng.gamma(0.5, 2.0, (2, 8, 6, 7, 7, 1000)).astype(np.float16)
    seg_flows = (rng.standard_normal((2, 8, 480, 960, 2)) * 2.0).astype(np.float32)
    direct = np.stack([seg[s, k:k + 5] for s in range(2) for k in range(4)])
    direct_flows = np.stack([seg_flows[s, k:k + 5] for s in range(2) for k in range(4)])

    def int8(seq, flows):
        return Quantized(*quantize_cam_np(seq)), flows.astype(np.float16)

    def nbytes(a):
        return sum(x.nbytes for x in a) if isinstance(a, Quantized) else a.nbytes

    forms = {"direct": (1, (direct, direct_flows)), "segments": (4, (seg, seg_flows)),
             "int8": (1, int8(direct, direct_flows)), "segments_int8": (4, int8(seg, seg_flows))}
    dev = torch.device("cuda")
    cfg = Config(batch_size=8, clstm_conv_impl="pallas")
    model = loop.trainable_clstm(cfg, params, dev)
    opt = loop.make_optimizer(cfg, model)
    res = {}
    for name, (group, (seq, flows)) in forms.items():
        step = loop.make_train_step(cfg.replace(segment_windows=group), model, opt)
        times = []
        for i in range(3):
            torch.cuda.synchronize()
            t = time.monotonic()
            step(loop.batch_to_device(seq, dev), loop.batch_to_device(flows, dev))
            torch.cuda.synchronize()
            if i >= 1:
                times.append(1e3 * (time.monotonic() - t))
        res[name] = {"step_ms": float(np.mean(times)), "step_ms_all": times,
                     "batch_mb": (nbytes(seq) + nbytes(flows)) / 1e6}
    del model, opt, step
    torch.cuda.empty_cache()
    return res


def int8_loss_gap(params: dict) -> dict:
    """The loss of int8_gap_window as the plain loader ships it (f16 CAMs,
    f32 flows) and as the int8 loader ships it (int8 CAMs with f32 scales,
    f16 flows), forward only, in f32 (TF32 off) and in bf16."""
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.data.dataset import PrefetchLoader
    from cp360_tpu_torch.ops.quantize import Quantized
    from cp360_tpu_torch.train import loop

    seq, flows = int8_gap_window()

    class One:  # the loader's codec on this one batch
        def get_batch(self, idxs, n_threads=0, empty=None):
            return seq, flows

    q_seq, q_flows = PrefetchLoader(One(), 1, transfer_codec="int8").load_batch([0])
    shipped = {"seq": type(q_seq).__name__,
               "dtypes": [str(a.dtype) for a in (*q_seq, q_flows)]}
    if not isinstance(q_seq, Quantized) or shipped["dtypes"] != ["int8", "float32", "float16"] \
            or q_seq.q.shape != seq.shape or q_flows.shape != flows.shape:
        fail(f"the int8 loader shipped {shipped}, shapes {q_seq[0].shape}, {q_flows.shape}: "
             "want Quantized int8 CAMs with f32 scales and f16 flows")
    dev = torch.device("cuda")
    res = {}
    for dtype in ("float32", "bfloat16"):
        cfg = Config(compute_dtype=dtype, clstm_conv_impl="pallas")
        model = loop.trainable_clstm(cfg, params, dev)
        loss_fn = loop.make_loss_fn(cfg, model)
        with torch.no_grad():
            none = float(loss_fn(loop.batch_to_device(seq, dev), loop.batch_to_device(flows, dev))[0])
            int8 = float(loss_fn(loop.batch_to_device(q_seq, dev),
                                 loop.batch_to_device(q_flows, dev))[0])
        res[dtype] = {"loss_none": none, "loss_int8": int8, "rel_gap": abs(int8 - none) / abs(none)}
        del model
    res["shipped"] = shipped
    return res


def validation_card_vs_cpu(root: Path) -> dict:
    """``run_validation`` at ConvLSTM 64/64 in f32 on the card and on the
    CPU, from the same params, artifacts and GT (and so the same metric RNG
    stream): the aggregate within VAL_AUC_TOL."""
    from cp360_tpu_torch.compat.jax_params import init_clstm_params
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.train.validate import run_validation

    rng = np.random.RandomState(SEED + 11)
    for vid in ("vid_a", "vid_b"):
        (root / "art" / vid / "cube_feat").mkdir(parents=True)
        for i in range(2, 2 + 12):
            np.save(root / "art" / vid / "cube_feat" / f"{i:06}.npy",
                    rng.gamma(0.5, 2.0, (6, 64, 7, 7)).astype(np.float16))
        synthetic_gt(root / "gt", vid, range(4, 11), rng)
    cfg = Config(input_size=64, hidden_size=64, compute_dtype="float32", eval_every_epochs=1,
                 eval_dir=str(root / "art"), label_path=str(root / "gt"), eval_batch_windows=4)
    params = init_clstm_params(SEED + 12, 64, 64)
    card = run_validation(params, cfg, device="cuda", log_fn=lambda *a: None)
    cpu = run_validation(params, cfg, device="cpu", log_fn=lambda *a: None)
    res = {"card": card, "cpu": cpu,
           "max_metric_diff": max(abs(card[k] - cpu[k]) for k in ("AUC", "AUCB", "CC", "SIM"))}
    res["passed"] = bool(abs(card["AUC"] - cpu["AUC"]) <= VAL_AUC_TOL
                         and card["windows"] == cpu["windows"] == 14)
    return res


def phase_options() -> dict:
    """The trainer's options at full width (ConvLSTM 1000/1000, bf16 convs,
    flow_h 480) on seeded synthetic artifacts: segment windows, the int8
    loader codec, in-training validation, a profile and supervision."""
    from cp360_tpu_torch.cli import train_temporal
    from cp360_tpu_torch.compat.jax_params import init_clstm_params
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.data.dataset import builtin_split
    from cp360_tpu_torch.train import loop

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_options_", dir=build))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 13)
    stats = {"card": gpu_line()}
    counted: dict = {}

    def count(fn):
        return counted_run(counted, fn)

    try:
        params = init_clstm_params(0, 1000, 1000)
        # -- one step on 2 segments of 4 windows vs the 8 windows directly
        t0 = time.monotonic()
        bits, got = count(lambda: segment_step_bits(params, gen))
        print(f"options: segment step (2 segments of G=4, batch 8) vs the direct step on its 8 "
              f"windows in {time.monotonic() - t0:.1f} s: {json.dumps(bits)}; launches {got}",
              flush=True)
        final = bits.get("deterministic_algorithms", bits["default"])
        steps = 3 * (2 if "deterministic_algorithms" in bits else 1)
        if not (final["segment_bit_equal"] and final["direct_repeat_bit_equal"]) \
                or got["cube_conv3x3"] != 15 * steps or got["cube_conv3x3_dx"] != 14 * steps:
            fail(f"the segment step is not the direct step bit for bit: {bits}, launches {got}")
        stats["segment_step"] = bits

        # -- the int8 codec: one window's loss, int8 against the plain batch
        gap, got = count(lambda: int8_loss_gap(params))
        off = abs(gap["float32"]["rel_gap"] - INT8_GAP_JAX)
        print(f"options: int8 loader codec, one full-width window, loss gap to the plain batch "
              f"{json.dumps(gap)}; f32 gap {INT8_GAP_JAX} +- {INT8_GAP_MARGIN} (JAX on the CPU, "
              f"tools/int8_loss_gap.py), off by {off}; launches {got}", flush=True)
        if not off <= INT8_GAP_MARGIN or got["cube_conv3x3"] != 4 * 15:
            fail(f"int8 codec f32 loss gap {gap['float32']['rel_gap']} is not within "
                 f"{INT8_GAP_MARGIN} of JAX's {INT8_GAP_JAX}")
        stats["int8_loss_gap"] = gap

        # -- the CLI with every option at once: 2 epochs of one step, each
        # on 2 segments of G = 4 (batch 8) through the int8 codec, under
        # --profile-dir, validated after each epoch against seeded GT, on 2
        # train_60 videos of 9 frames (4 windows, one segment each)
        art = tmp / "art"
        n_windows = write_artifacts(art, n_frames=9)
        gt_rng = np.random.RandomState(SEED + 14)
        for vid in builtin_split("train_60")[:2]:
            synthetic_gt(tmp / "gt", vid, range(4, 8), gt_rng)
        options = ["--set", "segment_windows=4", "--set", "transfer_codec=int8",
                   "--set", "batch_size=8", "--set", "summary_freq=1",
                   "--set", "clstm_conv_impl=pallas"]
        prof_dir, metrics = tmp / "prof", tmp / "train.jsonl"
        argv = ["--input", str(art), "--device", "cuda", "--metrics-jsonl", str(metrics),
                "--set", f"checkpoint_path={tmp / 'ck'}", "--set", "epochs=2", *options,
                "--profile-dir", str(prof_dir), "--set", "eval_every_epochs=1",
                "--set", "eval_patience=1", "--set", f"eval_dir={art}",
                "--set", f"label_path={tmp / 'gt'}", "--set", "eval_batch_windows=4"]
        t0 = time.monotonic()
        _, got = count(lambda: train_temporal.main(argv))
        wall = time.monotonic() - t0
        recs = [json.loads(line) for line in metrics.read_text().splitlines()]
        train = [r for r in recs if r["event"] == "train"]
        vals = [r for r in recs if r["event"] == "val"]
        print(f"options: train_temporal {' '.join(argv[6:])}: {len(train)} steps in {wall:.1f} s "
              f"(checkpoints and validation included), losses "
              f"{[r['loss_avg'] for r in train]}; launches {got}", flush=True)
        # 15 K1 and 14 dx a step; a validation pass is 2 window batches
        # (one a video at eval_batch_windows 4) of 15 K1 each
        if [r["epoch"] for r in train] != [0, 1] \
                or not all(np.isfinite(r["loss_avg"]) for r in train) \
                or got["cube_conv3x3"] != 15 * len(train) + 30 * len(vals) \
                or got["cube_conv3x3_dx"] != 14 * len(train):
            fail(f"train_temporal with segments, int8, validation and a profile: {recs}, "
                 f"launches {got}")
        traces = sorted(prof_dir.glob("*.json"))
        names_k1 = bool(traces) and "cube_conv3x3" in traces[0].read_text()
        print(f"options: --profile-dir wrote {[t.name for t in traces]} "
              f"({sum(t.stat().st_size for t in traces)} bytes); names K1: {names_k1}", flush=True)
        if len(traces) != 1 or not names_k1:
            fail(f"--profile-dir wrote {traces}, naming K1: {names_k1}")
        ckdir = tmp / "ck" / Path(loop.checkpoint_dir(Config())).name
        print(f"options: validation records {json.dumps(vals)}; best.npz "
              f"{(ckdir / 'best.npz').exists()}, early stop "
              f"{[r for r in recs if r['event'] == 'train_early_stop']}", flush=True)
        stats["val_seconds"] = [v["seconds"] for v in vals]
        if len(vals) != 2 or not vals[0]["best"] or vals[0]["windows"] != n_windows \
                or not (ckdir / "best.npz").exists() or not (ckdir / "best_val.json").exists():
            fail(f"validation in training: {vals}")

        # -- validation on the card against the CPU, ConvLSTM 64/64 f32
        val, _ = count(lambda: validation_card_vs_cpu(tmp / "val64"))
        print(f"options: run_validation card vs CPU, ConvLSTM 64/64 f32: {json.dumps(val)} "
              f"(AUC limit {VAL_AUC_TOL})", flush=True)
        if not val["passed"]:
            fail(f"validation on the card differs from the CPU: {val}")

        # -- step times of the four batch forms, outside the counted runs
        stats["train_forms_b8"] = train_forms_timing(params)
        print(f"options: full-width step at 8 windows from the host batch, by form "
              f"{json.dumps(stats['train_forms_b8'])}", flush=True)

        # -- --supervise: the CLI as a supervised child process, in the
        # checkpoint directory of the run above (2 epochs done) with
        # epochs=3: the child must resume that train state and train epoch
        # 2 only (one step), which only the implied --resume does
        metrics = tmp / "sup.jsonl"
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "cp360_tpu_torch.cli.train_temporal", "--supervise", "600",
             "--input", str(art), "--device", "cuda", "--metrics-jsonl", str(metrics),
             "--set", f"checkpoint_path={tmp / 'ck'}", "--set", "epochs=3", *options],
            cwd=str(ROOT), capture_output=True, text=True, timeout=600)
        recs = [json.loads(line) for line in metrics.read_text().splitlines()] \
            if metrics.exists() else []
        resumed = "resumed full train state" in proc.stdout
        print(f"options: train_temporal --supervise as a subprocess: rc {proc.returncode} in "
              f"{time.monotonic() - t0:.1f} s, epochs {[r['epoch'] for r in recs]} trained, "
              f"resumed the run's train state: {resumed}", flush=True)
        if proc.returncode != 0 or not resumed or [r["epoch"] for r in recs] != [2]:
            print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
            fail(f"supervised training: rc {proc.returncode}, records {recs}")
        stats["supervised_s"] = time.monotonic() - t0
        print(f"options: {json.dumps(stats)}", flush=True)
        return counted
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- phase 6: the offline video pipeline ---------------------------------------

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
                      *extra: str, totals: dict):
    """``cli.test_temporal.main`` on the card, from ``root``, after
    np.random.seed(seed), as a counted run added to ``totals``; returns
    (result (CC, AUC, AUCB), host seconds, K1 launches)."""
    from cp360_tpu_torch.cli import test_temporal

    cwd = Path.cwd()
    os.chdir(root)
    np.random.seed(seed)
    try:
        t0 = time.monotonic()
        _, got = counted_run(totals, lambda: test_temporal.main(
            ["--device", "cuda", "--model", str(model), "--dir", str(art_dir),
             "--config", str(config), *extra]))
        wall = time.monotonic() - t0
        result = parse_result((root / f"{art_dir.name}_result.txt").read_text())
    finally:
        os.chdir(cwd)
    return result, wall, got["cube_conv3x3"]


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


def smooth_texture(h: int, w: int, rng) -> np.ndarray:
    """[h, w] u8 multi-scale smooth texture (a natural-image-like
    spectrum), as the JAX package's flow and yuv420 tests make them."""
    import cv2

    img = np.zeros((h, w))
    for scale in (4, 8, 16, 32):
        small = rng.rand(h // scale + 2, w // scale + 2)
        img += cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC) * scale
    return ((img - img.min()) / (img.max() - img.min()) * 255).astype(np.uint8)


def natural_frame(h: int, w: int, rng) -> np.ndarray:
    img = smooth_texture(h, w, rng)
    return np.stack([img, np.roll(img, 2, 0), np.roll(img, 5, 1)], -1)


def flow_scenes(n: int, h: int, w: int, seed: int):
    """n seeded grayscale pairs [n, h, w] u8 with their ground-truth flow:
    a texture, then the same texture moved by a translation (3, -2) px
    (even pairs) or by a disc moving (4, 2.5) px over a still background
    (odd pairs)."""
    import cv2

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    prev, cur, gts = [], [], []
    for i in range(n):
        img = smooth_texture(h, w, rng)
        gt = np.zeros((h, w, 2), np.float32)
        if i % 2 == 0:
            gt[...] = (3.0, -2.0)
        else:
            gt[((yy - h * 0.5) ** 2 + (xx - w * 0.4) ** 2) < (h * 0.22) ** 2] = (4.0, 2.5)
        prev.append(img)
        cur.append(cv2.remap(img, gx - gt[..., 0], gy - gt[..., 1], cv2.INTER_LINEAR,
                             borderMode=cv2.BORDER_REFLECT))
        gts.append(gt)
    return np.stack(prev), np.stack(cur), np.stack(gts)


FLOW_CARD_TOL_PX = 1e-3  # card vs the CPU's plain solve, both backends


def check_flow_solvers() -> dict:
    """Both device flow solvers on the card against the port's own solve on
    the CPU (the same eager torch ops: only the card's rounding can
    differ), at 240x480 (res (480, 240)), 4 pairs: within
    FLOW_CARD_TOL_PX, the batch equal to each pair solved alone, and the
    end-point error against the scenes' ground truth (16-px margin)."""
    from cp360_tpu_torch.flow.optical_flow import horn_schunck_flow_batch, u8_to_unit
    from cp360_tpu_torch.flow.variational import brox_flow_batch

    prev, cur, gt = flow_scenes(4, 240, 480, SEED + 7)
    res = {}
    for name, solve in (("horn_schunck", horn_schunck_flow_batch),
                        ("variational", brox_flow_batch)):
        tp, tc = (u8_to_unit(torch.from_numpy(a).cuda()) for a in (prev, cur))
        card = solve(tp, tc).cpu().numpy()
        alone = np.stack([solve(tp[i:i + 1], tc[i:i + 1])[0].cpu().numpy() for i in range(4)])
        cpu = solve(u8_to_unit(torch.from_numpy(prev)), u8_to_unit(torch.from_numpy(cur)))
        epe = np.linalg.norm(card - gt, axis=-1)[:, 16:-16, 16:-16].mean(axis=(1, 2))
        res[name] = {"card_vs_cpu_px": float(np.abs(card - cpu.numpy()).max()),
                     "tol_px": FLOW_CARD_TOL_PX,
                     "batch_vs_alone_px": float(np.abs(card - alone).max()),
                     "epe_px": [float(e) for e in epe], "max_abs_flow": float(np.abs(card).max())}
    print(f"video: flow solvers on the card vs the CPU, 4 pairs of 240x480: "
          f"{json.dumps(res)}", flush=True)
    for name, r in res.items():
        if not (r["card_vs_cpu_px"] <= FLOW_CARD_TOL_PX and r["batch_vs_alone_px"] == 0.0
                and max(r["epe_px"]) < 0.5):
            fail(f"{name} flow on the card: {r}")
    return res


def flow_speed() -> dict:
    """Pairs per second of each device solver at 16 pairs of 480x960 (the
    extraction's batch at flow_h 480), host clock around a solve that ends
    in a copy to the host, median of 3 after a warm-up; and a profile of one
    Horn-Schunck solve."""
    from cp360_tpu_torch.flow.optical_flow import get_batch_solver_u8

    prev, cur, _ = flow_scenes(16, 480, 960, SEED + 8)
    stats = {}
    for name in ("horn_schunck", "variational"):
        solve = get_batch_solver_u8(name, "float16", "cuda")
        solve(prev, cur).cpu()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.monotonic()
            solve(prev, cur).cpu()
            times.append(time.monotonic() - t)
        stats[f"{name}_s_per_16_pairs"] = times
        stats[f"{name}_pairs_per_s"] = 16 / float(np.median(times))
    solve = get_batch_solver_u8("horn_schunck", "float16", "cuda")
    prof = profile_step(lambda: solve(prev, cur).cpu(), top=8)
    print(f"video: horn_schunck solve, 16 pairs of 480x960, profile {json.dumps(prof)}",
          flush=True)
    stats["horn_schunck_idle_share"] = prof.get("idle_share")
    return stats


def train_on_port_motion(model, root: Path, totals: dict) -> None:
    """Video to trained weights with no artifact from the JAX package:
    ``extract_frames`` with -of -om writes a train_60 video's CAM cubes and
    Horn-Schunck motion at full width (8 frames of a texture moving 6 px a
    frame: 7 artifacts, 2 windows), then ``cli.train_temporal`` trains 2
    steps on them; both are counted runs added to ``totals``."""
    from cp360_tpu_torch.cli import train_temporal
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.data.dataset import builtin_split
    from cp360_tpu_torch.pipelines.extract import extract_frames

    vid = builtin_split("train_60")[0]
    base = natural_frame(960, 1920, np.random.RandomState(SEED + 9))
    frames = [np.roll(base, 6 * t, axis=1) for t in range(8)]
    cfg = Config(cube_dim=224, equi_h=1920, equi_w=960, compute_dtype="bfloat16",
                 host_cube_remap=False, extract_batch=16, opt_flow=True,
                 flow_backend="horn_schunck", feat_dtype="float16")
    n, _ = counted_run(totals, lambda: extract_frames(
        model, cfg, frames, str(root / "art" / vid), output_img=False, output_feature=True,
        output_motion=True, batch_frames=cfg.extract_batch))
    motion = sorted(os.listdir(root / "art" / vid / "motion"))
    flow = np.load(root / "art" / vid / "motion" / motion[-1])
    print(f"video: -om extraction of {vid}: {n} artifacts, motion {motion[0]}..{motion[-1]}, "
          f"{flow.shape} {flow.dtype}, mean dx {float(flow[..., 0].mean())} "
          f"(the texture moves 3 px a frame at flow_h 480)", flush=True)
    if n != 7 or motion != [f"{i:06}.npy" for i in range(2, 9)] \
            or flow.shape != (480, 960, 2) or flow.dtype != np.float32:
        fail("extraction with -om wrote the wrong motion artifacts")
    metrics = root / "metrics.jsonl"
    _, got = counted_run(totals, lambda: train_temporal.main(
        ["--input", str(root / "art"), "--device", "cuda", "--metrics-jsonl", str(metrics),
         "--set", f"checkpoint_path={root / 'ck'}", "--set", "epochs=1",
         "--set", "summary_freq=1", "--set", "clstm_conv_impl=pallas"]))
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    k1 = (got["cube_conv3x3"], got["cube_conv3x3_dx"])
    print(f"video: train_temporal on the port's own motion: {len(recs)} steps, losses "
          f"{[r['loss_avg'] for r in recs]}; K1 {k1[0]}, dx {k1[1]} launches", flush=True)
    if len(recs) != 2 or not all(np.isfinite(r["loss_avg"]) for r in recs) \
            or k1 != (30, 28):
        fail(f"training on port-made motion: {len(recs)} steps, K1/dx {k1}")


def yuv_close(a: np.ndarray, b: np.ndarray):
    """(relative max error, correlation) of b against a, and whether they
    are within the JAX package's yuv420 bound (0.08, 0.998)."""
    rel = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-6))
    corr = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
    return rel, corr, rel < 0.08 and corr > 0.998


def serve_yuv420(totals: dict) -> None:
    """``SaliencyModel`` at full width with ``host_cube_remap: true``, f32,
    serving one natural-spectrum frame as rgb8 and as yuv420: within the
    JAX package's bound (tests/test_serving.py:526-547).  K3 runs on both;
    the serving is a counted run added to ``totals``."""
    from cp360_tpu_torch.compat import jax_params
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.serving.server import SaliencyModel

    params = jax_params.init_resnet_params(SEED, "resnet50", 1000)
    cfg = Config(cube_dim=224, equi_h=1920, equi_w=960, compute_dtype="float32",
                 host_cube_remap=True, serve_max_batch=2)
    frame = natural_frame(960, 1920, np.random.RandomState(SEED + 10))
    sal = {}

    def serve():
        for fmt in ("rgb8", "yuv420"):
            model = SaliencyModel(params, cfg.replace(upload_format=fmt), device="cuda")
            try:
                sal[fmt] = model.predict(frame)
            finally:
                model.close()
            del model

    _, got = counted_run(totals, serve)
    rel, corr, ok = yuv_close(sal["rgb8"], sal["yuv420"])
    k3 = got["cube_pool3x3s2"]
    print(f"video: serving yuv420 vs rgb8 (host remap, f32, one 960x1920 frame): relative "
          f"max error {rel} (limit 0.08), correlation {corr} (limit 0.998); K3 {k3}", flush=True)
    if not ok or k3 != 2:
        fail(f"served yuv420 out of the bound of rgb8 (K3 {k3})")


def phase_video() -> dict:
    from cp360_tpu_torch.cli import extract_features
    from cp360_tpu_torch.compat import jax_params
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.data.dataset import builtin_split
    from cp360_tpu_torch.pipelines.extract import extract_frames, stage1_batch
    from cp360_tpu_torch.pipelines.temporal import infer_video

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_video_", dir=build))
    stats = {"card": gpu_line()}
    counted: dict = {}
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
        t0 = time.monotonic()
        written, got = counted_run(counted, lambda: sum(
            extract_frames(model, cfg, videos[v], str(art / v), output_img=True,
                           output_feature=True, batch_frames=cfg.extract_batch)
            for v in vids))
        wall = time.monotonic() - t0
        k2, k3 = got["equi_to_cube"], got["cube_pool3x3s2"]
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

        def extract_cli(out, *extra):
            """cli.extract_features on the golden's mp4s, a counted run:
            (seconds, K2, K3)."""
            cwd = Path.cwd()
            os.chdir(full.root)
            try:
                t0 = time.monotonic()
                _, got = counted_run(counted, lambda: extract_features.main(
                    ["--device", "cuda", "--out", out, "--mode", "resnet50",
                     "--weights", str(full.root / "resnet50.npz"), "--config", str(full.config),
                     *extra]))
                cli_s = time.monotonic() - t0
            finally:
                os.chdir(cwd)
            return cli_s, got["equi_to_cube"], got["cube_pool3x3s2"]

        def artifacts(out, vid, sub):
            d = full.root / "output" / f"{out}_resnet50" / vid / sub
            return {p[:-4]: np.load(d / p) for p in sorted(os.listdir(d))}

        for out, extra, want_k2 in (("static", [], True),
                                    ("remap", ["--set", "host_cube_remap=true",
                                               "--set", "transfer_codec=int8"], False),
                                    ("remap_rgb8", ["--set", "host_cube_remap=true"], False)):
            cli_s, k2, k3 = extract_cli(out, "-of", *extra)
            worst = 0.0
            for vid in full.vids:
                ours = artifacts(out, vid, "cube_feat")
                want = full.group("feat", vid)
                if sorted(ours) != sorted(want):
                    fail(f"{vid}: golden artifact numbering differs")
                for cnt, ref in want.items():
                    ref = ref.astype(np.float32)
                    worst = max(worst, float(np.abs(ours[cnt] - ref).max() / np.abs(ref).max()))
            stats.update({f"golden_extract_{out}_rel_err": worst,
                          f"golden_extract_{out}_s": cli_s})
            print(f"video: extract_features CLI {' '.join(extra) or '(all-device)'} on the "
                  f"e2e_full golden mp4s in {cli_s:.1f} s: max relative CAM error {worst} "
                  f"(limit 0.02); K2 {k2}, K3 {k3} launches", flush=True)
            if not worst < 0.02 or k3 == 0 or k2 != (k3 if want_k2 else 0):
                fail(f"golden extraction ({out}): relative error {worst}, K2 {k2}, K3 {k3}")

        # -- yuv420 from the host remap against the rgb8 run above, in f32
        cli_s, k2, k3 = extract_cli("remap_yuv", "-of", "--set", "host_cube_remap=true",
                                    "--set", "upload_format=yuv420")
        yuv_rel, yuv_corr, yuv_ok = 0.0, 1.0, k3 > 0 and k2 == 0
        for vid in full.vids:
            rgb, yuv = artifacts("remap_rgb8", vid, "cube_feat"), artifacts("remap_yuv", vid,
                                                                             "cube_feat")
            yuv_ok &= sorted(rgb) == sorted(yuv)
            for cnt in rgb:
                rel, corr, ok = yuv_close(rgb[cnt], yuv[cnt])
                yuv_rel, yuv_corr, yuv_ok = max(yuv_rel, rel), min(yuv_corr, corr), yuv_ok and ok
        stats.update(golden_extract_yuv420_rel_err=yuv_rel, golden_extract_yuv420_corr=yuv_corr)
        print(f"video: extract_features CLI yuv420 (host remap) vs rgb8 on the e2e_full mp4s in "
              f"{cli_s:.1f} s: relative max error {yuv_rel} (limit 0.08), correlation "
              f"{yuv_corr} (limit 0.998); K2 {k2}, K3 {k3} launches", flush=True)
        if not yuv_ok:
            fail("yuv420 extraction out of the JAX package's bound of rgb8")

        # -- -om at full width on the golden's mp4s, all-device stage 1:
        # Horn-Schunck over the f16 link (the default) and the f32 link, then
        # the variational backend and Farneback (host cv2, a thread pool)
        motion = {}
        for out, extra in (("om_hs", []), ("om_hs_f32", ["--set", "flow_link_dtype=float32"]),
                           ("om_variational", ["--set", "flow_backend=variational"]),
                           ("om_farneback", ["--set", "flow_backend=farneback"])):
            cli_s, k2, k3 = extract_cli(out, "-om", "--set", "opt_flow=true", *extra)
            motion[out] = {vid: artifacts(out, vid, "motion") for vid in full.vids}
            shapes = {(f.shape, f.dtype.name, bool(np.isfinite(f).all()), f.flags.c_contiguous)
                      for m in motion[out].values() for f in m.values()}
            names_ok = all(sorted(motion[out][v]) == sorted(full.group("feat", v))
                           for v in full.vids)
            stats[f"golden_extract_{out}_s"] = cli_s
            print(f"video: extract_features CLI -om {' '.join(extra) or '(horn_schunck, f16 link)'}"
                  f" on the e2e_full mp4s in {cli_s:.1f} s: motion "
                  f"{sorted(motion[out][full.vids[0]])[:1]}.. {shapes}; K2 {k2}, K3 {k3}",
                  flush=True)
            if not names_ok or shapes != {((480, 960, 2), "float32", True, True)} \
                    or k2 == 0 or k3 != k2:
                fail(f"-om extraction ({out}) wrote the wrong motion artifacts")
        link_err, link_tol = 0.0, 0.0
        for vid in full.vids:
            for cnt, a in motion["om_hs_f32"][vid].items():
                b = motion["om_hs"][vid][cnt]
                tol = 2e-3 * max(1e-3, float(np.abs(a).max())) + 1e-4
                link_err = max(link_err, float(np.abs(a - b).max()))
                link_tol = max(link_tol, tol)
                if not np.abs(a - b).max() <= tol:
                    fail(f"{vid}/{cnt}: the f16 link is {np.abs(a - b).max()} px off (limit {tol})")
        backends = {out: float(np.mean([np.abs(f).mean() for m in motion[out].values()
                                        for f in m.values()])) for out in motion}
        stats.update(om_f16_vs_f32_link_px=link_err, om_mean_abs_flow_px=backends)
        print(f"video: -om f16 link vs f32 link: max {link_err} px (limit per artifact "
              f"2e-3 max|flow| + 1e-4, up to {link_tol}); mean |flow| by backend {backends}",
              flush=True)

        # -- stage 2 + metrics, exact composition, on the scaled golden
        scaled = Golden("e2e", tmp / "scaled")
        result, cli_s, k1 = run_test_temporal(scaled.root, scaled.root / "clstm.npz",
                                              scaled.root / "ref_arts", scaled.config,
                                              scaled.seed, "--batch-windows", "8",
                                              totals=counted)
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
                "--set", f"compute_dtype={dtype}", totals=counted)
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
                                              SEED, "--batch-windows", "64", totals=counted)
        want_k1 = 15 * window_batches(art, vids, 5, 64)
        print(f"video: test_temporal bf16 on the extracted artifacts ({2 * 18} windows): "
              f"result {result} in {cli_s:.1f} s (model load and metrics included); "
              f"K1 {k1} (want {want_k1})", flush=True)
        if not all(np.isfinite(result)) or k1 != want_k1:
            fail(f"stage 2 on extracted artifacts: result {result}, K1 {k1}")
        # -- from a video to trained weights on the port's own motion, and
        # serving yuv420
        train_on_port_motion(model, tmp / "motion_train", counted)
        serve_yuv420(counted)
        print(f"video: launches over the phase's counted runs {json.dumps(counted)}",
              flush=True)

        # -- timings outside the counted runs
        t0 = time.monotonic()  # extraction writing artifacts only (-of)
        written = sum(extract_frames(model, cfg, videos[v], str(tmp / "feat_only" / v),
                                     output_img=False, batch_frames=cfg.extract_batch)
                      for v in vids)
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
        # the flow checks and timings come after the earlier slices'
        # numbers, so those are taken where they were before the flow slice
        stats["flow_card_vs_cpu"] = check_flow_solvers()
        t0 = time.monotonic()  # extraction -of -om (Horn-Schunck, f16 link)
        cfg_om = cfg.replace(opt_flow=True, flow_backend="horn_schunck")
        written = sum(extract_frames(model, cfg_om, videos[v], str(tmp / "feat_motion" / v),
                                     output_img=False, output_motion=True,
                                     batch_frames=cfg_om.extract_batch) for v in vids)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        stats.update(extract_of_om_fps=written / wall, extract_of_om_s=wall)
        stats.update(flow_speed())
        stats.update(default_output_motion(model, cfg_om, tmp))
        print(f"video: {json.dumps(stats)}", flush=True)
        return counted
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def default_output_motion(model, cfg, tmp: Path) -> dict:
    """``extract_video`` with ``output_motion`` left out, as a JAX user
    calls it (JAX's default is True, cp360_tpu/pipelines/extract.py:395),
    against the explicit ``output_motion=True`` call: a seeded 9-frame
    960x1920 video, resnet50 in bf16, ``opt_flow: true`` with the device
    Horn-Schunck backend; the same artifacts, the 8 motion arrays bit-equal.
    Outside the counted runs."""
    from cp360_tpu_torch.pipelines.extract import extract_video

    video = tmp / "om_default.mp4"
    write_video(video, 9, np.random.RandomState(SEED + 47))
    quiet = dict(batch_frames=cfg.extract_batch, log_fn=lambda _: None)
    out, secs = {}, {}
    for name, kw in (("default", {}), ("explicit", {"output_motion": True})):
        out[name] = tmp / f"om_{name}"
        t0 = time.monotonic()
        extract_video(model, cfg, str(video), str(out[name]), **kw, **quiet)
        torch.cuda.synchronize()
        secs[name] = time.monotonic() - t0
    print(f"video: extract_video output_motion left out {secs['default']} s, "
          f"output_motion=True {secs['explicit']} s", flush=True)
    names = {k: sorted(str(f.relative_to(d)) for f in d.rglob("*") if f.is_file())
             for k, d in out.items()}
    motion = sorted(os.listdir(out["default"] / "motion")) \
        if (out["default"] / "motion").is_dir() else []
    if motion != [f"{i:06}.npy" for i in range(2, 10)]:
        fail(f"extract_video with output_motion left out wrote motion {motion}")
    if names["default"] != names["explicit"]:
        fail("extract_video's default and explicit output_motion wrote different artifacts")
    for m in motion:
        if not np.array_equal(np.load(out["default"] / "motion" / m),
                              np.load(out["explicit"] / "motion" / m)):
            fail(f"motion/{m} differs between the default and explicit output_motion")
    print(f"video: default output_motion wrote {len(motion)} motion arrays, bit-equal to "
          f"output_motion=True", flush=True)
    return {"om_default_s": secs["default"], "om_explicit_s": secs["explicit"]}


# ---- phase 7: the streaming entry point ---------------------------------------

STREAM_TOL = 1e-4  # stream vs offline maps, f32 (tests/test_stream.py: atol and rtol)
STREAM_CONFIG = """\
equi_h: 1920
equi_w: 960
cube_dim: 224
input_size: 1000
hidden_size: 1000
seq_len: 5
compute_dtype: bfloat16
clstm_conv_impl: pallas
"""


def stream_batches(n_decoded: int, batch: int, seq_len: int = 5):
    """(stage-1 batches, window batches) of a stream over ``n_decoded``
    frames: the first frame seeds the 2-frame lag, a batch runs windows
    once the carry and its real frames hold seq_len."""
    n = n_decoded - 1
    stage1, windows, carry = 0, 0, 0
    for b0 in range(0, n, batch):
        real = min(batch, n - b0)
        stage1 += 1
        windows += carry + real >= seq_len
        carry = min(seq_len - 1, carry + real)
    return stage1, windows


def write_video(path: Path, n: int, rng) -> None:
    """A seeded n-frame 960x1920 mp4v video: a natural-spectrum texture
    panning 6 px a frame."""
    import cv2

    base = natural_frame(960, 1920, rng)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (1920, 960))
    if not vw.isOpened():
        fail(f"cv2 cannot write mp4v video {path}")
    for t in range(n):
        vw.write(np.roll(base, 6 * t, axis=1))
    vw.release()


def phase_stream() -> dict:
    """``pipelines/stream.py`` and ``cli/stream_saliency.py`` at full
    width (ResNet-50, 1000 classes, 960x1920 frames, 224 faces, ConvLSTM
    1000/1000, seq_len 5)."""
    import cv2

    from cp360_tpu_torch.cli import stream_saliency
    from cp360_tpu_torch.compat import jax_params
    from cp360_tpu_torch.config import load_config
    from cp360_tpu_torch.pipelines.stream import stream_video_saliency

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_stream_", dir=build))
    stats = {"card": gpu_line()}
    counted: dict = {}
    try:
        # -- the e2e_full golden's mp4s: offline (host remap, f16 feats,
        # batches of 8 as the stream's) against the stream, f32
        full = Golden("e2e_full", tmp / "full")
        cwd = Path.cwd()
        os.chdir(full.root)
        try:
            from cp360_tpu_torch.cli import extract_features

            extract_features.main(["--device", "cuda", "--out", "remap16", "--mode", "resnet50",
                                   "--weights", str(full.root / "resnet50.npz"),
                                   "--config", str(full.config), "-of",
                                   "--set", "host_cube_remap=true", "--set", "feat_dtype=float16",
                                   "--set", "extract_batch=8"])
        finally:
            os.chdir(cwd)
        offline_out = full.root / "offline"
        run_test_temporal(full.root, full.root / "clstm.npz",
                          full.root / "output" / "remap16_resnet50", full.config, full.seed,
                          "--batch-windows", "4", "--set", f"output_path={offline_out}",
                          totals={})  # the reference, not the stream's path
        cfg = load_config(str(full.config))
        backbone = jax_params.load_npz(str(full.root / "resnet50.npz"))
        clstm = jax_params.load_npz(str(full.root / "clstm.npz"))
        streams = {}
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            model = jax_params.resnet_from_params(backbone, "resnet50", True, tdt, "cuda")
            cell = jax_params.clstm_from_params(clstm, tdt, True, "pallas", "cuda")
            c = cfg.replace(compute_dtype=dtype)
            for vid in full.vids:
                mp4 = full.root / "dataset" / "test" / f"{vid}.mp4"
                n_dec = int(cv2.VideoCapture(str(mp4)).get(cv2.CAP_PROP_FRAME_COUNT))
                maps, got = counted_run(counted, lambda: dict(stream_video_saliency(
                    model, cell, str(mp4), c, stage1_batch=8)))
                s1, wb = stream_batches(n_dec, 8)
                streams[(dtype, vid)] = maps
                print(f"stream: {vid} ({n_dec} frames) {dtype}: maps {sorted(maps)}; launches "
                      f"{got} (want K3 {s1}, K1 {15 * wb}, no K2)", flush=True)
                if got["cube_pool3x3s2"] != s1 or got["cube_conv3x3"] != 15 * wb \
                        or got["equi_to_cube"] or got["cube_conv3x3_dx"]:
                    fail(f"stream launches {got} for {s1} stage-1 and {wb} window batches")
            del model, cell
            torch.cuda.empty_cache()
        worst, bf_diff = 0.0, 0.0
        for vid in full.vids:
            d = offline_out / "temporal" / vid
            offline = {int(f[:-4]): np.load(d / f) for f in os.listdir(d) if f.endswith(".npy")}
            maps = streams[("float32", vid)]
            if not offline or sorted(offline) != sorted(maps)[:-1]:
                fail(f"{vid}: offline ids {sorted(offline)}, stream ids {sorted(maps)}")
            for k, p in offline.items():
                worst = max(worst, float(np.abs(maps[k] - p).max()))
                if not np.all(np.abs(maps[k] - p) <= STREAM_TOL + STREAM_TOL * np.abs(p)):
                    fail(f"{vid}/{k}: stream map off the offline one by "
                         f"{np.abs(maps[k] - p).max()}")
            bf = streams[("bfloat16", vid)]
            if sorted(bf) != sorted(maps):
                fail(f"{vid}: bf16 stream ids {sorted(bf)}")
            bf_diff = max(bf_diff, max(float(np.abs(bf[k] - maps[k]).max()) for k in maps))
        stats.update(golden_stream_vs_offline_f32=worst, golden_stream_bf16_vs_f32=bf_diff)
        print(f"stream: e2e_full mp4s, f32 stream vs offline extract_features (host remap, f16 "
              f"feats) -> test_temporal: max|diff| {worst} (limit {STREAM_TOL} + {STREAM_TOL} "
              f"relative), one extra final window each; bf16 stream vs f32 stream "
              f"max|diff| {bf_diff}", flush=True)

        # -- the CLI on a seeded 64-frame 960x1920 video, cut and resumed
        video = tmp / "pan64.mp4"
        write_video(video, 64, np.random.RandomState(SEED + 15))
        cfg_path = tmp / "stream.yaml"
        cfg_path.write_text(STREAM_CONFIG)
        argv = ["--video", str(video), "--backbone", str(full.root / "resnet50.npz"),
                "--clstm", str(full.root / "clstm.npz"), "--config", str(cfg_path),
                "--device", "cuda"]
        t0 = time.monotonic()
        n_maps, got = counted_run(counted, lambda: stream_saliency.main(
            argv + ["--out", str(tmp / "sal_full")]))
        s1, wb = stream_batches(64, 8)
        print(f"stream: cli.stream_saliency on 64 frames: {n_maps} maps in "
              f"{time.monotonic() - t0:.1f} s (weights loaded); launches {got} (want K3 {s1}, "
              f"K1 {15 * wb}, no K2)", flush=True)
        if n_maps != 59 or got["cube_pool3x3s2"] != s1 or got["cube_conv3x3"] != 15 * wb \
                or got["equi_to_cube"]:
            fail(f"stream CLI: {n_maps} maps, launches {got}")
        full_maps = sorted(os.listdir(tmp / "sal_full"))
        (tmp / "sal_cut").mkdir()
        for name in full_maps[:23]:
            shutil.copy(tmp / "sal_full" / name, tmp / "sal_cut" / name)
        n_resumed, got = counted_run(counted, lambda: stream_saliency.main(
            argv + ["--out", str(tmp / "sal_cut"), "--resume"]))
        same = sorted(os.listdir(tmp / "sal_cut")) == full_maps and all(
            np.array_equal(np.load(tmp / "sal_cut" / f), np.load(tmp / "sal_full" / f))
            for f in full_maps)
        print(f"stream: --resume after a cut at {full_maps[23]}: {n_resumed} maps written, the "
              f"suffix bit for bit: {same}; launches {got}", flush=True)
        if not same or n_resumed != len(full_maps) - 23 or got["equi_to_cube"]:
            fail("the resumed stream differs from the uninterrupted one")

        # -- timings outside the counted runs: frames/s, median of 3, bf16
        cfg64 = load_config(str(cfg_path))
        model = jax_params.resnet_from_params(backbone, "resnet50", True, torch.bfloat16, "cuda")
        cell = jax_params.clstm_from_params(clstm, torch.bfloat16, True, "pallas", "cuda")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            n = len(list(stream_video_saliency(model, cell, str(video), cfg64)))
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
        stats.update(stream_s_64_frames=times, stream_frames_per_s=64 / float(np.median(times)),
                     stream_maps=n)
        prof = profile_step(lambda: list(stream_video_saliency(model, cell, str(video), cfg64,
                                                               max_frames=17)),
                            top=12, match="cube_")
        stats["stream_17_frames_idle_share"] = prof.get("idle_share")
        print(f"stream: 17 frames (two stage-1 batches, 4 + 8 windows) profile "
              f"{json.dumps(prof)}", flush=True)
        print(f"stream: {json.dumps(stats)}", flush=True)
        return counted
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


BACKBONE_ARCHS = ("resnet18", "resnet34", "resnet101", "resnet152", "vgg16", "mobilenet_v2",
                  "convnext_base", "swin_base")
BACKBONE_CPU_TOL = 2e-4  # card f32 vs the CPU's f32 CAMs, of max|ref|
BACKBONE_BF16_TOL = 0.02  # card bf16 vs card f32 CAMs, of max (the video phase's limit)
SWIN_BF16_TOL = 0.05  # card bf16 vs the CPU's f32 CAMs (tests/test_torch_swin.py's BF16_BOUND)
HALO_F32_TOL = 1e-3  # halo vs pad features, f32, atol and rtol (tests/test_cube_pad.py:204-221)


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    a, ref = a.float().cpu(), ref.float().cpu()
    return float((a - ref).abs().max() / ref.abs().max())


def close(a: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> bool:
    return bool(torch.allclose(a.float().cpu(), ref.float().cpu(), atol=atol, rtol=rtol))


def median_ms(fn, warmup: int = 2, iters: int = 5) -> float:
    """Median device time of one call of ``fn`` (CUDA events around each
    call, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_backbones() -> dict:
    """Every backbone family at full published width through
    ``stage1_batch``, the resnet50 cube-conv forms, the
    ``.pth`` round trip through the CLIs, and serving and the stream on
    other families (8 seeded natural-texture 960x1920 frames, 224 faces,
    1000 classes, all-device stage 1)."""
    from cp360_tpu_torch.cli import convert_weights, extract_features
    from cp360_tpu_torch.compat import jax_params
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.models import layers
    from cp360_tpu_torch.ops import equi_gather
    from cp360_tpu_torch.pipelines.extract import IMAGENET_MEAN, IMAGENET_STD, stage1_batch
    from cp360_tpu_torch.pipelines.stream import stream_video_saliency
    from cp360_tpu_torch.serving.server import SaliencyModel

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_backbones_", dir=build))
    stats = {"card": gpu_line()}
    counted: dict = {}
    bf16, f32 = torch.bfloat16, torch.float32
    try:
        rng = np.random.RandomState(SEED + 21)
        frames = np.stack([natural_frame(960, 1920, rng) for _ in range(8)])
        x8 = torch.from_numpy(frames).cuda()
        x1_cpu = torch.from_numpy(frames[:1])

        def run_stage1(model, x):
            with torch.no_grad():
                return stage1_batch(model, x)

        # -- each family: bf16 and f32 on the card, f32 on the CPU (1 frame)
        for arch in BACKBONE_ARCHS:
            t0 = time.monotonic()
            tree = jax_params.init_backbone_params(SEED, arch)
            want_k3 = 1 if arch.startswith("resnet") else 0
            want_dw = 36 if arch == "convnext_base" else 0
            swin = arch == "swin_base"
            out = {}
            for dtype in (bf16,) if swin else (bf16, f32):
                model = jax_params.backbone_from_params(tree, arch, True, dtype, "cuda")
                (scores, sal), got = counted_run(counted, lambda: run_stage1(model, x8))
                convs = (1 + 3 * sum(model.depths) if swin else
                         sum(isinstance(m, layers.Conv) for m in model.modules()))
                if got != {"cube_conv3x3": 0, "cube_conv3x3_dx": 0, "equi_to_cube": 1,
                           "cube_pool3x3s2": want_k3, "conv_epilogue": convs,
                           "cube_dwconv": want_dw, "cube_window_attn": 24 if swin else 0}:
                    fail(f"{arch} {dtype}: launches {got} for one stage-1 batch")
                if tuple(scores.shape) != (8, 6, 7, 7, 1000) or tuple(sal.shape) != (8, 14, 28) \
                        or not bool(torch.isfinite(scores).all()):
                    fail(f"{arch} {dtype}: CAM {tuple(scores.shape)}, saliency "
                         f"{tuple(sal.shape)}, finite {bool(torch.isfinite(scores).all())}")
                out[dtype] = scores.cpu()
                if dtype == bf16:
                    stats[f"{arch}_stage1_ms"] = median_ms(lambda: run_stage1(model, x8))
                    stats[f"{arch}_cube_conv_form"] = getattr(model, "cube_conv_form", None)
                    prof = profile_step(lambda: run_stage1(model, x8), top=6)
                    stats[f"{arch}_stage1_device_busy_ms"] = prof.get("device_busy_ms")
                    print(f"backbones: {arch} stage 1, 8 frames, bf16, profile "
                          f"{json.dumps(prof)}", flush=True)
                del model
            torch.cuda.empty_cache()
            cpu_model = jax_params.backbone_from_params(tree, arch, True, f32, "cpu")
            cpu_scores = run_stage1(cpu_model, x1_cpu)[0]
            del cpu_model, tree
            # swin_base: card bf16 against the CPU's f32, the card having no f32
            cpu_err = 0.0 if swin else rel_err(out[f32][:1], cpu_scores)
            bf16_err = rel_err(out[bf16][:1], cpu_scores) if swin else rel_err(out[bf16], out[f32])
            bf16_tol = SWIN_BF16_TOL if swin else BACKBONE_BF16_TOL
            stats.update({f"{arch}_card_vs_cpu_f32": None if swin else cpu_err,
                          f"{arch}_bf16_vs_f32": bf16_err})
            print(f"backbones: {arch}: CAM [8,6,7,7,1000]; K2 1, K3 {want_k3} launches a "
                  f"batch; card f32 vs CPU f32 {None if swin else cpu_err} (limit "
                  f"{BACKBONE_CPU_TOL}), bf16 vs f32 {bf16_err} (limit {bf16_tol}) of "
                  f"max|CAM|; stage 1 at 8 frames bf16 {stats[f'{arch}_stage1_ms']:.3f} ms; "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
            if not (cpu_err <= BACKBONE_CPU_TOL and bf16_err <= bf16_tol):
                fail(f"{arch}: card f32 vs CPU {cpu_err}, bf16 vs f32 {bf16_err}")

        # -- resnet50: halo vs pad
        tree50 = jax_params.init_resnet_params(SEED, "resnet50")
        default_form = jax_params.backbone_from_params(tree50, "resnet50", True, bf16,
                                                       "cuda").cube_conv_form
        mean = torch.tensor(IMAGENET_MEAN, device="cuda")
        std = torch.tensor(IMAGENET_STD, device="cuda")
        with torch.no_grad():
            cubes = (equi_gather.equi_to_cube(x8[:2], 224) - mean) / std
        feats, cams, m16 = {}, {}, {}
        for form in ("pad", "halo"):
            m32 = jax_params.resnet_from_params(tree50, "resnet50", True, f32, "cuda", form)
            with torch.no_grad():
                feats[form] = m32(cubes, with_logits=False)[1].cpu()
            del m32
            m16[form] = jax_params.resnet_from_params(tree50, "resnet50", True, bf16, "cuda",
                                                      form)
            cams[form], got = counted_run(counted,
                                          lambda: run_stage1(m16[form], x8)[0].cpu())
            if got["equi_to_cube"] != 1 or got["cube_pool3x3s2"] != 1:
                fail(f"resnet50 {form}: launches {got}")
            prof = profile_step(lambda: run_stage1(m16[form], x8), top=6)
            stats[f"resnet50_{form}_stage1_device_busy_ms"] = prof.get("device_busy_ms")
            print(f"backbones: resnet50 {form} stage 1, 8 frames, bf16, profile "
                  f"{json.dumps(prof)}", flush=True)
        # the two forms' stage-1 ms, paired: pad, halo, halo, pad
        paired = {"pad": [], "halo": []}
        for form in ("pad", "halo", "halo", "pad"):
            paired[form].append(median_ms(lambda: run_stage1(m16[form], x8)))
        for form, ms in paired.items():
            stats[f"resnet50_{form}_stage1_ms"] = float(np.mean(ms))
            stats[f"resnet50_{form}_stage1_ms_paired"] = ms
        del m16
        halo_f32_err = float((feats["halo"] - feats["pad"]).abs().max())
        halo_ok = close(feats["halo"], feats["pad"], HALO_F32_TOL, HALO_F32_TOL)
        halo_bf16 = rel_err(cams["halo"], cams["pad"])
        stats.update(resnet50_bf16_default_form=default_form, halo_vs_pad_f32=halo_f32_err,
                     halo_vs_pad_bf16=halo_bf16)
        print(f"backbones: resnet50 bf16 default cube-conv form: {default_form}; halo vs pad "
              f"f32 features max|diff| {halo_f32_err} (atol and rtol {HALO_F32_TOL}: {halo_ok}, "
              f"max|feat| {float(feats['pad'].abs().max())}), bf16 CAMs {halo_bf16} of max "
              f"(limit {BACKBONE_BF16_TOL}); stage 1 at 8 frames bf16: pad "
              f"{stats['resnet50_pad_stage1_ms']:.3f} ms, halo "
              f"{stats['resnet50_halo_stage1_ms']:.3f} ms", flush=True)
        if default_form != "halo" or not halo_ok or halo_bf16 > BACKBONE_BF16_TOL:
            fail("resnet50 cube-conv forms out of bounds")
        del feats, cams, cubes
        torch.cuda.empty_cache()

        # -- weights: a seeded resnet101 .npz -> .pth -> .npz through the CLI,
        # then the extraction CLI on an e2e_full mp4 with each file
        tree101 = jax_params.init_resnet_params(SEED + 2, "resnet101")
        npz, pth, back = tmp / "r101.npz", tmp / "r101.pth", tmp / "r101_back.npz"
        jax_params.save_npz(str(npz), tree101)
        rc = (convert_weights.main([str(npz), str(pth), "--arch", "resnet101"]),
              convert_weights.main([str(pth), str(back), "--kind", "resnet",
                                    "--arch", "resnet101"]))
        a = jax_params.flatten_params(tree101)
        b = jax_params.flatten_params(jax_params.load_npz(str(back)))
        same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
        print(f"backbones: convert_weights resnet101 .npz -> .pth -> .npz: rc {rc}, "
              f"{len(a)} leaves equal: {same}", flush=True)
        if rc != (0, 0) or not same:
            fail("the resnet101 weights did not survive the .pth round trip")
        del tree101, a, b
        full = Golden("e2e_full", tmp / "full")
        for vid in full.vids[1:]:  # one mp4
            os.remove(full.root / "dataset" / "test" / f"{vid}.mp4")
        vid = full.vids[0]
        cwd = Path.cwd()
        os.chdir(full.root)
        try:
            arts = {}
            for name, w in (("npz", npz), ("pth", pth)):
                _, got = counted_run(counted, lambda: extract_features.main(
                    ["--device", "cuda", "--out", name, "--mode", "resnet101", "-of",
                     "--weights", str(w), "--config", str(full.config), "--max-frames", "8"]))
                d = full.root / "output" / f"{name}_resnet101" / vid / "cube_feat"
                arts[name] = {f: np.load(d / f) for f in sorted(os.listdir(d))}
                if got["equi_to_cube"] != 2 or got["cube_pool3x3s2"] != 2:
                    fail(f"extract_features resnet101 ({name}): launches {got}")
        finally:
            os.chdir(cwd)
        same = (sorted(arts["npz"]) == sorted(arts["pth"]) == [f"{i:06}.npy" for i in range(2, 9)]
                and all(np.array_equal(arts["npz"][f], arts["pth"][f]) for f in arts["npz"]))
        print(f"backbones: extract_features --mode resnet101 --max-frames 8 on {vid}.mp4: "
              f"{len(arts['pth'])} CAM artifacts {arts['pth']['000002.npy'].shape} from the .pth "
              f"equal to the .npz run bit for bit: {same}; K2 and K3 2 launches each", flush=True)
        if not same:
            fail("the .pth extraction differs from the .npz extraction")

        # -- serving mobilenet_v2: 4 predict requests from 4 threads
        cfg = Config(cube_dim=224, equi_h=1920, equi_w=960, compute_dtype="bfloat16",
                     host_cube_remap=False, serve_max_batch=4, serve_batch_window_ms=5.0)
        server = SaliencyModel(jax_params.init_mobilenet_v2_params(SEED + 3), cfg,
                               arch="mobilenet_v2", device="cuda")
        try:
            server.warmup()
            b0 = server._batcher.stats["batches"]
            with ThreadPoolExecutor(max_workers=4) as pool:
                preds, got = counted_run(counted, lambda: list(pool.map(server.predict, frames[:4])))
            batches = server._batcher.stats["batches"] - b0
        finally:
            server.close()
        ok = all(p.shape == (14, 28) and np.isfinite(p).all() for p in preds)
        print(f"backbones: SaliencyModel(arch='mobilenet_v2') answered {len(preds)} predicts in "
              f"{batches} stage-1 batches, maps (14, 28) finite: {ok}; launches {got}", flush=True)
        if not ok or len(preds) != 4 or got["equi_to_cube"] != batches \
                or got["cube_pool3x3s2"] or got["cube_conv3x3"]:
            fail(f"mobilenet_v2 serving: launches {got} for {batches} batches")
        del server

        # -- the stream with a vgg16 backbone over a 16-frame 960x1920 video
        video = tmp / "pan16.mp4"
        write_video(video, 16, np.random.RandomState(SEED + 22))
        scfg = Config(cube_dim=224, equi_h=1920, equi_w=960, input_size=1000, hidden_size=1000,
                      seq_len=5, compute_dtype="bfloat16", clstm_conv_impl="pallas")
        vgg = jax_params.backbone_from_params(jax_params.init_vgg16_params(SEED + 4), "vgg16",
                                              True, bf16, "cuda")
        cell = jax_params.clstm_from_params(jax_params.init_clstm_params(SEED + 5, 1000, 1000),
                                            bf16, True, "pallas", "cuda")
        maps, got = counted_run(counted, lambda: dict(stream_video_saliency(vgg, cell, str(video),
                                                                           scfg)))
        s1, wb = stream_batches(16, 8)
        ok = sorted(maps) == list(range(4, 15)) and all(
            m.shape == (14, 28) and np.isfinite(m).all() for m in maps.values())
        print(f"backbones: stream_video_saliency with vgg16 on 16 frames: maps {sorted(maps)}, "
              f"finite (14, 28): {ok}; launches {got} (want K1 {15 * wb}, no K2, no K3)",
              flush=True)
        if not ok or got["cube_conv3x3"] != 15 * wb or got["equi_to_cube"] \
                or got["cube_pool3x3s2"]:
            fail(f"vgg16 stream: maps {sorted(maps)}, launches {got}")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            list(stream_video_saliency(vgg, cell, str(video), scfg))
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
        stats.update(vgg16_stream_s_16_frames=times,
                     vgg16_stream_frames_per_s=16 / float(np.median(times)))
        print(f"backbones: vgg16 stream {stats['vgg16_stream_frames_per_s']:.2f} frames/s "
              f"(16 frames, host clock, median of 3)", flush=True)
        print(f"backbones: {json.dumps(stats)}", flush=True)
        return counted
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- phase 9: scale-out ---------------------------------------------------------

PIPE_STAGES = 5  # the published seq_len 5, one step a stage
WINDOW_BF16_TOL = 0.02  # of max|ref|: the bf16 limit the earlier phases hold a CAM to
GRID_COS_MIN = 0.999  # tp gradients by cosine (tests/test_parallel.py:79-93)


def close_or_equal(a: torch.Tensor, ref: torch.Tensor, tol: float = WINDOW_BF16_TOL):
    """(bit-equal, relative max error, passed): equal bits, or within
    ``tol`` of max|ref|."""
    a, ref = a.float(), ref.float()
    err = float((a - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
    equal = bool(torch.equal(a, ref))
    return equal, err, equal or err <= tol


def free_ports(n: int) -> list:
    """n distinct free local ports (bound at once, so they differ): the
    rendezvous of launches that start together."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def launch_start(nprocs: int, cmd, cwd: Path, port: int = 0, **env):
    """Start ``cli.launch --nprocs N -- cmd`` from ``cwd`` (its rendezvous
    on ``port``, or the launcher's own free port); returns the process and
    its start time (see :func:`launch_wait`)."""
    own = ["--coordinator", f"127.0.0.1:{port}"] if port else []
    p = subprocess.Popen([sys.executable, "-m", "cp360_tpu_torch.cli.launch", "--nprocs",
                          str(nprocs), *own, "--", *cmd], cwd=cwd,
                         env=dict(os.environ, PYTHONPATH=str(ROOT), **env),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return p, time.monotonic()


def stop(p: subprocess.Popen) -> None:
    """End a child that is still running: SIGINT first (the launcher then
    takes its workers down), SIGKILL after 45 s."""
    if p.poll() is None:
        p.send_signal(signal.SIGINT)
        try:
            p.wait(timeout=45)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch_wait(tag: str, started, timeout: float):
    """Wait for a :func:`launch_start` job (killed at ``timeout``), write its
    output to ``build/smoke_logs/parallel_<tag>.log``, return it with the wall
    time; fails the smoke on a non-zero exit."""
    p, t0 = started
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        stop(p)
        fail(f"{tag}: the launched job ran over {timeout} s")
    wall = time.monotonic() - t0
    log_dir = ROOT / "build" / "smoke_logs"
    log_dir.mkdir(parents=True, exist_ok=True)
    (log_dir / f"parallel_{tag}.log").write_text(out)
    if p.returncode != 0:
        print(out[-6000:])
        fail(f"{tag}: the launched job exited {p.returncode}")
    return out, wall


def launch(tag: str, nprocs: int, cmd, cwd: Path, timeout: float, **env):
    """``cli.launch --nprocs N -- cmd`` to its end (:func:`launch_wait`)."""
    return launch_wait(tag, launch_start(nprocs, cmd, cwd, **env), timeout)


def worker_grid_step() -> None:
    """Under ``cli.launch --nprocs 2`` with ``CP360_DIST_BACKEND=gloo``: one
    full-width train step on the 2x1 and the 1x2 grid (two ranks on the one
    card), in f32 and in bf16, against the one-device step on the same
    params and batch, which rank 0 computes after; prints ``GRID_LOSS``
    lines and, on rank 0, ``GRID_STEP {json}``."""
    from cp360_tpu_torch.compat.jax_params import init_clstm_params
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.parallel import mesh
    from cp360_tpu_torch.train import loop

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh.maybe_init_distributed(device="cuda")
    device = mesh.rank_device("cuda")
    params = init_clstm_params(SEED + 30, 1000, 1000)
    rng = np.random.RandomState(SEED + 31)
    seq = rng.gamma(0.5, 2.0, (2, 5, 6, 7, 7, 1000)).astype(np.float32)
    flows = (rng.standard_normal((2, 5, 480, 960, 2)) * 2.0).astype(np.float32)
    grids = {(nd, nm): mesh.ProcessGrid(nd, nm) for nd, nm in ((2, 1), (1, 2))}

    def run(cfg, grid):
        model = loop.trainable_clstm(cfg, params, device, grid)
        step = loop.make_train_step(cfg, model, loop.make_optimizer(cfg, model), grid)
        s, f = (seq, flows) if grid is None else mesh.shard_batch(grid, (seq, flows))
        m = step(torch.from_numpy(s).to(device), torch.from_numpy(f).to(device))
        grads = {}
        for name, p in model.named_parameters():
            g = p.grad
            if grid is not None and grid.n_model > 1:
                g = mesh.all_gather_cat(g, grid.model_group, dim=-1)
            grads[name] = g.float().cpu()
        del model, step
        torch.cuda.empty_cache()
        return float(m["loss"]), grads

    out = {}
    for dtype in ("float32", "bfloat16"):
        res = {}
        for (nd, nm), grid in grids.items():
            cfg = Config(mesh_data=nd, mesh_model=nm, clstm_conv_impl="pallas",
                         compute_dtype=dtype)
            res[f"{nd}x{nm}"] = run(cfg, grid)
            print(f"GRID_LOSS {dtype}/{nd}x{nm} rank {mesh.process_index()} "
                  f"{res[f'{nd}x{nm}'][0]!r}", flush=True)
        mesh.host_barrier()
        if mesh.process_index() != 0:
            continue
        ref_loss, ref = run(Config(clstm_conv_impl="pallas", compute_dtype=dtype), None)
        for key, (loss, grads) in res.items():
            k = f"{dtype}/{key}"
            out[f"{k}_loss_rel"] = abs(loss - ref_loss) / abs(ref_loss)
            out[f"{k}_grad_abs"] = max(float((grads[n] - ref[n]).abs().max()) for n in ref)
            out[f"{k}_grad_rel"] = max(float((grads[n] - ref[n]).abs().max()
                                             / ref[n].abs().max()) for n in ref)
            out[f"{k}_grad_cos"] = min(float(torch.nn.functional.cosine_similarity(
                grads[n].ravel(), ref[n].ravel(), dim=0)) for n in ref)
        del res, ref
    if mesh.process_index() == 0:
        print("GRID_STEP " + json.dumps(out), flush=True)


def worker_nccl() -> None:
    """Under ``cli.launch --nprocs 1`` on the default backend (nccl for CUDA
    tensors): the grid, one all-reduce and one autograd all-gather on the
    card; prints ``NCCL_OK``."""
    from cp360_tpu_torch.parallel import mesh

    mesh.maybe_init_distributed(device="cuda")
    grid = mesh.ProcessGrid(1, 1)
    t = torch.arange(4.0, device="cuda")
    mesh.all_reduce_(t, grid.data_group)
    x = torch.arange(6.0, device="cuda").reshape(2, 3).requires_grad_()
    y = mesh.gather_channels(x, grid.model_group)
    (y * 2).sum().backward()
    torch.cuda.synchronize()
    ok = torch.equal(t.cpu(), torch.arange(4.0)) and torch.equal(y.detach(), x.detach()) \
        and torch.equal(x.grad, torch.full_like(x, 2.0))
    print(f"NCCL_OK backend={mesh._state['backend']} ok={ok} {grid!r}", flush=True)
    if not ok:
        sys.exit(1)


def phase_parallel() -> dict:
    """Scale-out at full width (ResNet-50, 1000 classes, 960x1920 frames,
    224 faces, ConvLSTM 1000/1000, seq_len 5, bf16) on the one card."""
    from cp360_tpu_torch.cli import extract_features
    from cp360_tpu_torch.compat import jax_params
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.ops import cube_conv
    from cp360_tpu_torch.parallel.mesh import LocalReplicas
    from cp360_tpu_torch.pipelines.extract import stage1_batch
    from cp360_tpu_torch.pipelines.temporal import window_infer, window_infer_pipelined
    from cp360_tpu_torch.serving.server import SaliencyModel
    from cp360_tpu_torch.train import loop

    t_phase = time.monotonic()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_", dir=build))
    stats = {"card": gpu_line()}
    counted: dict = {}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 32)
    side: list = []  # jobs started to run beside others, stopped on the way out
    try:
        # -- 1. the pipe over [cuda:0] * 5: 8 windows in 4 microbatches of 12 faces
        clstm_params = jax_params.init_clstm_params(SEED + 1, 1000, 1000)
        cell = jax_params.clstm_from_params(clstm_params, torch.bfloat16, True, "pallas", dev)
        windows = torch.rand(8, 5, 6, 7, 7, 1000, generator=gen, device="cuda").half()
        devices = [dev] * PIPE_STAGES
        with torch.no_grad():
            serial, got = counted_run(counted, lambda: window_infer(cell, windows))
            piped, got_p = counted_run(counted, lambda: window_infer_pipelined(
                cell, windows, devices, 4))
            equal, err, ok = close_or_equal(piped, serial)
            stats.update(pipe_bit_equal=equal, pipe_rel_err=err,
                         pipe_ms=median_ms(lambda: window_infer_pipelined(cell, windows,
                                                                          devices, 4)),
                         serial_ms=median_ms(lambda: window_infer(cell, windows)))
        print(f"parallel: window_infer_pipelined over [cuda:0]*{PIPE_STAGES}, n_micro 4: "
              f"bit-equal {equal}, rel err {err}; K1 {got_p['cube_conv3x3']} launches "
              f"(serial {got['cube_conv3x3']}); {stats['pipe_ms']:.2f} ms vs serial "
              f"{stats['serial_ms']:.2f} ms", flush=True)
        if not ok or got_p["cube_conv3x3"] != 4 * got["cube_conv3x3"]:
            fail(f"pipelined window inference: rel err {err}, launches {got_p} vs {got}")

        # a pipelined train step, seq_len 8 over [cuda:0] * 2, against the serial step
        cfg = Config(seq_len=8, clstm_conv_impl="pallas", pipeline_microbatches=2)
        seq = torch.rand(2, 8, 6, 7, 7, 1000, generator=gen, device="cuda")
        flows = torch.randn(2, 8, 480, 960, 2, generator=gen, device="cuda") * 2.0
        outs = {}
        for name, c, pipe in (("serial", cfg, None),
                              ("piped", cfg.replace(pipeline_stages=2), [dev, dev])):
            model = loop.trainable_clstm(c, clstm_params, dev)
            step = loop.make_train_step(c, model, loop.make_optimizer(c, model),
                                        pipe_devices=pipe)
            m, _ = counted_run(counted, lambda: step(seq, flows))
            outs[name] = (float(m["loss"]), {n: p.grad.float().clone()
                                             for n, p in model.named_parameters()})
            del model, step
        (l_s, g_s), (l_p, g_p) = outs["serial"], outs["piped"]
        loss_rel = abs(l_p - l_s) / abs(l_s)
        grad_rel = max(float((g_p[n] - g_s[n]).abs().max() / g_s[n].abs().max()) for n in g_s)
        stats.update(pipe_train_loss_rel=loss_rel, pipe_train_grad_rel=grad_rel)
        print(f"parallel: pipelined train step (seq_len 8, [cuda:0]*2, 2 microbatches) vs "
              f"serial: loss rel {loss_rel}, gradient rel err {grad_rel} (limits 1e-3, "
              f"{WINDOW_BF16_TOL})", flush=True)
        if not (loss_rel <= 1e-3 and grad_rel <= WINDOW_BF16_TOL):
            fail(f"pipelined train step: loss rel {loss_rel}, gradient rel {grad_rel}")
        del outs, g_s, g_p, seq, flows
        torch.cuda.empty_cache()

        # -- 2. local replicas [cuda:0, cuda:0]
        tree = jax_params.init_resnet_params(SEED, "resnet50", 1000)
        backbone = jax_params.backbone_from_params(tree, "resnet50", True, torch.bfloat16, dev)
        rng = np.random.RandomState(SEED + 33)
        frames = torch.from_numpy(np.stack([natural_frame(960, 1920, rng)
                                            for _ in range(8)])).cuda()
        reps = LocalReplicas(backbone, [dev, dev])
        creps = LocalReplicas(cell, [dev, dev])
        with torch.no_grad():
            (one_scores, _), _ = counted_run(counted, lambda: stage1_batch(backbone, frames))
            (rep_scores, _), got = counted_run(counted, lambda: reps.run(
                stage1_batch, split=(frames,)))
            s_equal, s_err, s_ok = close_or_equal(rep_scores, one_scores)
            rep_win, got_w = counted_run(counted, lambda: creps.run(window_infer,
                                                                    split=(windows,)))
            w_equal, w_err, w_ok = close_or_equal(rep_win, serial)
        stats.update(replica_stage1_bit_equal=s_equal, replica_stage1_rel_err=s_err,
                     replica_window_bit_equal=w_equal, replica_window_rel_err=w_err)
        print(f"parallel: LocalReplicas([cuda:0, cuda:0]) stage1_batch on 8 frames: bit-equal "
              f"{s_equal}, rel err {s_err} (K2 {got['equi_to_cube']}, K3 "
              f"{got['cube_pool3x3s2']}); 8-window batch: bit-equal {w_equal}, rel err "
              f"{w_err} (K1 {got_w['cube_conv3x3']})", flush=True)
        if not (s_ok and w_ok and got["equi_to_cube"] == 2 and got_w["cube_conv3x3"] == 30):
            fail(f"replicas: stage 1 {s_err}, windows {w_err}, launches {got}, {got_w}")
        del reps, creps, rep_scores, one_scores, rep_win

        # SaliencyModel with mesh_data 2 on [cuda:0, cuda:0] against one card
        scfg = Config(cube_dim=224, equi_h=1920, equi_w=960, input_size=1000,
                      hidden_size=1000, seq_len=5, compute_dtype="bfloat16",
                      host_cube_remap=False, clstm_conv_impl="pallas", serve_max_batch=8,
                      serve_batch_window_ms=5.0)
        host_frames = [f.cpu().numpy() for f in frames[:6]]
        answers = {}
        for name, c, devs in (("one", scfg, None), ("two", scfg.replace(mesh_data=2),
                                                    [dev, dev])):
            model = SaliencyModel(tree, c, clstm_params=clstm_params, device="cuda",
                                  devices=devs)

            def serve(model=model):
                with ThreadPoolExecutor(max_workers=4) as pool:
                    preds = list(pool.map(model.predict, host_frames[:4]))
                sid = model.temporal_start()
                temporal = [model.temporal_push(sid, f)[1] for f in host_frames]
                model.temporal_close(sid)
                return preds, temporal

            answers[name], _ = counted_run(counted, serve)
            stats[f"serve_{name}_data_parallel"] = model.data_parallel
            model.close()
            del model
        worst = 0.0
        for a, b in zip(answers["two"][0] + answers["two"][1][4:],
                        answers["one"][0] + answers["one"][1][4:]):
            _, e, _ = close_or_equal(torch.from_numpy(a), torch.from_numpy(b))
            worst = max(worst, e)
        stats["serve_mesh_data_rel_err"] = worst
        print(f"parallel: SaliencyModel mesh_data 2 on [cuda:0, cuda:0]: 4 predicts + a "
              f"6-frame session, rel err vs one card {worst}", flush=True)
        if worst > WINDOW_BF16_TOL or stats["serve_two_data_parallel"] != 2:
            fail(f"data-parallel serving differs from one card: {worst}")
        del backbone, cell, windows, serial, piped, frames
        torch.cuda.empty_cache()

        # K1 and dx on the tensor-parallel 2000-channel shard beside 4000
        shard = {}
        for cout in (4000, 2000):
            x = torch.randn(8, 6, 7, 7, 4000, generator=gen, device="cuda").bfloat16()
            w = (torch.randn(3, 3, 4000, cout, generator=gen, device="cuda") * 0.01).bfloat16()
            b = torch.zeros(cout, device="cuda", dtype=torch.bfloat16)
            dy = torch.randn(8, 6, 7, 7, cout, generator=gen, device="cuda").bfloat16()
            shard[f"k1_ms_cout{cout}"] = cuda_ms(lambda: cube_conv.cube_conv3x3(x, w, b))
            shard[f"dx_ms_cout{cout}"] = cuda_ms(lambda: cube_conv.cube_conv3x3_dx(dy, w))
        stats["tp_shard_ms"] = shard
        print(f"parallel: K1 / dx at [8,6,7,7,4000] -> 4000 vs the 2000-channel shard: "
              f"{json.dumps(shard)}", flush=True)

        # -- 5. and 6. start beside the launched jobs below (nothing timed runs
        # from here on): NCCL at world size 1 through the launcher, and the doctor
        nccl_job = launch_start(1, [sys.executable, str(ROOT / "chip_smoke.py"), "--worker",
                                    "nccl"], ROOT)
        side.append(nccl_job[0])
        doctor = subprocess.Popen([sys.executable, "-m", "cp360_tpu_torch.cli.doctor",
                                   "--require-device"], cwd=ROOT,
                                  env=dict(os.environ, PYTHONPATH=str(ROOT)),
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        side.append(doctor)

        # -- 3. striped extraction and evaluation over two ranks (no collective
        # on the card: the merge's barrier is a host all-reduce)
        full = Golden("e2e_full", tmp / "full")
        common = ["--device", "cuda", "--mode", "resnet50", "--weights",
                  str(full.root / "resnet50.npz"), "--config", str(full.config), "-of"]
        cwd = Path.cwd()
        os.chdir(full.root)
        try:
            counted_run(counted, lambda: extract_features.main(["--out", "single"] + common))
        finally:
            os.chdir(cwd)
        out, wall = launch("extract", 2, [sys.executable, "-m",
                                          "cp360_tpu_torch.cli.extract_features",
                               "--out", "striped"] + common, full.root, 600)
        # every rank takes its stripe of test_25; the golden's two videos
        # lie at positions 0 and 1 of it, so each rank extracts one
        if [out.count(f"[p{r}] Now process") for r in (0, 1)] != [1, 1]:
            fail(f"striped extraction did not give each rank one video:\n{out[-3000:]}")
        n_files = 0
        for vid in full.vids:
            d1 = full.root / "output" / "single_resnet50" / vid / "cube_feat"
            d2 = full.root / "output" / "striped_resnet50" / vid / "cube_feat"
            names = sorted(os.listdir(d1))
            if names != sorted(os.listdir(d2)):
                fail(f"{vid}: striped extraction wrote other frames")
            for f in names:
                if not np.array_equal(np.load(d1 / f), np.load(d2 / f)):
                    fail(f"{vid}/{f}: striped CAMs differ from the one-process CAMs")
                n_files += 1
        stats["striped_extract_s"] = wall
        print(f"parallel: launch --nprocs 2 extract_features on the e2e_full mp4s in "
              f"{wall:.1f} s: {n_files} CAM files bit-equal to the one-process run", flush=True)
        single, _, _ = run_test_temporal(full.root, full.root / "clstm.npz",
                                         full.root / "output" / "single_resnet50",
                                         full.config, full.seed, totals=counted)
        tdir = tmp / "temporal2"
        tdir.mkdir()
        out, wall = launch("test_temporal", 2, [sys.executable, "-m",
                                                "cp360_tpu_torch.cli.test_temporal",
                               "--device", "cuda", "--model", str(full.root / "clstm.npz"),
                               "--dir", str(full.root / "output" / "striped_resnet50"),
                               "--config", str(full.config)], tdir, 600)
        merged = parse_result((tdir / "striped_resnet50_result.txt").read_text())
        diffs = [abs(a - b) for a, b in zip(merged, single)]
        stats.update(striped_eval_s=wall, striped_eval_diffs=diffs)
        print(f"parallel: launch --nprocs 2 test_temporal: merged (CC, AUC, AUCB) {merged} vs "
              f"one process {single} (limits 1e-5, 1e-3, 0.05) in {wall:.1f} s", flush=True)
        if out.count("takes 1 video(s)") != 2 or out.count("==========") != 1 \
                or not (diffs[0] < 1e-5 and diffs[1] < 1e-3 and diffs[2] < 0.05):
            fail(f"striped evaluation: {merged} vs {single}")

        # -- 4. two ranks training on the one card (gloo), at full width
        n_windows = write_artifacts(tmp / "art", n_frames=7)
        steps = n_windows // 2  # a step a batch of 2 windows
        train_cmd = [sys.executable, "-m", "cp360_tpu_torch.cli.train_temporal", "--input",
                     str(tmp / "art"), "--device", "cuda", "--set", "summary_freq=1",
                     "--set", "batch_size=2", "--set", "save_freq=1000",
                     "--set", "clstm_conv_impl=pallas"]
        # the dp and the tp job share no files: they run at once (four ranks
        # on the card), as do the tp resume and the grid step below
        jobs = {}
        for (name, extra), port in zip((
                ("dp", ["--data-parallel", "2", "--set", "checkpoint_backend=npz"]),
                ("tp", ["--set", "mesh_model=2", "--set", "checkpoint_backend=orbax"])),
                free_ports(2)):
            jobs[name] = launch_start(2, train_cmd + extra + [
                "--set", "epochs=1", "--set", f"checkpoint_path={tmp / f'ck_{name}'}"], ROOT,
                port, CP360_DIST_BACKEND="gloo")
            side.append(jobs[name][0])
        for name, job in jobs.items():
            out, wall = launch_wait(f"train_{name}", job, 600)
            losses = {r: [ln.split("loss_avg=")[1].split()[0] for ln in out.splitlines()
                          if ln.startswith(f"[p{r}]") and "loss_avg=" in ln] for r in (0, 1)}
            stats[f"train_{name}_s"] = wall
            stats[f"train_{name}_losses"] = losses[0]
            print(f"parallel: launch --nprocs 2 train_temporal {name} (gloo, one card): "
                  f"{n_windows} windows, losses rank 0 {losses[0]}, rank 1 {losses[1]} in "
                  f"{wall:.1f} s", flush=True)
            if losses[0] != losses[1] or len(losses[0]) != steps \
                    or "backend gloo" not in out:
                fail(f"two-rank training ({name}): losses {losses}")
        ck = tmp / "ck_tp"
        if not list(ck.glob("*/orbax/*/.metadata")):
            fail("the tp run wrote no DCP checkpoint")
        resume_port, grid_port = free_ports(2)
        resume_job = launch_start(2, train_cmd + [
            "--set", "epochs=2", "--set", "mesh_model=2", "--set", "checkpoint_backend=orbax",
            "--set", f"checkpoint_path={ck}", "--resume"], ROOT, resume_port,
            CP360_DIST_BACKEND="gloo")
        grid_job = launch_start(2, [sys.executable, str(ROOT / "chip_smoke.py"), "--worker",
                                    "grid-step"], ROOT, grid_port, CP360_DIST_BACKEND="gloo")
        side += [resume_job[0], grid_job[0]]
        out, wall = launch_wait("train_tp_resume", resume_job, 600)
        resumed = [ln for ln in out.splitlines() if ln.startswith("[p0]") and "loss_avg=" in ln]
        print(f"parallel: tp resumed from its DCP checkpoint in {wall:.1f} s: "
              f"{len(resumed)} more steps", flush=True)
        if "resumed full train state" not in out or len(resumed) != steps:
            fail(f"the tp run did not resume its DCP state:\n{out[-3000:]}")
        out, wall = launch_wait("grid_step", grid_job, 600)
        line = next(ln for ln in out.splitlines() if "GRID_STEP " in ln)
        grid = json.loads(line.split("GRID_STEP ", 1)[1])
        stats["grid_step"] = grid
        rank_losses = {}
        for ln in out.splitlines():
            if "GRID_LOSS " in ln:
                key, _, _, val = ln.split("GRID_LOSS ", 1)[1].split()
                rank_losses.setdefault(key, set()).add(val)
        print(f"parallel: one full-width step on the 2x1 and 1x2 grids vs one device "
              f"({wall:.1f} s): {json.dumps(grid)}; losses per grid {rank_losses}", flush=True)
        # f32 at the CPU test's tolerances (tests/test_torch_launch.py: losses rel
        # 1e-5, the dp update lr * g within 1e-6 at lr 1e-3, tp by cosine); bf16
        # losses within the smoke's bf16 limit (a slice's K1 may split its depth
        # otherwise, so tp's bf16 rounding differs), its gradients printed
        f32_ok = (grid["float32/2x1_loss_rel"] <= 1e-5 and grid["float32/1x2_loss_rel"] <= 1e-5
                  and 1e-3 * grid["float32/2x1_grad_abs"] <= 1e-6
                  and grid["float32/1x2_grad_cos"] > GRID_COS_MIN)
        bf16_ok = max(grid["bfloat16/2x1_loss_rel"], grid["bfloat16/1x2_loss_rel"]) \
            <= WINDOW_BF16_TOL and grid["bfloat16/2x1_grad_rel"] <= WINDOW_BF16_TOL
        if any(len(v) != 1 for v in rank_losses.values()) or len(rank_losses) != 4 \
                or not (f32_ok and bf16_ok):
            fail(f"grid steps differ from the one-device step: {grid}, {rank_losses}")
        # -- 5. NCCL at world size 1 through the launcher (started above)
        out, _ = launch_wait("nccl", nccl_job, 300)
        nccl = next((ln for ln in out.splitlines() if "NCCL_OK" in ln), "")
        print(f"parallel: {nccl.strip()} (ran beside the jobs above)", flush=True)
        if "ok=True" not in nccl or "nccl" not in nccl:
            fail(f"NCCL at world size 1: {out[-2000:]}")

        # -- 6. the doctor (started above)
        try:
            d_out, d_err = doctor.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            doctor.kill()
            fail("doctor --require-device ran over 600 s")
        summary = (d_out.strip().splitlines() or [""])[-1]
        print(f"parallel: doctor --require-device (ran beside the jobs above) rc "
              f"{doctor.returncode}: {summary}", flush=True)
        if doctor.returncode != 0:
            fail(f"doctor --require-device failed:\n{d_out[-3000:]}\n{d_err[-2000:]}")
    finally:
        for p in side:
            stop(p)
        shutil.rmtree(tmp, ignore_errors=True)
    stats["phase_s"] = time.monotonic() - t_phase
    print(f"parallel: {json.dumps(stats)}", flush=True)
    return counted


# ---- phase 10: the batch .npy loader, the platform and the cube-conv form ------

LOADER_THREADS = (1, 4, 0)  # n_threads of the read timings (0: one per hardware thread)


def host_ms(fn, warmup: int = 1, iters: int = 3) -> float:
    """Median host-clock ms of one call of ``fn``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t))
    return float(np.median(times))


def numpy_reader():
    """A context in which the port's readers go through the loader's plain
    version (``np.load`` of each file, stacked) instead of the loader."""
    from unittest import mock

    from cp360_tpu_torch import native

    return mock.patch.object(native, "load_npy_batch", native.load_npy_batch_plain)


def batch_bits_equal(a, b) -> bool:
    """Bit equality of two host batches: arrays, or tuples of them (the
    int8 codec's ``Quantized`` CAMs)."""
    def flat(batch):
        out = []
        for x in batch:
            out.extend(x if isinstance(x, tuple) else [x])
        return out

    fa, fb = flat(a), flat(b)
    return len(fa) == len(fb) and all(
        x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
        for x, y in zip(fa, fb))


def loader_reads(art: Path, vids) -> dict:
    """Batches of 8 full-width windows (CAMs [6,1000,7,7] f16, flows
    [480,960,2] f32, 40 files of each) through the loader and through the
    numpy reader at each of ``LOADER_THREADS``: bit-equal, and each
    reader's host ms per batch (median of 3 after 1; the files were just
    written, so the page cache holds them)."""
    from cp360_tpu_torch.data.dataset import WindowDataset

    ds = WindowDataset(str(art), None, vids, 5)
    idxs = list(range(8))
    res = {}
    for n in LOADER_THREADS:
        got = ds.get_batch(idxs, n)
        with numpy_reader():
            want = ds.get_batch(idxs, n)
            numpy_ms = host_ms(lambda: ds.get_batch(idxs, n))
        if not batch_bits_equal(got, want):
            fail(f"loader batch at n_threads={n} differs from the numpy reader's")
        res[f"n_threads_{n}"] = {"loader_ms": host_ms(lambda: ds.get_batch(idxs, n)),
                                 "numpy_ms": numpy_ms, "bit_equal": True}
    res["batch_mb"] = (got[0].nbytes + got[1].nbytes) / 1e6
    res["dtypes"] = [str(got[0].dtype), str(got[1].dtype)]
    return res


def loader_train_steps(art: Path, params: dict, totals: dict) -> dict:
    """Two full-width train steps at batch 8 (ConvLSTM 1000/1000, bf16
    convs) in each form, direct, ``segment_windows`` 4 and the int8 codec,
    fed by ``PrefetchLoader`` through the loader (counted) and through the
    numpy reader, from the same params: the first batches and the losses
    bit for bit.  If the losses differ, both runs go again under
    ``torch.use_deterministic_algorithms`` and must be bit-equal there."""
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.data.dataset import (PrefetchLoader, SegmentWindowDataset,
                                              WindowDataset, builtin_split)
    from cp360_tpu_torch.train import loop

    dev = torch.device("cuda")
    res = {}
    for form, kw in (("direct", {}), ("segments", {"segment_windows": 4}),
                     ("int8", {"transfer_codec": "int8"})):
        cfg = Config(batch_size=8, clstm_conv_impl="pallas", **kw)
        ds = WindowDataset(str(art), None, builtin_split("train_60"), cfg.seq_len)
        if cfg.segment_windows > 1:
            ds = SegmentWindowDataset(ds, cfg.segment_windows)
        loader = PrefetchLoader(ds, cfg.batch_size // cfg.segment_windows, seed=SEED,
                                num_threads=cfg.processes, transfer_codec=cfg.transfer_codec)

        def run():
            model = loop.trainable_clstm(cfg, params, dev)
            step = loop.make_train_step(cfg, model, loop.make_optimizer(cfg, model))
            losses, first = [], None
            for seq, flows in loader.iter_epoch(0):
                if first is None:
                    first = (seq, flows)
                m = step(loop.batch_to_device(seq, dev), loop.batch_to_device(flows, dev))
                losses.append(float(m["loss"]))
            del model, step
            return losses, first

        (losses, first), got = counted_run(totals, run)
        with numpy_reader():
            losses_np, first_np = run()
        steps = len(losses)
        out = {"losses": losses, "losses_numpy": losses_np,
               "first_batch_bit_equal": batch_bits_equal(first, first_np),
               "losses_bit_equal": losses == losses_np, "launches": got}
        if losses != losses_np:
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                det, _ = run()
                with numpy_reader():
                    det_np, _ = run()
            finally:
                torch.use_deterministic_algorithms(False)
            out["deterministic_algorithms"] = {"losses": det, "losses_numpy": det_np,
                                               "bit_equal": det == det_np}
        torch.cuda.empty_cache()
        print(f"loader: {form} train steps {json.dumps(out)}", flush=True)
        if steps != 2 or got["cube_conv3x3"] != 15 * steps or \
                got["cube_conv3x3_dx"] != 14 * steps:
            fail(f"{form}: {steps} steps (want 2), launches {got} (15 K1, 14 dx a step)")
        if not out["first_batch_bit_equal"] or not (
                out["losses_bit_equal"] or out["deterministic_algorithms"]["bit_equal"]):
            fail(f"{form}: train steps fed by the loader differ from the numpy reader's: {out}")
        res[form] = out
    return res


def child_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("CP360_PLATFORM", "CP360_CUBE_CONV_FORM")}
    env.update(extra)
    return env


def run_worker(mode: str, tmp: Path, argv=(), timeout: float = 600, **env) -> dict:
    """``chip_smoke.py --worker mode`` as a subprocess; its ``WORKER``
    JSON line."""
    p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--worker", mode,
                        "--worker-argv", json.dumps(list(argv))], cwd=tmp,
                       env=child_env(**env), capture_output=True, text=True, timeout=timeout)
    line = next((ln for ln in p.stdout.splitlines() if ln.startswith("WORKER ")), None)
    if p.returncode != 0 or line is None:
        fail(f"worker {mode} {env}: rc {p.returncode}\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    return json.loads(line[len("WORKER "):])


def worker_cli_device(argv) -> None:
    """``cli.train_temporal.main(argv)`` run as a user runs it, recording
    the device its entry point resolved; prints ``WORKER {json}`` with that
    device, whether CUDA was ever initialised in this process and K1's
    launches."""
    from cp360_tpu_torch.cli import train_temporal
    from cp360_tpu_torch.ops import cube_conv
    from cp360_tpu_torch.serving import server

    resolved = []
    resolve = server.resolve_device

    def record(device):
        resolved.append(str(resolve(device)))
        return torch.device(resolved[-1])

    server.resolve_device = record
    t0 = time.monotonic()
    trained = train_temporal.main(argv)
    print("WORKER " + json.dumps({
        "resolved": resolved, "cuda_initialized": torch.cuda.is_initialized(),
        "k1_launches": cube_conv.launches, "trained": sorted(trained),
        "seconds": time.monotonic() - t0}), flush=True)


def worker_cube_conv_form() -> None:
    """With ``CP360_CUBE_CONV_FORM`` set: a bf16 resnet50 built without a
    form takes the variable's; its stage 1 on 8 seeded 960x1920 frames and
    its features on 2 frames' cubes against the models built with that
    form and with the other as a keyword (bits, max difference), and the
    stage-1 ms of the variable's form and the other, paired (variable,
    other, other, variable); prints ``WORKER {json}``."""
    from cp360_tpu_torch.compat import jax_params
    from cp360_tpu_torch.ops import equi_gather
    from cp360_tpu_torch.pipelines.extract import IMAGENET_MEAN, IMAGENET_STD, stage1_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    var = os.environ["CP360_CUBE_CONV_FORM"]
    other = {"pad": "halo", "halo": "pad"}[var]
    rng = np.random.RandomState(SEED + 21)
    x8 = torch.from_numpy(np.stack([natural_frame(960, 1920, rng) for _ in range(8)])).cuda()
    tree = jax_params.init_resnet_params(SEED, "resnet50")
    models = {name: jax_params.resnet_from_params(tree, "resnet50", True, torch.bfloat16,
                                                  "cuda", form)
              for name, form in (("variable", None), ("keyword", var), ("other", other))}
    mean = torch.tensor(IMAGENET_MEAN, device="cuda")
    std = torch.tensor(IMAGENET_STD, device="cuda")

    def run(model):
        with torch.no_grad():
            return stage1_batch(model, x8)

    outs = {}
    with torch.no_grad():
        cubes = (equi_gather.equi_to_cube(x8[:2], 224) - mean) / std
        for name, model in models.items():
            outs[name] = [t.cpu() for t in run(model)] + [
                model(cubes, with_logits=False)[1].cpu()]
    ms = {"variable": [], "other": []}
    for name in ("variable", "other", "other", "variable"):
        ms[name].append(median_ms(lambda: run(models[name])))
    print("WORKER " + json.dumps({
        "variable": var, "resolved_form": models["variable"].cube_conv_form,
        "bit_equal_to_keyword": all(torch.equal(a, b) for a, b in
                                    zip(outs["variable"], outs["keyword"])),
        "features_vs_other_max": float((outs["variable"][2].float()
                                        - outs["other"][2].float()).abs().max()),
        "stage1_ms": {var: ms["variable"], other: ms["other"]}, "card": gpu_line()}),
        flush=True)


def tiny_artifacts(root: Path) -> None:
    """One train_60 video of 8 frames at CPU widths: CAMs [6,8,7,7] f16,
    flows [8,16,2] f32 (tests/test_torch_train.py::_artifacts)."""
    from cp360_tpu_torch.data.dataset import builtin_split

    rng = np.random.RandomState(SEED + 40)
    vid = builtin_split("train_60")[0]
    for sub in ("cube_feat", "motion"):
        (root / vid / sub).mkdir(parents=True)
    for i in range(2, 10):
        np.save(root / vid / "cube_feat" / f"{i:06}.npy",
                rng.rand(6, 8, 7, 7).astype(np.float16))
        np.save(root / vid / "motion" / f"{i:06}.npy",
                (rng.randn(8, 16, 2) * 2).astype(np.float32))


def loader_without_motion(art: Path, vids, tmp: Path) -> dict:
    """The CAMs of ``art`` alone (no motion dirs) with ``require_motion=False``
    through ``WindowDataset`` and ``SegmentWindowDataset`` (G = 4), fed by
    ``PrefetchLoader`` (batches of 3, ``drop_last=False``, two epochs by
    ``for``), through the loader and through the numpy reader: every batch
    bit-equal, each ``for`` epoch bit-equal to ``iter_epoch`` of its number,
    the flows empty [B, F, 0, 0, 2] f32, and the last batch short."""
    from cp360_tpu_torch.data.dataset import (PrefetchLoader, SegmentWindowDataset,
                                              WindowDataset)

    cams = tmp / "cams_only"
    for v in vids:
        shutil.copytree(art / v / "cube_feat", cams / v / "cube_feat")
    res = {}
    for form in ("windows", "segments"):
        def read():
            ds = WindowDataset(str(cams), None, vids, 5, require_motion=False)
            if form == "segments":
                ds = SegmentWindowDataset(ds, 4)
            loader = PrefetchLoader(ds, 3, seed=SEED, num_threads=4, drop_last=False)
            by_for = [list(loader) for _ in range(2)]
            return len(ds), len(loader), by_for, [list(loader.iter_epoch(e)) for e in (0, 1)]

        n, n_batches, by_for, by_epoch = read()
        with numpy_reader():
            _, _, by_for_np, _ = read()

        def same(a, b):
            return len(a) == len(b) and all(batch_bits_equal(x, y) for x, y in zip(a, b))

        sizes = [[len(seq) for seq, _ in epoch] for epoch in by_for]
        want_sizes = [[3] * (n // 3) + ([n % 3] if n % 3 else [])] * 2
        out = {"items": n, "batches": n_batches, "sizes": sizes,
               "bit_equal_to_numpy": all(same(a, b) for a, b in zip(by_for, by_for_np)),
               "for_equals_iter_epoch": all(same(a, b) for a, b in zip(by_for, by_epoch)),
               "flows_empty_f32": all(f.shape[2:] == (0, 0, 2) and f.dtype == np.float32
                                      for epoch in by_for for _, f in epoch)}
        res[form] = out
        print(f"loader: require_motion=False, {form}: {json.dumps(out)}", flush=True)
        if sizes != want_sizes or n % 3 == 0 or n_batches != len(want_sizes[0]) or \
                not (out["bit_equal_to_numpy"] and out["for_equals_iter_epoch"]
                     and out["flows_empty_f32"]):
            fail(f"require_motion=False through the {form} loader: {out} "
                 f"(want batch sizes {want_sizes})")
    return res


def extract_upload_depths(tmp: Path, totals: dict) -> dict:
    """``extract_video`` at full width (resnet50, 960x1920 frames, 224
    faces, bf16, ``host_cube_remap: true``, batches of 16) on a seeded
    129-frame mp4v video at ``upload_depth`` 1, 4, 4, 1 in turns, after a
    warm-up run: the 128 CAM artifacts bit-equal, one K3 launch a batch
    and no K2, and each run's frames/s on the host clock."""
    from cp360_tpu_torch.compat import jax_params
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.pipelines.extract import extract_video

    video = tmp / "upload.mp4"
    write_video(video, 129, np.random.RandomState(SEED + 43))
    cfg = Config(cube_dim=224, equi_h=1920, equi_w=960, compute_dtype="bfloat16",
                 host_cube_remap=True, extract_batch=16, opt_flow=False, feat_dtype="float16")
    model = jax_params.resnet_from_params(jax_params.init_resnet_params(SEED, "resnet50"),
                                          "resnet50", True, torch.bfloat16, "cuda")

    def run(depth: int, out: Path) -> int:
        return extract_video(model, cfg.replace(upload_depth=depth), str(video), str(out),
                             output_img=False, batch_frames=cfg.extract_batch,
                             log_fn=lambda line: print(f"loader: {line}", flush=True))

    run(4, tmp / "upload_warm")
    res, arts = {"card": gpu_line(), "runs": []}, []
    for turn, depth in enumerate((1, 4, 4, 1)):
        out = tmp / f"upload_{turn}"
        t0 = time.monotonic()
        written, got = counted_run(totals, lambda: run(depth, out))
        wall = time.monotonic() - t0
        arts.append({n: (out / "cube_feat" / n).read_bytes()
                     for n in sorted(os.listdir(out / "cube_feat"))})
        res["runs"].append({"upload_depth": depth, "frames": written, "s": wall,
                            "frames_per_s": written / wall, "launches": got})
        print(f"loader: extract_video upload_depth {depth}: {written / wall:.2f} frames/s "
              f"({written} frames in {wall:.3f} s; {res['card']})", flush=True)
        if written != 128 or got["cube_pool3x3s2"] != 8 or got["equi_to_cube"] != 0:
            fail(f"extract_video at upload_depth {depth}: {res['runs'][-1]} "
                 "(want 128 frames, 8 K3 launches, no K2)")
    res["bit_equal"] = len(arts[0]) == 128 and all(a == arts[0] for a in arts[1:])
    if not res["bit_equal"]:
        fail("extract_video's artifacts differ between upload_depth 1 and 4")
    del model
    torch.cuda.empty_cache()
    return res


def phase_loader() -> dict:
    """The batch ``.npy`` loader, ``use_gpu``/``CP360_PLATFORM``,
    ``CP360_CUBE_CONV_FORM`` and the public parameters the JAX package's
    callers reach on the card (see the module docstring, phase 10)."""
    from cp360_tpu_torch import native
    from cp360_tpu_torch.compat import jax_params
    from cp360_tpu_torch.ops import _build
    from cp360_tpu_torch.pipelines.temporal import infer_video

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_loader_", dir=build))
    stats = {"card": gpu_line()}
    counted: dict = {}
    try:
        gxx = _build.gxx_path()
        version = subprocess.run([gxx, "--version"], capture_output=True, text=True,
                                 timeout=60).stdout.splitlines()[0]
        t0 = time.monotonic()
        native.get_lib()  # built by phase 1 beside the kernels
        lib = _build.library_path(native.NAME)
        print(f"loader: {lib.relative_to(ROOT)} loaded in {time.monotonic() - t0:.2f} s, "
              f"built by `{gxx} {' '.join(_build.GXX_FLAGS)} -o ... "
              f"{(_build.CSRC / 'npy_loader.cpp').relative_to(ROOT)}` ({version})", flush=True)

        t0 = time.monotonic()
        art = tmp / "art"
        n_windows = write_artifacts(art, n_frames=13)  # 8 windows a video
        vids = sorted(os.listdir(art))
        print(f"loader: {n_windows} windows of full-width artifacts written in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        stats["reads"] = loader_reads(art, vids)
        print(f"loader: batch of 8 windows, host ms per batch {json.dumps(stats['reads'])}",
              flush=True)

        params = jax_params.init_clstm_params(SEED + 41, 1000, 1000)
        stats["train_steps"] = loader_train_steps(art, params, counted)

        cell = jax_params.clstm_from_params(params, torch.bfloat16, True, "pallas", "cuda")
        feat_dir = str(art / vids[0] / "cube_feat")
        preds, got = counted_run(counted, lambda: infer_video(cell, feat_dir, 5,
                                                              batch_windows=4))
        with numpy_reader():
            preds_np = infer_video(cell, feat_dir, 5, batch_windows=4)
        same = sorted(preds) == sorted(preds_np) and all(
            preds[k].tobytes() == preds_np[k].tobytes() for k in preds)
        stats["infer_video"] = {"windows": len(preds), "bit_equal": same, "launches": got}
        print(f"loader: infer_video on {feat_dir}: {json.dumps(stats['infer_video'])}",
              flush=True)
        if len(preds) != 8 or not same or got["cube_conv3x3"] != 30:
            fail(f"infer_video through the loader: {stats['infer_video']} (want 8 windows, "
                 "bit-equal to the numpy reader, 15 K1 a batch of 4)")
        by_depth = {d: counted_run(counted, lambda: infer_video(
            cell, feat_dir, 5, batch_windows=2, prefetch_depth=d)) for d in (1, 3)}
        same = sorted(by_depth[1][0]) == sorted(by_depth[3][0]) == list(range(8)) and all(
            by_depth[1][0][k].tobytes() == by_depth[3][0][k].tobytes() for k in range(8))
        stats["infer_video_prefetch_depth"] = {
            "bit_equal": same, "launches": {d: got for d, (_, got) in by_depth.items()}}
        print(f"loader: infer_video at prefetch_depth 1 and 3, batches of 2: "
              f"{json.dumps(stats['infer_video_prefetch_depth'])}", flush=True)
        if not same or any(got["cube_conv3x3"] != 60 for _, got in by_depth.values()):
            fail(f"infer_video by prefetch depth: {stats['infer_video_prefetch_depth']} "
                 "(want bit-equal predictions, 15 K1 a batch of 2)")
        del cell, params, by_depth
        torch.cuda.empty_cache()
        stats["require_motion_false"] = loader_without_motion(art, vids, tmp)
        stats["extract_upload_depth"] = extract_upload_depths(tmp, counted)

        # -- use_gpu: false and CP360_PLATFORM in a child CLI
        tiny_artifacts(tmp / "tiny")
        for name, env in (("cpu", {}), ("cuda", {"CP360_PLATFORM": "cuda"})):
            cfg = tmp / f"use_gpu_false_{name}.yaml"
            cfg.write_text(f"use_gpu: false\ninput_size: 8\nhidden_size: 8\nflow_h: 8\n"
                           f"epochs: 1\ncheckpoint_path: {tmp / ('ck_' + name)}\n")
            res = run_worker("cli-device", tmp, ["--input", str(tmp / "tiny"), "--config",
                                                 str(cfg)], **env)
            stats[f"use_gpu_false_{name}"] = res
            print(f"loader: train_temporal, config use_gpu: false, env {env}: "
                  f"{json.dumps(res)}", flush=True)
            want = {"cpu": (["cpu"], False), "cuda": (["cuda"], True)}[name]
            if (res["resolved"], res["cuda_initialized"]) != want \
                    or (res["k1_launches"] > 0) != (name == "cuda"):
                fail(f"use_gpu: false with env {env}: {res} (want device {want[0]}, "
                     f"CUDA initialised {want[1]})")

        # -- CP360_CUBE_CONV_FORM=pad in a child
        res = run_worker("cube-conv-form", tmp, CP360_CUBE_CONV_FORM="pad")
        stats["cube_conv_form_pad"] = res
        print(f"loader: CP360_CUBE_CONV_FORM=pad, bf16 resnet50 stage 1 at 8 frames "
              f"{json.dumps(res)}", flush=True)
        if res["resolved_form"] != "pad" or not res["bit_equal_to_keyword"]:
            fail(f"CP360_CUBE_CONV_FORM=pad: {res}")
        print(f"loader: {json.dumps(stats)}", flush=True)
        return counted
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- phase 11: the measurement programs ------------------------------------------

BENCH_METRICS = {  # program -> its line's metrics, each with the numbers that must be > 0
    "stage1": {"stage1_frames_per_sec": ("value", "device_fps")},
    "stage2": {"stage2_windows_per_sec": ("value", "device_resident", "host_fed")},
    "train": {"train_windows_per_s": ("value", "s_per_step"),
              "train_windows_per_s_hostfed": ("exact", "int8")},
    "stream": {"stream_frames_per_sec": ("value",)},
    "serve": {"serve_link_budget": ("h2d_bytes_per_request",),
              "serve_saliency_latency_ms": ("median", "p90"),
              "serve_saliency_concurrent": ("requests_per_s", "max_group"),
              "serve_temporal_concurrent": ("frames_per_s", "window_max_group"),
              "serve_sweep": ("requests_per_s", "p50_ms", "p99_ms")},
    "profile_stage1": {"stage1_ms_per_batch": ("full_fps", "device_busy_ms")},
    "profile_backbone": {"backbone_stage_ms": (),
                         "stem_pool_forms_ms": ("unfused_ms", "fused_rw_ms")},
    "cube_conv": {"cube_conv_ms": ()},
    "cube_conv_forms": {"cube_conv_form": ("ms_per_batch", "fps"),
                        "cube_conv_form_best": ("fps",)},
}
BENCH_KERNELS = {  # program -> the kernels its path must launch
    "stage1": ("cube_pool3x3s2",), "stage2": ("cube_conv3x3",),
    "train": ("cube_conv3x3", "cube_conv3x3_dx"),
    "stream": ("cube_conv3x3", "cube_pool3x3s2"),
    "serve": ("cube_conv3x3", "cube_pool3x3s2"),
    "profile_stage1": ("cube_pool3x3s2",), "profile_backbone": ("cube_pool3x3s2",),
    "cube_conv": ("cube_conv3x3", "cube_conv3x3_dx"), "cube_conv_forms": ("cube_pool3x3s2",),
}


def numbers(tree, key=""):
    """(key, number) for every int or float leaf of a JSON tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from numbers(v, k)
    elif isinstance(tree, list):
        for v in tree:
            yield from numbers(v, key)
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield key, tree


def check_bench_lines(name: str, lines: list, card: str) -> list:
    """What is wrong with one program's lines (empty if nothing)."""
    bad = []
    want = BENCH_METRICS[name]
    got = {line.get("metric") for line in lines}
    if got != set(want):
        bad.append(f"metrics {sorted(got)}, not {sorted(want)}")
    for line in lines:
        metric = line.get("metric")
        if card not in str(line.get("device")):
            bad.append(f"{metric}: device {line.get('device')!r}")
        for key, v in numbers(line):
            # a stage's share of the backbone is a difference of two times
            if not np.isfinite(v) or (v < 0 and metric != "backbone_stage_ms"):
                bad.append(f"{metric}: {key} = {v}")
        for key in want.get(metric, ()):
            if not (isinstance(line.get(key), (int, float)) and line[key] > 0):
                bad.append(f"{metric}: {key} = {line.get(key)!r}")
        if line.get("http_504"):
            bad.append(f"{metric}: {line['http_504']} requests timed out")
    return bad


def phase_bench() -> dict:
    from cp360_tpu_torch.bench import (common, cube_conv, cube_conv_forms, profile_backbone,
                                       profile_stage1, serve, stage1, stage2, stream, train)
    from cp360_tpu_torch.compat import jax_params
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.serving.server import SaliencyModel

    dev = torch.device("cuda")
    name_of_card = torch.cuda.get_device_name(0)
    params = jax_params.init_resnet_params(0, "resnet50")
    clstm_params = jax_params.init_clstm_params(0, 1000, 1000)
    halo = jax_params.backbone_from_params(params, "resnet50", True, torch.bfloat16, dev)
    pad = jax_params.backbone_from_params(params, "resnet50", True, torch.bfloat16, dev,
                                          cube_conv_form="pad")
    zero = jax_params.backbone_from_params(params, "resnet50", False, torch.bfloat16, dev)
    cell = jax_params.clstm_from_params(clstm_params, torch.bfloat16, True, "xla", dev)
    cfg = Config()
    serve_cfg = Config(compute_dtype="bfloat16", upload_format="yuv420", serve_max_batch=4,
                       serve_request_timeout_s=180.0)
    runs = {
        "stage1": lambda: [stage1.measure(halo, stage1.seeded_frames(4, 16), device=dev,
                                          n_warm=2, device_iters=2)[0]],
        "stage2": lambda: [stage2.measure(cell, 16, device=dev, n_meas=2, disk_passes=1)[0]],
        "train": lambda: [train.measure_device(cfg, clstm_params, 8, 2, device=dev)[0],
                          train.measure_host(cfg, clstm_params, 4, 1, device=dev)[0]],
        "stream": lambda: [stream.measure(halo, cell, stream.seeded_frames(32), 8, device=dev)],
        "serve": lambda: serve.measure(
            SaliencyModel(params, serve_cfg, arch="resnet50", clstm_params=clstm_params,
                          device=dev),
            n_requests=4, concurrency=2, levels=(2,), n_per_client=2),
        "profile_stage1": lambda: [profile_stage1.measure(halo, zero, 16, 2, device=dev)],
        "profile_backbone": lambda: [
            profile_backbone.profile_prefixes({"cubepad": halo, "zeropad": zero}, 16, 2,
                                              device=dev),
            profile_backbone.profile_pool(16, 2, device=dev)],
        "cube_conv": lambda: [cube_conv.measure(2, device=dev)],
        "cube_conv_forms": lambda: cube_conv_forms.measure({"pad": pad, "halo": halo}, 16, 32,
                                                           device=dev, reps=2),
    }
    totals, stats = {}, {"card": gpu_line(), "programs": {}}
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="smoke_bench_", dir=ROOT / "build"))
    try:
        for name, measure in runs.items():
            t0 = time.monotonic()
            out = tmp / f"{name}.json"
            args = argparse.Namespace(device="cuda", out=out)
            rc, got = counted_run(totals, lambda: common.run(name, args, lambda _: measure()))
            lines = json.loads(out.read_text())
            bad = [f"exit code {rc}"] if rc else []
            bad += check_bench_lines(name, lines, name_of_card)
            bad += [f"no {k} launch" for k in BENCH_KERNELS[name] if not got[k]]
            stats["programs"][name] = {"s": round(time.monotonic() - t0, 1), "launches": got}
            print(f"bench {name}: {time.monotonic() - t0:.1f} s, launches {got}", flush=True)
            if bad:
                fail(f"bench program {name}: {bad}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"bench {json.dumps(stats)}", flush=True)
    return totals


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
    parser.add_argument("--phases",
                        default="build,kernels,slice,train,options,video,backbones,stream,"
                                "parallel,loader,bench",
                        help="comma-separated subset of build,kernels,slice,train,options,"
                             "video,backbones,stream,parallel,loader,bench")
    parser.add_argument("--worker", choices=("grid-step", "nccl", "cli-device",
                                             "cube-conv-form"), default=None,
                        help="run one rank of the parallel phase's jobs (under cli.launch) "
                             "or one child of the loader phase")
    parser.add_argument("--worker-argv", default="[]",
                        help="the cli-device worker's train_temporal arguments (JSON list)")
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    if args.worker:
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is false: this smoke runs on the card only")
        sys.path.insert(0, str(ROOT))
        {"grid-step": worker_grid_step, "nccl": worker_nccl,
         "cli-device": lambda: worker_cli_device(json.loads(args.worker_argv)),
         "cube-conv-form": worker_cube_conv_form}[args.worker]()
        return

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

    t_start = time.monotonic()
    phase_build()  # always: the later phases need the kernels
    kernels = phase_kernels() if "kernels" in phases else {}
    print(f"phase build+kernels: {time.monotonic() - t_start:.1f} s", flush=True)
    # each path runs with the counts set to 0 just before it, read just after
    by_path = {}
    for name, run in (("slice", phase_slice), ("train", phase_train),
                      ("options", phase_options), ("video", phase_video),
                      ("backbones", phase_backbones), ("stream", phase_stream),
                      ("parallel", phase_parallel), ("loader", phase_loader),
                      ("bench", phase_bench)):
        if name in phases:
            t0 = time.monotonic()
            by_path[name] = run()
            print(f"phase {name}: {time.monotonic() - t0:.1f} s", flush=True)

    meta = {
        "cube_conv3x3": ("cp360_tpu_torch/csrc/cube_conv3x3.cu",
                         "cp360_tpu/ops/pallas_kernels.py:136"),
        "cube_conv3x3_dx": ("cp360_tpu_torch/csrc/cube_conv3x3.cu",
                            "cp360_tpu/ops/pallas_kernels.py:258"),
        "equi_to_cube": ("cp360_tpu_torch/csrc/equi_to_cube.cu",
                         "cp360_tpu/ops/slot_gather.py:212"),
        "cube_pool3x3s2": ("cp360_tpu_torch/csrc/cube_pool3x3s2.cu",
                           "tools/bench_pool_pallas.py:39"),
        "conv_epilogue": ("cp360_tpu_torch/csrc/conv_epilogue.cu", None),
        "cube_dwconv": ("cp360_tpu_torch/csrc/cube_dwconv.cu", None),
        "cube_window_attn": ("cp360_tpu_torch/csrc/cube_window_attn.cu", None),
    }
    line = []
    for name, (source, replaces) in meta.items():
        k = kernels.get(name, {})
        paths = {path: n[name] for path, n in by_path.items()}
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": sum(paths.values()) if paths else None,
                     "launches_by_path": paths,
                     "max_abs_err": k.get("max_abs_err"), "ms": k.get("ms"),
                     "device_ms": k.get("device_ms"),
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
