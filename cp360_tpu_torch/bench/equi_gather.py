"""K2 (``csrc/equi_to_cube.cu``) against an earlier version of itself and
against its design options, in turns, on one card.

    git show <commit>:cp360_tpu_torch/csrc/equi_to_cube.cu > build/parent_equi_to_cube.cu
    python -m cp360_tpu_torch.bench.equi_gather --parent build/parent_equi_to_cube.cu

Every version keeps the C interface ``cp360_equi_to_cube``.  Besides the
given ``--parent`` and the current source (``change``), the options of the
design are built from the current source by the text edits in
``VARIANTS`` (an edit fails loudly if the source no longer holds its text):

- ``byte_loads``: a row's tap bytes by one byte load each (3 or 6 per row)
  instead of at most two aligned 8-byte loads;
- ``div_table``: ``/255`` as a lookup in a 256-entry shared-memory table of
  IEEE quotients instead of a product and one FMA correction;
- ``occupancy8``: ``__launch_bounds__`` asking for 8 blocks per SM;
- ``block128`` / ``block512``: 128 or 512 threads per block instead of 256;
- ``pix2`` / ``pix4`` / ``pix8``: 2, 4 or 8 consecutive output pixels per
  thread (vector map loads and stores) instead of 1;
- ``frames_fastest``: the grid walks the frames fastest (blocks running
  together sample the same face region of every frame) instead of the
  pixels;
- ``funnel``: the row bytes assembled with 32-bit funnel shifts instead of
  64-bit shifts;
- ``frames2``: each thread samples two frames with one set of taps.

Each is built with nvcc (``-Xptxas -v``: registers and spills printed),
held bit for bit against the plain version on the CPU on u8 960x1920 frames
-> 224 faces, then timed at 8 and 16 frames in the order parent, change,
the variants, the variants reversed, change, parent.  A time is the device
time of one launch: a CUDA graph of 50 direct launches (no Python between
them), replayed 5 times after a warm-up replay, the median replay over 50.
The JSON result goes to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from cp360_tpu_torch.ops import _build, equi_gather, resample

BUILD = _build.BUILD_DIR.parent / "bench_equi_gather"
LAUNCHES_PER_GRAPH = 50
H, W, FW = 960, 1920, 224

_ROW_SPAN_WORDS = """\
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int off = static_cast<int>(a & 7);
  const uint64_t* w = reinterpret_cast<const uint64_t*>(a - off);
  const uint64_t lo = __ldg(w);
  const uint64_t hi = off + n > 8 ? __ldg(w + 1) : 0;
  // (hi << 1) << (63 - 8 off) is hi << (64 - 8 off), and 0 at off = 0
  const uint64_t v = (lo >> (8 * off)) | ((hi << 1) << (63 - 8 * off));
  return (v & 0x0000FFFFFFFFFFFFull) | 0x4B00000000000000ull;
"""
_ROW_SPAN_BYTES = """\
  uint64_t v = 0x4B00000000000000ull;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    if (k < n) v |= static_cast<uint64_t>(__ldg(p + k)) << (8 * k);
  }
  return v;
"""
_DIV255 = """\
  const float q = __fmul_rn(v, kInv255);
  return __fmaf_rn(__fmaf_rn(-q, 255.0f, v), kInv255, q);
"""
_SPAN_BYTE = """\
  const uint32_t bits = __byte_perm(static_cast<uint32_t>(span),
                                    static_cast<uint32_t>(span >> 32), k | 0x7660);
  return __fsub_rn(__uint_as_float(bits), 8388608.0f);
"""
_UNIT_U8 = "__device__ __forceinline__ float unit(uint8_t v) { return div255(static_cast<float>(v)); }"
_KERNEL_TOP = "  const int n = blockIdx.y;\n"

# name -> [(text in the current source, replacement)]
VARIANTS = {
    "byte_loads": [(_ROW_SPAN_WORDS, _ROW_SPAN_BYTES)],
    "div_table": [
        ("constexpr float kInv255", "__shared__ float s_unit[256];\nconstexpr float kInv255"),
        (_DIV255, "  return v;  // span_byte and unit already divided\n"),
        (_SPAN_BYTE, "  return s_unit[(span >> (8 * k)) & 0xff];\n"),
        (_UNIT_U8, "__device__ __forceinline__ float unit(uint8_t v) { return s_unit[v]; }"),
        (_KERNEL_TOP, _KERNEL_TOP + "  s_unit[threadIdx.x] = __fdiv_rn(static_cast<float>(threadIdx.x),"
                                    " 255.0f);  // kThreads == 256\n  __syncthreads();\n"),
    ],
    "occupancy8": [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 8)")],
    "block128": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "block512": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "pix2": [("constexpr int kPix = 1;", "constexpr int kPix = 2;")],
    "pix4": [("constexpr int kPix = 1;", "constexpr int kPix = 4;")],
    "pix8": [("constexpr int kPix = 1;", "constexpr int kPix = 8;")],
    "frames_fastest": [
        (_KERNEL_TOP, "  const int n = blockIdx.x;\n"),
        ("const int p0 = (blockIdx.x * kThreads + threadIdx.x) * kPix;",
         "const int p0 = (blockIdx.y * kThreads + threadIdx.x) * kPix;"),
        ("const dim3 grid(blocks, static_cast<unsigned>(std::min(N - n0, kMaxGridY)));",
         "const dim3 grid(static_cast<unsigned>(std::min(N - n0, kMaxGridY)), blocks);"),
    ],
    "funnel": [(_ROW_SPAN_WORDS, """\
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int off = static_cast<int>(a & 7);
  const uint2* w = reinterpret_cast<const uint2*>(a - off);
  const uint2 lo = __ldg(w);
  const uint2 hi = off + n > 8 ? __ldg(w + 1) : make_uint2(0u, 0u);
  const bool up = off >= 4;
  const uint32_t a0 = up ? lo.y : lo.x;
  const uint32_t a1 = up ? hi.x : lo.y;
  const uint32_t a2 = up ? hi.y : hi.x;
  const int s = 8 * (off & 3);
  const uint32_t r0 = __funnelshift_r(a0, a1, s);
  const uint32_t r1 = (__funnelshift_r(a1, a2, s) & 0xFFFFu) | 0x4B000000u;
  return (static_cast<uint64_t>(r1) << 32) | r0;
""")],
    "frames2": [
        ("int c_run, int per_cube) {", "int c_run, int per_cube, int n_frames) {"),
        ("  const T* frame = src + static_cast<size_t>(n) * H * W * C;\n"
         "  float* o = out + (static_cast<size_t>(n) * per_cube + p0) * C;\n",
         "  for (int f = 2 * n; f < min(2 * n + 2, n_frames); ++f) {\n"
         "  const T* frame = src + static_cast<size_t>(f) * H * W * C;\n"
         "  float* o = out + (static_cast<size_t>(f) * per_cube + p0) * C;\n"),
        ("      }\n    }\n  }\n}\n\ntemplate <typename T>\ncudaError_t launch",
         "      }\n    }\n  }\n  }\n}\n\ntemplate <typename T>\ncudaError_t launch"),
        ("    const dim3 grid(blocks, static_cast<unsigned>(std::min(N - n0, kMaxGridY)));",
         "    const int nf = std::min(N - n0, kMaxGridY);\n"
         "    const dim3 grid(blocks, static_cast<unsigned>((nf + 1) / 2));"),
        ("(s, mx, my, o, H, W, C, per_cube);\n    } else {\n"
         "      equi_to_cube<T, 0><<<grid, kThreads, 0, st>>>(s, mx, my, o, H, W, C, per_cube);",
         "(s, mx, my, o, H, W, C, per_cube, nf);\n    } else {\n"
         "      equi_to_cube<T, 0><<<grid, kThreads, 0, st>>>(s, mx, my, o, H, W, C, per_cube, nf);"),
    ],
}


def variant_source(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the kernel source no longer holds the text to edit: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_all(parent: Path) -> dict:
    """{name: ctypes function}, every nvcc started together."""
    BUILD.mkdir(parents=True, exist_ok=True)
    current = (_build.CSRC / "equi_to_cube.cu").read_text()
    sources = {"parent": parent.read_text(), "change": current}
    for name, edits in VARIANTS.items():
        sources[name] = variant_source(current, edits)
    nvcc = _build.nvcc_path()
    procs = {}
    for name, text in sources.items():
        cu = BUILD / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(BUILD / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"[ptxas {name}] {line.strip()}", flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(BUILD / f"{name}.so")).cp360_equi_to_cube
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr, ctypes.c_int, ptr, ptr, ptr] + [ctypes.c_int] * 5 + [ptr]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launcher(fn, frames: torch.Tensor, out: torch.Tensor):
    xs, ys = resample.equi2cube_maps(FW, H, W, frames.device)
    n = frames.shape[0]

    def launch():
        err = fn(frames.data_ptr(), 1, xs.data_ptr(), ys.data_ptr(), out.data_ptr(), n, H, W,
                 3, FW, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return launch


def graph_ms(launch) -> list:
    """Device ms per launch of 5 replays of a graph of 50 launches."""
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(LAUNCHES_PER_GRAPH):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / LAUNCHES_PER_GRAPH)
    return times


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, required=True,
                        help="an earlier equi_to_cube.cu with the same C interface")
    parser.add_argument("--out", type=Path, default=BUILD / "turns.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    fns = build_all(args.parent)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    frames = torch.randint(0, 256, (16, H, W, 3), generator=gen, device="cuda",
                           dtype=torch.int64).to(torch.uint8)
    ref = equi_gather.equi_to_cube_plain(frames[:8].cpu(), FW)
    result = {"card": card, "checks": {}, "ms": {}}
    for name, fn in fns.items():
        out = torch.empty((8, 6, FW, FW, 3), device="cuda")
        launcher(fn, frames[:8], out)()
        got = out.cpu()
        result["checks"][name] = {
            "bit_equal_cpu_plain": bool(torch.equal(got.view(torch.int32), ref.view(torch.int32))),
            "max_abs_err": float((got - ref).abs().max())}
    print(f"K2 turns checks {json.dumps(result['checks'])}", flush=True)

    order = ["parent", "change", *VARIANTS, *reversed(VARIANTS), "change", "parent"]
    for n in (8, 16):
        out = torch.empty((n, 6, FW, FW, 3), device="cuda")
        runs = {name: [] for name in fns}
        for name in order:
            runs[name].append(float(np.median(graph_ms(launcher(fns[name], frames[:n], out)))))
        result["ms"][str(n)] = {"order": order, "runs": runs}
        print(f"K2 turns {n} frames {json.dumps(runs)}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    bad = [k for k, v in result["checks"].items() if k != "parent" and not v["bit_equal_cpu_plain"]]
    if bad:
        sys.exit(f"not bit-equal to the CPU plain version: {bad}")


if __name__ == "__main__":
    main()
