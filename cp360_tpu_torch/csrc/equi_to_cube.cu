// Equirectangular -> cube faces: a 4-tap bilinear gather, one output pixel
// per thread.
//
// Replaces the TPU kernels of cp360_tpu/ops/slot_gather.py::apply_plan_pallas
// (_phase1_kernel and _make_phase23_kernel).  Those split the gather into a
// per-row slot gather, a row distribution per conflict layer and a tap
// blend, only because Mosaic allowed gathers within one 128-lane group or
// one 8-row band (and src_w % 128 == 0).  A GPU thread can load any
// address, so each thread reads the float source coordinates of its pixels
// (the in_x / in_y maps of geometry/equi_cube.py), loads their 4 taps and
// blends them.
//
// The arithmetic is that of cp360_tpu/ops/resample.py::_bilinear_gather
// (:55-80) in the same order: floor, clamp of the +1 neighbours and of the
// base tap to the frame, weights (1-fx)(1-fy), fx(1-fy), (1-fx)fy, fx fy,
// and the sum g00 w00 + g01 w01 + g10 w10 + g11 w11 from the left.  A u8
// tap is divided by 255 first, as the all-device stage-1 step divides the
// frame before it samples (pipelines/extract.py::stage1_batch).  Every
// operation is an explicitly rounded intrinsic, so nothing is fused into an
// FMA that the plain version does not do: the faces are bit-equal to the
// plain version on the CPU (ops/equi_gather.py::equi_to_cube_plain).
//
// What bounds it on an H100: bytes, counted as the work needs them.  The
// taps of a 960x1920 frame -> 224 faces read 1,043,349 distinct source
// pixels (56.6% of the frame; ops/equi_gather.py::source_bytes), 3.13 MB of
// u8; the two f32 maps (2.41 MB) are read once per launch; the faces are
// 3.61 MB of f32 per frame.  At 8 frames that is 56.35 MB, 16.8 us at
// 3.35 TB/s; the arithmetic is about 11 flops per output value.  The memory
// moves whole 32-byte sectors, and the taps touch 88% of the frame's
// sectors (4.88 MB), so the least traffic is 8.5 MB per frame.  What the
// design does about it:
// - One thread per output pixel of one frame, the frame from blockIdx.y (no
//   64-bit division).  kPix consecutive pixels per thread (float4 maps,
//   16-byte stores, a scalar tail where 6 fw^2 % kPix != 0) is kept as a
//   constant: 1 measured fastest on an H100 at 8 and 16 frames, 2, 4 and 8
//   slower, mostly in the part of a launch's time that does not grow with
//   the frames (cp360_tpu_torch/bench/equi_gather.py; times in PERF.md).
// - u8, 3 channels (the stage-1 frames): the x0 and x1 taps of a row are 6
//   adjacent bytes (3 where x0 is clamped at the last column and x1 == x0).
//   They come in at most two aligned 8-byte loads and are taken apart with
//   PRMT (row_span, span_byte): 2 to 4 loads per pixel instead of 12 (byte
//   loads measured a quarter slower).
// - The /255 is a product with RN(1/255) and one FMA correction
//   (div255): correctly rounded for every u8 value, as an IEEE division is,
//   in 3 instructions (a shared-memory table of the quotients measured
//   slower: random byte values conflict on its banks).
// - No shared-memory staging of the source: a 32x8 output tile's source
//   bounding box reaches 89,673 pixels near the poles and on the back
//   face's seam (x from 3.7 to 1919), more than a block's 227 KB of u8.  TMA
//   has no gather form and there is no product for wgmma: locality is left
//   to L1 and L2.
// What holds it: per frame it moves its 8.5 MB of sectors at about
// 2.4 TB/s, a gather's scattered sector reads; the rest is the launch's
// ramp and tail.
//
// C interface, for ctypes: launches on the given stream and returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 1;  // consecutive output pixels per thread (see above)
constexpr int kMaxGridY = 65535;
constexpr float kInv255 = 0x1.010102p-8f;  // RN(1/255)

// v / 255, correctly rounded, for an integer v in [0, 255]: q = RN(v r) is
// within an ulp of v / 255, its residual v - 255 q is exact in one FMA, and
// one more FMA with the correctly rounded reciprocal r gives RN(v / 255)
// (Markstein).  tests/test_torch_equi_gather.py replays this arithmetic
// exactly for all 256 values against IEEE division.
__device__ __forceinline__ float div255(float v) {
  const float q = __fmul_rn(v, kInv255);
  return __fmaf_rn(__fmaf_rn(-q, 255.0f, v), kInv255, q);
}

__device__ __forceinline__ float unit(uint8_t v) { return div255(static_cast<float>(v)); }
__device__ __forceinline__ float unit(float v) { return v; }

// Bytes [p, p + n) of a u8 frame (n <= 6) in the low bytes of a 64-bit
// word, with bytes 6 and 7 set to 0x00 and 0x4B for span_byte.  The bytes
// come from the aligned 8-byte word that holds p and, only when they run
// past it, the next one.  Each loaded word holds a byte of the frame, and
// an aligned 8-byte word lies in one page, so the bytes it holds beyond
// the tensor's ends cannot fault; they are discarded.
__device__ __forceinline__ uint64_t row_span(const uint8_t* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int off = static_cast<int>(a & 7);
  const uint64_t* w = reinterpret_cast<const uint64_t*>(a - off);
  const uint64_t lo = __ldg(w);
  const uint64_t hi = off + n > 8 ? __ldg(w + 1) : 0;
  // (hi << 1) << (63 - 8 off) is hi << (64 - 8 off), and 0 at off = 0
  const uint64_t v = (lo >> (8 * off)) | ((hi << 1) << (63 - 8 * off));
  return (v & 0x0000FFFFFFFFFFFFull) | 0x4B00000000000000ull;
}

// Byte k (0..5) of a row_span as an f32, exactly: PRMT places it under the
// bytes 0x4B 0x00 0x00, which read as the float 2^23 + byte.
__device__ __forceinline__ float span_byte(uint64_t span, int k) {
  const uint32_t bits = __byte_perm(static_cast<uint32_t>(span),
                                    static_cast<uint32_t>(span >> 32), k | 0x7660);
  return __fsub_rn(__uint_as_float(bits), 8388608.0f);
}

// kN floats from (to) p, which is aligned to 4 kN bytes, in one load (store).
template <int kN>
__device__ __forceinline__ void load_floats(const float* p, float* v) {
  if constexpr (kN == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (kN == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int kN>
__device__ __forceinline__ void store_floats(float* p, const float* v) {
  if constexpr (kN == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kN == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// The widest vector of at most 4 floats that divides k floats.
__host__ __device__ constexpr int vec_width(int k) { return k % 4 == 0 ? 4 : k % 2 == 0 ? 2 : 1; }

// One output pixel's taps: the flat source pixels of (y0, x0) and (y1, x0),
// the step to x1 (0 or 1 pixel) and the 4 weights.
struct Tap {
  int row0, row1, dx;
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Tap make_tap(float xs, float ys, int H, int W) {
  const float x0f = floorf(xs);
  const float y0f = floorf(ys);
  const float fx = __fsub_rn(xs, x0f);
  const float fy = __fsub_rn(ys, y0f);
  const int x0u = static_cast<int>(x0f);
  const int y0u = static_cast<int>(y0f);
  const int x1 = min(max(x0u + 1, 0), W - 1);
  const int y1 = min(max(y0u + 1, 0), H - 1);
  const int x0 = min(max(x0u, 0), W - 1);
  const int y0 = min(max(y0u, 0), H - 1);
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  Tap t;
  t.row0 = y0 * W + x0;
  t.row1 = y1 * W + x0;
  t.dx = x1 - x0;  // x1 = clamp(x0 + 1) is x0 + 1 or x0
  t.w00 = __fmul_rn(gx, gy);
  t.w01 = __fmul_rn(fx, gy);
  t.w10 = __fmul_rn(gx, fy);
  t.w11 = __fmul_rn(fx, fy);
  return t;
}

__device__ __forceinline__ float blend(float g00, float g01, float g10, float g11,
                                       const Tap& t) {
  float v = __fmul_rn(g00, t.w00);
  v = __fadd_rn(v, __fmul_rn(g01, t.w01));
  v = __fadd_rn(v, __fmul_rn(g10, t.w10));
  return __fadd_rn(v, __fmul_rn(g11, t.w11));
}

// kC > 0: C known at compile time (3 for frames), the pixels' values are
// kept and stored as vectors of up to 16 bytes; kC == 0: any C, scalar
// stores.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
    equi_to_cube(const T* __restrict__ src, const float* __restrict__ map_x,
                 const float* __restrict__ map_y, float* __restrict__ out, int H, int W,
                 int c_run, int per_cube) {
  const int C = kC > 0 ? kC : c_run;
  const int n = blockIdx.y;
  const int p0 = (blockIdx.x * kThreads + threadIdx.x) * kPix;
  if (p0 >= per_cube) return;
  const int cnt = min(kPix, per_cube - p0);

  float xs[kPix], ys[kPix];
  if (cnt == kPix) {  // the maps are 16-byte aligned and p0 % kPix == 0
    constexpr int kM = vec_width(kPix);
#pragma unroll
    for (int k = 0; k < kPix; k += kM) {
      load_floats<kM>(map_x + p0 + k, xs + k);
      load_floats<kM>(map_y + p0 + k, ys + k);
    }
  } else {  // pixels past the frame repeat the last one and are not stored
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      xs[j] = __ldg(map_x + p0 + min(j, cnt - 1));
      ys[j] = __ldg(map_y + p0 + min(j, cnt - 1));
    }
  }
  Tap tap[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) tap[j] = make_tap(xs[j], ys[j], H, W);
  const T* frame = src + static_cast<size_t>(n) * H * W * C;
  float* o = out + (static_cast<size_t>(n) * per_cube + p0) * C;

  if constexpr (kC > 0) {
    float acc[kPix * kC];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const Tap& t = tap[j];
      if constexpr (std::is_same<T, uint8_t>::value && kC == 3) {
        const int d = 3 * t.dx;
        const uint64_t s0 = row_span(frame + 3 * static_cast<size_t>(t.row0), d + 3);
        const uint64_t s1 = row_span(frame + 3 * static_cast<size_t>(t.row1), d + 3);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          acc[j * 3 + c] = blend(div255(span_byte(s0, c)), div255(span_byte(s0, d + c)),
                                 div255(span_byte(s1, c)), div255(span_byte(s1, d + c)), t);
        }
      } else {
        const T* p00 = frame + static_cast<size_t>(t.row0) * kC;
        const T* p10 = frame + static_cast<size_t>(t.row1) * kC;
        const int d = t.dx * kC;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          acc[j * kC + c] = blend(unit(__ldg(p00 + c)), unit(__ldg(p00 + d + c)),
                                  unit(__ldg(p10 + c)), unit(__ldg(p10 + d + c)), t);
        }
      }
    }
    constexpr int kV = vec_width(kPix * kC);
    if (cnt == kPix && reinterpret_cast<uintptr_t>(o) % (4 * kV) == 0) {
#pragma unroll
      for (int k = 0; k < kPix * kC; k += kV) store_floats<kV>(o + k, acc + k);
    } else {
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if (j < cnt) {
#pragma unroll
          for (int c = 0; c < kC; ++c) o[j * kC + c] = acc[j * kC + c];
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (j >= cnt) break;
      const Tap& t = tap[j];
      const T* p00 = frame + static_cast<size_t>(t.row0) * C;
      const T* p10 = frame + static_cast<size_t>(t.row1) * C;
      const int d = t.dx * C;
      for (int c = 0; c < C; ++c) {
        o[j * C + c] = blend(unit(__ldg(p00 + c)), unit(__ldg(p00 + d + c)),
                             unit(__ldg(p10 + c)), unit(__ldg(p10 + d + c)), t);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const T* src, const float* mx, const float* my, float* out, int N, int H,
                   int W, int C, int FW, cudaStream_t st) {
  const int per_cube = 6 * FW * FW;
  const unsigned groups = static_cast<unsigned>((per_cube + kPix - 1) / kPix);
  const unsigned blocks = (groups + kThreads - 1) / kThreads;
  const size_t src_frame = static_cast<size_t>(H) * W * C;
  const size_t out_frame = static_cast<size_t>(per_cube) * C;
  for (int n0 = 0; n0 < N; n0 += kMaxGridY) {  // gridDim.y holds 65535 frames
    const dim3 grid(blocks, static_cast<unsigned>(std::min(N - n0, kMaxGridY)));
    const T* s = src + n0 * src_frame;
    float* o = out + n0 * out_frame;
    if (C == 3) {
      equi_to_cube<T, 3><<<grid, kThreads, 0, st>>>(s, mx, my, o, H, W, C, per_cube);
    } else {
      equi_to_cube<T, 0><<<grid, kThreads, 0, st>>>(s, mx, my, o, H, W, C, per_cube);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int cp360_equi_to_cube(const void* src, int src_is_u8, const void* map_x,
                                  const void* map_y, void* out, int N, int H, int W, int C,
                                  int FW, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mx = static_cast<const float*>(map_x);
  const float* my = static_cast<const float*>(map_y);
  float* o = static_cast<float*>(out);
  const cudaError_t err =
      src_is_u8 ? launch(static_cast<const uint8_t*>(src), mx, my, o, N, H, W, C, FW, st)
                : launch(static_cast<const float*>(src), mx, my, o, N, H, W, C, FW, st);
  return static_cast<int>(err);
}
