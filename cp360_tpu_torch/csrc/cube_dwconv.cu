// The cube-padded depthwise 7x7 conv at stride 1 with its bias, ConvNeXt's
// token mixer:
//
//   y[n, f, i, j, c] = b[c] + sum_{a, b < 7} w[a, b, c] * xp[n, f, i + a, j + b, c]
//
// where xp is the face batch cube-padded by 3 (ops/cube_pad.py) and every
// face is S x S with S >= 3.  x and y are NHWC [N*6, S, S, C]: both bf16,
// both f32, or x f32 and y bf16 (ConvNeXt's residual stream is f32, and
// what the block computes from it bf16); w is [7, 7, C] (tap-major,
// channels last: the [C, 7, 7] kernel of models/convnext.py in its storage
// order) in x's dtype; b is C f32 values or null.
//
// It replaces no TPU kernel: the JAX package has no ConvNeXt.  Before it
// the port's only depthwise conv was MobileNetV2's 3x3, a padded copy of
// every face (ops/cube_pad.py's index_select) and cuDNN with groups = C.
// At pad 3 that copy is 1.2x (56 px faces) to 3.4x (7 px) the faces' bytes,
// in each of ConvNeXt-B's 36 blocks.  Here the halo is read in place: a tap
// inside the face reads the face's own pixel, a tap outside reads the
// pixel the cube pad's index map names (build_cube_pad_index_map(S, S, 3),
// int32 [6, S+6, S+6], flat indices into one cube's 6*S*S pixels), so no
// padded copy is made.  A null map pads with zeros (use_cube_pad false).
//
// Exactness: each output sums its 49 products in f32, in the taps'
// row-major order (a, then b), one fused multiply-add a tap; then the bias
// is added in f32 (__fadd_rn) and the sum rounded once to y's dtype (round
// to nearest even).  ops/cube_dwconv.py's plain version computes the
// same sum in f32 with F.conv2d, in cuDNN's or the CPU's order: the two
// agree to f32 reassociation error before the rounding, so within one ulp
// of y's dtype.
//
// What bounds it on an H100: at ConvNeXt-B's 36 convs on a batch of 48
// faces, 11.0 G multiply-adds (0.33 ms at 67 TFLOP/s, the f32 rate of the
// CUDA cores, which run these sums) against 0.96 GB read and written once
// in bf16 (0.29 ms at 3.35 TB/s), or 1.34 GB from f32 faces to bf16 (0.40
// ms): both, about equally.  Each output reads 49 taps,
// and each input pixel is a tap of 49 outputs in 7 rows; so a block copies
// a band of its face (up to 16 output rows, their 6 halo rows and columns,
// a few 16-byte channel vectors: kMaxBand bytes at most) into shared memory
// once, fetching each halo pixel through the map once, and its threads read
// the taps from there.  The band is padded with zero columns to whole runs
// of outputs, so the tap loop has no branch and its loads can be issued
// ahead.  One thread holds one 16-byte vector of channels (8 bf16 or 4 f32)
// of a run of WT = 4 outputs along a row: each of its 7 kernel rows reads
// 10 input vectors and 7 weight vectors for 28 products a channel.
// Neighbouring threads hold neighbouring channel vectors, so the band's
// loads are coalesced 16-byte accesses and its reads free of bank
// conflicts.  Measured at ConvNeXt-B's four bf16 shapes of a batch of 8
// (CUDA graphs of 20 launches): a first design that read every tap from
// device memory through L1, 7 outputs a thread, took 2.64 ms for the 36
// convs; the band 1.94 ms, without its branch and at 4 outputs a thread
// 1.75 ms, against a bound of 0.33.  Registers, unrolling, block sizes and
// weights in shared memory moved none of them by more than 10%.  In the
// bf16 kernel's machine code fewer than half the instructions are
// multiply-adds: the rest unpack bf16 pairs and compute addresses.
//
// C interface, for ctypes: launches on the given stream and returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a shape or a pointer
// the 16-byte vectors cannot take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int K = 7;   // the kernel's size
constexpr int P = 3;   // its pad
constexpr int WT = 4;  // outputs a thread, along a row
constexpr int kMaxThreads = 256;
constexpr int kMaxBand = 200 * 1024;  // shared memory a block may take
constexpr int kMaxDevices = 64;

// bf16 -> f32 is a shift of the bits: exact.
template <bool IS_BF16>
__device__ __forceinline__ void unpack(const uint4& v, float* out) {
  if constexpr (IS_BF16) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out[2 * k] = __uint_as_float(w[k] << 16);
      out[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  } else {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
}

// Two f32 values rounded to bf16 (to nearest even), packed low first.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// Stores one input vector's outputs at vector index t of y: 16 bytes, or
// 8 where f32 inputs give bf16 outputs.
template <bool IN_BF16, bool OUT_BF16>
__device__ __forceinline__ void store(void* out, long long t, const float* m) {
  if constexpr (IN_BF16) {
    static_cast<uint4*>(out)[t] =
        make_uint4(pack2(m[0], m[1]), pack2(m[2], m[3]), pack2(m[4], m[5]), pack2(m[6], m[7]));
  } else if constexpr (OUT_BF16) {
    static_cast<uint2*>(out)[t] = make_uint2(pack2(m[0], m[1]), pack2(m[2], m[3]));
  } else {
    static_cast<uint4*>(out)[t] = make_uint4(__float_as_uint(m[0]), __float_as_uint(m[1]),
                                             __float_as_uint(m[2]), __float_as_uint(m[3]));
  }
}

// A block: the outputs of TH rows of one face for CG channel vectors.  It
// first copies its input band, TH + 6 padded rows by S + 6 padded columns
// of CG vectors, into shared memory, reading each halo pixel once through
// the map; then each thread sums a run of WT outputs of one row and one
// channel vector from shared memory.  The band's rows are read from device
// memory (TH + 6) / TH times.
template <bool IS_BF16, bool OUT_BF16>
__global__ void __launch_bounds__(kMaxThreads)
    cube_dwconv(const uint4* __restrict__ x, const uint4* __restrict__ w,
                const float* __restrict__ bias, const int* __restrict__ map,
                void* __restrict__ out, int S, int CV, int TH, int CG) {
  constexpr int VEC = IS_BF16 ? 8 : 4;
  extern __shared__ uint4 band[];  // [TH + 6][BW][CG]
  const int strips = (S + WT - 1) / WT;
  const int bands = (S + TH - 1) / TH;
  const int groups = (CV + CG - 1) / CG;
  int q = blockIdx.x;
  const int cg0 = (q % groups) * CG;
  q /= groups;
  const int i0 = (q % bands) * TH;
  const int face = q / bands;  // n * 6 + f
  const int f = face % 6;
  const int face_px = S * S;
  const int cube0 = (face - f) * face_px;  // this cube's pixel 0
  const int SP = S + 2 * P;
  const int BW = strips * WT + 2 * P;  // the band's columns: SP, and zeros past it
  const int rows = min(TH + 2 * P, SP - i0);  // padded rows i0 .. i0 + rows - 1
  const int* fmap = map == nullptr ? nullptr : map + f * SP * SP;

  for (int e = threadIdx.x; e < rows * BW * CG; e += blockDim.x) {
    const int cl = e % CG;
    const int px = e / CG;
    const int pr = i0 + px / BW;  // padded row and column
    const int pc = px % BW;
    const int r = pr - P;
    const int c = pc - P;
    const int cv = cg0 + cl;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);  // a zero pad, a column past SP or a channel past C
    if (cv < CV && pc < SP) {
      if (r >= 0 && r < S && c >= 0 && c < S) {
        v = x[(face * face_px + r * S + c) * CV + cv];
      } else if (fmap != nullptr) {
        v = x[(cube0 + fmap[pr * SP + pc]) * CV + cv];
      }
    }
    band[e] = v;
  }
  __syncthreads();

  const int cl = threadIdx.x % CG;
  const int cv = cg0 + cl;
  const int strip = (threadIdx.x / CG) % strips;
  const int ti = threadIdx.x / (CG * strips);  // the output row in the band
  const int i = i0 + ti;
  const int j0 = strip * WT;
  if (cv >= CV || ti >= TH || i >= S) return;

  float acc[WT][VEC];
#pragma unroll
  for (int jj = 0; jj < WT; ++jj) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[jj][k] = 0.f;
  }
#pragma unroll 1
  for (int a = 0; a < K; ++a) {
    float wr[K][VEC];
#pragma unroll
    for (int b = 0; b < K; ++b) unpack<IS_BF16>(w[(a * K + b) * CV + cv], wr[b]);
    const uint4* brow = band + ((ti + a) * BW + j0) * CG + cl;
#pragma unroll
    for (int bb = 0; bb < WT + K - 1; ++bb) {  // padded column j0 + bb < BW: no branch
      float v[VEC];
      unpack<IS_BF16>(brow[bb * CG], v);
#pragma unroll
      for (int jj = 0; jj < WT; ++jj) {
        const int b = bb - jj;
        if (b >= 0 && b < K) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[jj][k] = fmaf(wr[b][k], v[k], acc[jj][k]);
        }
      }
    }
  }

  float bv[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) bv[k] = bias == nullptr ? 0.f : bias[cv * VEC + k];
  const long long orow = static_cast<long long>(face * face_px + i * S) * CV + cv;
#pragma unroll
  for (int jj = 0; jj < WT; ++jj) {
    const int j = j0 + jj;
    if (j < S) {
      float y[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        y[k] = bias == nullptr ? acc[jj][k] : __fadd_rn(acc[jj][k], bv[k]);
      }
      store<IS_BF16, OUT_BF16>(out, orow + j * CV, y);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }


// A band of TH rows (all of a face up to 16 rows) and as many channel
// vectors as keep a block within kMaxThreads threads and kMaxBand bytes.
struct Tiling {
  int TH, CG, threads;
  size_t bytes;
};

Tiling tiling(int S, int CV) {
  const int strips = (S + WT - 1) / WT;
  Tiling t{S < 16 ? S : 16, 1, 0, 0};
  const int BW = strips * WT + 2 * P;
  while (t.TH > 1 && (t.TH * strips > kMaxThreads ||
                      static_cast<size_t>(t.TH + 2 * P) * BW * 16 > kMaxBand)) {
    t.TH /= 2;
  }
  while (t.CG * 2 <= CV && t.CG * 2 * t.TH * strips <= kMaxThreads &&
         static_cast<size_t>(t.TH + 2 * P) * BW * t.CG * 2 * 16 <= kMaxBand) {
    t.CG *= 2;
  }
  t.threads = t.CG * t.TH * strips;
  t.bytes = static_cast<size_t>(t.TH + 2 * P) * BW * t.CG * sizeof(uint4);
  return t;
}

template <bool IS_BF16, bool OUT_BF16>
int launch(const void* x, const void* w, const float* b, const int* m, void* out, int faces,
           int S, int CV, cudaStream_t st) {
  static std::atomic<bool> opened[kMaxDevices];  // shared memory past 48 KB, once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opened[dev].load()) {
    e = cudaFuncSetAttribute(cube_dwconv<IS_BF16, OUT_BF16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBand);
    if (e != cudaSuccess) return static_cast<int>(e);
    opened[dev].store(true);
  }
  const Tiling t = tiling(S, CV);
  if (t.threads > kMaxThreads || t.bytes > kMaxBand) {
    return static_cast<int>(cudaErrorInvalidValue);  // faces wider than 1792 px
  }
  const long long blocks = static_cast<long long>(faces) * ((S + t.TH - 1) / t.TH) *
                           ((CV + t.CG - 1) / t.CG);
  cube_dwconv<IS_BF16, OUT_BF16><<<static_cast<unsigned>(blocks), t.threads, t.bytes, st>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(w), b, m, out, S, CV, t.TH,
      t.CG);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: faces x S x S x C values of the dtype is_bf16 names, contiguous; out:
// as many in bf16 (out_bf16) or f32, contiguous, bf16 when x is; w: 7 x 7 x
// C of x's dtype; bias: C f32 values or null; map: int32 [6, S+6, S+6] (the
// cube pad's index map at pad 3) or null for a zero pad; faces a multiple
// of 6; k must be 7; the vectors of x must number fewer than 2^31.
extern "C" int cp360_cube_dwconv(const void* x, int is_bf16, const void* w, const void* bias,
                                 const void* map, void* out, int out_bf16, int faces, int S,
                                 int C, int k, void* stream) {
  if (faces == 0) return 0;
  const int item = is_bf16 ? 2 : 4;
  if (k != K || faces % 6 != 0 || S < 1 || (map != nullptr && S < P) ||
      (is_bf16 && !out_bf16) || (static_cast<long long>(C) * item) % 16 != 0 ||
      !aligned16(x) || !aligned16(w) || !aligned16(out) ||
      static_cast<long long>(faces) * S * S * (C * item / 16) >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int CV = C * item / 16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int* m = static_cast<const int*>(map);
  if (is_bf16) return launch<true, true>(x, w, b, m, out, faces, S, CV, st);
  return out_bf16 ? launch<false, true>(x, w, b, m, out, faces, S, CV, st)
                  : launch<false, false>(x, w, b, m, out, faces, S, CV, st);
}
