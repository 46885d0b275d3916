// Fused CubePad(1) + 3x3 VALID convolution on cube feature maps: the forward
// (with bias) and its input gradient.
//
// Replaces the TPU kernel cp360_tpu/ops/pallas_kernels.py::_conv_core
// (pallas_call body _kernel).  That kernel computed out = sum_k A_k (x W_k)
// with A_k a 0/1 selection matrix, because gathers were slow on the TPU; it
// also rounded the 9 tap sums to bf16 once.  It ran twice in training: as
// cube_conv3x3 (forward, gather selection) and from _cc_bwd (input gradient,
// scatter selection, tap-transposed W).  Here the cube padding is a gather in
// the A-tile load instead, and the sum stays in f32 until the single
// rounding at the store.
//
// Both directions are one implicit GEMM over "slots":
//   out[m, n] = bias[n] + sum_{s<S} sum_{c} in[src(s, m), c] * W[tap(s)](c, n)
// with M = N_cubes * P rows (P = 6 * h * w positions of one cube;
// m = cube * P + p) and a depth of S * C.  src(s, m) = cube * P + tab[s*P + p]
// comes from an [S, P] int32 table built on the host (ops/cube_conv.py); an
// entry of -1 reads a zero row.
//   - forward: S = 9 slots, one per tap; in = x [M, Cin]; W[k] is the HWIO
//     kernel's [Cin, Cout] slice (row-major, read as is); out [M, Cout].
//   - input gradient (dx): in = dy [M, Cout]; W[k]^T, read transposed from
//     the same [9, Cin, Cout] kernel; out = dx [M, Cin]; no bias.  The
//     cube-pad map of one tap is not injective (an input pixel on a face
//     edge feeds up to 3 outputs of the same tap), so each tap's inverse map
//     is split into injective layers: 23 slots at 7x7 faces, listed with
//     their taps by ops/cube_conv.py::dx_slot_table.  This does 23/9 ~ 2.6x
//     the products the gradient needs (rows of -1 are multiplied as zeros).
//
// What bounds it on an H100: at the ConvLSTM's widths (Cin 2000/4000,
// Cout 4000, P = 294) and 8 windows the forward's products are 677 GFLOP
// per 4000->4000 conv against a 288 MB weight stream, so tensor-core
// throughput bounds it (0.685 ms at 989 TFLOP/s vs 0.086 ms of weight bytes
// at 3.35 TB/s); at one window the two bounds meet (~0.086 ms each).  dx
// has the same necessary work.  This first version is the simple tiled
// form: bf16 runs 128x128x32 tiles on the tensor cores through WMMA
// (mma.sync) with a two-stage cp.async ring; f32 (the parity path) runs
// 64x64x16 tiles of plain FMAs.  Faster forms (wgmma, TMA, a deeper ring,
// a dx loader that sums the <= 3 rows of one tap instead of 23 slots) are
// later work.
//
// C interface, for ctypes: every call launches on the given stream and
// returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

using nvcuda::wmma::accumulator;
using nvcuda::wmma::col_major;
using nvcuda::wmma::fragment;
using nvcuda::wmma::matrix_a;
using nvcuda::wmma::matrix_b;
using nvcuda::wmma::mem_row_major;
using nvcuda::wmma::row_major;

// ---- bf16: tensor cores ---------------------------------------------------

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;  // 8 warps as 4 (rows) x 2 (cols), 32x64 each
constexpr int A_LD = BK + 8;  // row pitches keep 32-byte aligned WMMA tiles
                              // and spread the rows over the smem banks

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = pred ? 16 : 0;  // 0 bytes read: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// WT = false: W[tap] is [K, N] row-major (forward).  WT = true: W[tap] is
// [N, K] row-major and read transposed (dx), so the B tile is kept n-major
// in shared memory and fed to WMMA as a col_major fragment.
//
// Needs K % 8 == 0, N % 8 == 0 and 16-byte aligned in, w, out (the wrapper
// checks): each cp.async moves 8 channels of one row.  bias may be null.
template <bool WT>
__global__ void __launch_bounds__(THREADS)
    cube_conv3x3_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      const __nv_bfloat16* __restrict__ bias, const int* __restrict__ tab,
                      const int* __restrict__ slot_tap, __nv_bfloat16* __restrict__ out, int M,
                      int P, int S, int K, int N) {
  constexpr int B_ROWS = WT ? BN : BK;
  constexpr int B_LD = WT ? BK + 8 : BN + 8;
  __shared__ __align__(128) __nv_bfloat16 As[2][BM][A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][B_ROWS][B_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int warp_m = warp / 2;
  const int warp_n = warp % 2;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // A tile: 128 rows x 4 chunks of 8 channels; each thread moves 2 chunks.
  // The rows a thread loads are fixed, so their (cube, position) is too.
  int a_row[2], a_col[2], a_cube[2], a_pos[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    a_row[i] = c >> 2;
    a_col[i] = (c & 3) * 8;
    const int gm = m0 + a_row[i];
    a_ok[i] = gm < M;
    const int n = a_ok[i] ? gm / P : 0;
    a_cube[i] = n * P;
    a_pos[i] = a_ok[i] ? gm - n * P : 0;
  }
  // B tile, 512 chunks of 8 channels, 2 per thread.  Forward: 32 rows (k)
  // x 16 chunks of 8 n.  dx: 128 rows (n) x 4 chunks of 8 k.
  int b_row[2], b_col[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    b_row[i] = WT ? c >> 2 : c >> 4;
    b_col[i] = WT ? (c & 3) * 8 : (c & 15) * 8;
  }

  const int kchunks = (K + BK - 1) / BK;
  const int iters = S * kchunks;

  auto load_stage = [&](int it, int s) {
    const int slot = it / kchunks;
    const int k0 = (it - slot * kchunks) * BK;
    const int tap = slot_tap ? slot_tap[slot] : slot;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kc = k0 + a_col[i];
      const int src_pos = a_ok[i] ? tab[slot * P + a_pos[i]] : -1;
      const bool ok = src_pos >= 0 && kc < K;
      const __nv_bfloat16* src = x;
      if (ok) src = x + static_cast<size_t>(a_cube[i] + src_pos) * K + kc;
      cp_async16(&As[s][a_row[i]][a_col[i]], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kc = k0 + (WT ? b_col[i] : b_row[i]);
      const int nc = n0 + (WT ? b_row[i] : b_col[i]);
      const bool ok = kc < K && nc < N;
      const __nv_bfloat16* src = w;
      if (ok) {
        src = WT ? w + (static_cast<size_t>(tap) * N + nc) * K + kc
                 : w + (static_cast<size_t>(tap) * K + kc) * N + nc;
      }
      cp_async16(&Bs[s][b_row[i]][b_col[i]], src, ok);
    }
  };

  using BLayout = typename std::conditional<WT, col_major, row_major>::type;
  fragment<accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);

  load_stage(0, 0);
  cp_async_commit();
  for (int it = 0; it < iters; ++it) {
    const int s = it & 1;
    if (it + 1 < iters) load_stage(it + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // the group that filled stage s has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      fragment<matrix_a, 16, 16, 16, __nv_bfloat16, row_major> a[2];
      fragment<matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        nvcuda::wmma::load_matrix_sync(a[i], &As[s][warp_m * 32 + i * 16][kk], A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* bp = WT ? &Bs[s][warp_n * 64 + j * 16][kk]
                                     : &Bs[s][kk][warp_n * 64 + j * 16];
        nvcuda::wmma::load_matrix_sync(b[j], bp, B_LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) nvcuda::wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // stage s is refilled at the top of the next iteration
  }

  // Epilogue: the A ring is free now (the loop ended on a barrier and no
  // copy is in flight), so each warp stages its 16x16 f32 tiles there; a
  // lane adds the bias to 8 consecutive channels of one row, rounds them to
  // bf16 once and stores them as one 16-byte word.
  float(*Cs)[16][16] = reinterpret_cast<float(*)[16][16]>(&As[0][0][0]);
  const int r = lane / 2;
  const int c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      nvcuda::wmma::store_matrix_sync(&Cs[warp][0][0], acc[i][j], 16, mem_row_major);
      __syncwarp();
      const int gm = m0 + warp_m * 32 + i * 16 + r;
      const int gn = n0 + warp_n * 64 + j * 16 + c0;
      if (gm < M && gn < N) {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float bv = bias ? __bfloat162float(bias[gn + e]) : 0.0f;
          v[e] = __float2bfloat16(Cs[warp][r][c0 + e] + bv);
        }
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(gm) * N + gn) =
            *reinterpret_cast<const uint4*>(v);
      }
      __syncwarp();
    }
  }
}

// ---- f32: plain FMAs ------------------------------------------------------

constexpr int FM = 64;
constexpr int FN = 64;
constexpr int FK = 16;

template <bool WT>
__global__ void __launch_bounds__(THREADS)
    cube_conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, const int* __restrict__ tab,
                     const int* __restrict__ slot_tap, float* __restrict__ out, int M, int P,
                     int S, int K, int N) {
  __shared__ float As[FK][FM + 4];  // k-major, so a thread's 4 rows are adjacent
  __shared__ float Bs[FK][FN + 4];

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // output rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // output cols tx*4 .. tx*4+3
  const int m0 = blockIdx.y * FM;
  const int n0 = blockIdx.x * FN;

  // A loads: element e = tid + i*256 of the 64x16 tile is row e/16, channel
  // e%16 (16 neighbouring threads read 16 neighbouring channels).
  int a_cube[4], a_pos[4];
  bool a_ok[4];
  const int a_k = tid % FK;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + tid / FK + i * (THREADS / FK);
    a_ok[i] = gm < M;
    const int n = a_ok[i] ? gm / P : 0;
    a_cube[i] = n * P;
    a_pos[i] = a_ok[i] ? gm - n * P : 0;
  }

  float acc[4][4] = {};
  const int kchunks = (K + FK - 1) / FK;
  for (int it = 0; it < S * kchunks; ++it) {
    const int slot = it / kchunks;
    const int k0 = (it - slot * kchunks) * FK;
    const int tap = slot_tap ? slot_tap[slot] : slot;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kc = k0 + a_k;
      float v = 0.0f;
      const int src_pos = a_ok[i] ? tab[slot * P + a_pos[i]] : -1;
      if (src_pos >= 0 && kc < K) v = x[static_cast<size_t>(a_cube[i] + src_pos) * K + kc];
      As[a_k][tid / FK + i * (THREADS / FK)] = v;
    }
    // B loads: forward reads 64 neighbouring n of one k row; dx reads 16
    // neighbouring k of one n row (the transposed kernel's contiguous axis).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * THREADS;
      const int kk = WT ? e % FK : e / FN;
      const int col = WT ? e / FK : e % FN;
      const int kc = k0 + kk;
      const int nc = n0 + col;
      float v = 0.0f;
      if (kc < K && nc < N) {
        v = WT ? w[(static_cast<size_t>(tap) * N + nc) * K + kc]
               : w[(static_cast<size_t>(tap) * K + kc) * N + nc];
      }
      Bs[kk][col] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) out[static_cast<size_t>(gm) * N + gn] = acc[i][j] + (bias ? bias[gn] : 0.0f);
    }
  }
}

template <bool WT>
int launch(const void* x, const void* w, const void* bias, const void* tab, const void* slot_tap,
           void* out, int M, int P, int S, int K, int N, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tab);
  const int* st_tap = static_cast<const int*>(slot_tap);
  if (is_bf16) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    cube_conv3x3_bf16<WT><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(bias), t, st_tap, static_cast<__nv_bfloat16*>(out), M,
        P, S, K, N);
  } else {
    dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    cube_conv3x3_f32<WT><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), t, st_tap, static_cast<float*>(out), M, P, S, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward: x [M, Cin], w [9, Cin, Cout], bias [Cout], tab [9, P] -> out [M, Cout].
extern "C" int cp360_cube_conv3x3(const void* x, const void* w, const void* bias,
                                  const void* tab, void* out, int M, int P, int Cin,
                                  int Cout, int is_bf16, void* stream) {
  return launch<false>(x, w, bias, tab, nullptr, out, M, P, 9, Cin, Cout, is_bf16, stream);
}

// Input gradient: dy [M, Cout], w [9, Cin, Cout], tab [S, P] (-1 = none),
// slot_tap [S] -> dx [M, Cin].
extern "C" int cp360_cube_conv3x3_dx(const void* dy, const void* w, const void* tab,
                                     const void* slot_tap, void* dx, int M, int P, int S,
                                     int Cin, int Cout, int is_bf16, void* stream) {
  return launch<true>(dy, w, nullptr, tab, slot_tap, dx, M, P, S, Cout, Cin, is_bf16, stream);
}
