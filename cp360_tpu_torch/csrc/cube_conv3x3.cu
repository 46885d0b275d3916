// Fused CubePad(1) + 3x3 VALID convolution + bias on cube feature maps.
//
// Replaces the TPU kernel cp360_tpu/ops/pallas_kernels.py::cube_conv3x3
// (pallas_call in _conv_core, body _kernel).  That kernel computed
// out = sum_k A_k (x W_k) with A_k a 0/1 selection matrix, because gathers
// were slow on the TPU; it also rounded the 9 tap sums to bf16 once.  Here
// the cube padding is a gather in the A-tile load instead, and the sum stays
// in f32 until the single rounding at the store.
//
// The product is an implicit GEMM:
//   out[m, co] = bias[co] + sum_{k<9} sum_{ci} x[src(k, m), ci] * W[k, ci, co]
// with M = N * P rows (P = 6 * h * w positions of one cube; m = n * P + p),
// N-dim = Cout and K-dim = 9 * Cin.  src(k, m) = n * P + tab[k * P + p]:
// tab is the [9, P] int32 source table built on the host from the cube-pad
// index map (ops/cube_conv.py::source_table).  x is [M, Cin], W is
// [9, Cin, Cout] (the HWIO kernel flattened), out is [M, Cout], all
// row-major.
//
// What bounds it on an H100: at the ConvLSTM's widths (Cin 2000/4000,
// Cout 4000, P = 294) and 8 windows the products are 677 GFLOP per
// 4000->4000 conv against a 288 MB weight stream, so tensor-core throughput
// bounds it (0.685 ms at 989 TFLOP/s vs 0.086 ms of weight bytes at
// 3.35 TB/s); at one window the two bounds meet (~0.086 ms each).  This
// first version is the simple tiled form: bf16 runs 128x128x32 tiles on
// the tensor cores through WMMA (mma.sync) with a two-stage cp.async ring;
// f32 (the parity path) runs 64x64x16 tiles of plain FMAs.  Faster forms
// (wgmma, TMA, a deeper ring) are later work.
//
// C interface, for ctypes: every call launches on the given stream and
// returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using nvcuda::wmma::accumulator;
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
constexpr int B_LD = BN + 8;  // and spread the rows over the smem banks

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = pred ? 16 : 0;  // 0 bytes read: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Needs Cin % 8 == 0, Cout % 8 == 0 and 16-byte aligned x, w, out (the
// wrapper checks): each cp.async moves 8 channels of one row.
__global__ void __launch_bounds__(THREADS)
    cube_conv3x3_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      const __nv_bfloat16* __restrict__ bias, const int* __restrict__ tab,
                      __nv_bfloat16* __restrict__ out, int M, int P, int Cin, int Cout) {
  __shared__ __align__(128) __nv_bfloat16 As[2][BM][A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BK][B_LD];
  __shared__ __align__(128) float Cs[THREADS / 32][16][16];

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
  // B tile: 32 rows (channels) x 16 chunks of 8 output channels.
  int b_row[2], b_col[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    b_row[i] = c >> 4;
    b_col[i] = (c & 15) * 8;
  }

  const int kchunks = (Cin + BK - 1) / BK;
  const int iters = 9 * kchunks;

  auto load_stage = [&](int it, int s) {
    const int tap = it / kchunks;
    const int ci0 = (it - tap * kchunks) * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ci = ci0 + a_col[i];
      const bool ok = a_ok[i] && ci < Cin;
      const __nv_bfloat16* src = x;
      if (ok) {
        const int row = a_cube[i] + tab[tap * P + a_pos[i]];
        src = x + static_cast<size_t>(row) * Cin + ci;
      }
      cp_async16(&As[s][a_row[i]][a_col[i]], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ci = ci0 + b_row[i];
      const int co = n0 + b_col[i];
      const bool ok = ci < Cin && co < Cout;
      const __nv_bfloat16* src = w;
      if (ok) src = w + (static_cast<size_t>(tap) * Cin + ci) * Cout + co;
      cp_async16(&Bs[s][b_row[i]][b_col[i]], src, ok);
    }
  };

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
      fragment<matrix_b, 16, 16, 16, __nv_bfloat16, row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        nvcuda::wmma::load_matrix_sync(a[i], &As[s][warp_m * 32 + i * 16][kk], A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        nvcuda::wmma::load_matrix_sync(b[j], &Bs[s][kk][warp_n * 64 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) nvcuda::wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // stage s is refilled at the top of the next iteration
  }

  // Epilogue: each warp stages one 16x16 f32 tile at a time; a lane adds
  // the bias to 8 consecutive channels of one row, rounds them to bf16 once
  // and stores them as one 16-byte word.
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
      if (gm < M && gn < Cout) {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __float2bfloat16(Cs[warp][r][c0 + e] + __bfloat162float(bias[gn + e]));
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(gm) * Cout + gn) =
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

__global__ void __launch_bounds__(THREADS)
    cube_conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, const int* __restrict__ tab,
                     float* __restrict__ out, int M, int P, int Cin, int Cout) {
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
  const int kchunks = (Cin + FK - 1) / FK;
  for (int it = 0; it < 9 * kchunks; ++it) {
    const int tap = it / kchunks;
    const int ci0 = (it - tap * kchunks) * FK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ci = ci0 + a_k;
      float v = 0.0f;
      if (a_ok[i] && ci < Cin) {
        const int row = a_cube[i] + tab[tap * P + a_pos[i]];
        v = x[static_cast<size_t>(row) * Cin + ci];
      }
      As[a_k][tid / FK + i * (THREADS / FK)] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * THREADS;
      const int kk = e / FN;
      const int col = e % FN;
      const int ci = ci0 + kk;
      const int co = n0 + col;
      Bs[kk][col] = (ci < Cin && co < Cout)
                        ? w[(static_cast<size_t>(tap) * Cin + ci) * Cout + co]
                        : 0.0f;
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
      if (gn < Cout) out[static_cast<size_t>(gm) * Cout + gn] = acc[i][j] + bias[gn];
    }
  }
}

}  // namespace

extern "C" int cp360_cube_conv3x3(const void* x, const void* w, const void* bias,
                                  const void* tab, void* out, int M, int P, int Cin,
                                  int Cout, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    dim3 grid((Cout + BN - 1) / BN, (M + BM - 1) / BM);
    cube_conv3x3_bf16<<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(bias), static_cast<const int*>(tab),
        static_cast<__nv_bfloat16*>(out), M, P, Cin, Cout);
  } else {
    dim3 grid((Cout + FN - 1) / FN, (M + FM - 1) / FM);
    cube_conv3x3_f32<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<const int*>(tab),
        static_cast<float*>(out), M, P, Cin, Cout);
  }
  return static_cast<int>(cudaGetLastError());
}
