// The ResNet stem's cube-padded 3x3 / stride-2 max pool:
// max_pool(cube_pad(x, 1), 3, stride 2) on [N, 6, H, W, C] NHWC faces
// (H = W, even) -> [N, 6, H/2, W/2, C], in bf16 or f32.
//
// Replaces the TPU kernels of tools/bench_pool_pallas.py: make_pool_interior
// (K3a) and make_pool_interior_rowgrid (K3b), with the halo max of
// make_full_op (cp360_tpu/ops/cube_pad.py::_pool_halo_strips_slice).  Those
// pooled the -inf top/left padded interior with reshapes, lane folds and
// sublane rolls only because Mosaic refused strided slices and minor-dim
// reshapes; then output row 0 and column 0 took a max with the windowed
// halo strips.  A GPU thread can load any address, so here one thread
// computes one output pixel for 16 bytes of channels (8 in bf16, 4 in f32)
// and reads its 9 window cells directly:
//
//   cell (a, b) of output (i, j) sits at padded position (2i+a, 2j+b);
//   padded row >= 1 and column >= 1: the face's own pixel (row-1, col-1);
//   padded row 0: row0[f][col], from the cube pad's index map m[f, 0, 0..W];
//   padded column 0: col0[f][row], from the map's m[f, 0..H, 0]
// (one int32 table, built by ops/cube_pool.py::halo_table).
// The corner (0, 0) is the map's edge replication (_corner).  For even H
// the bottom and right halos are never read (cube_pad.py:522-526).
//
// Exactness: the cells are scanned in the padded window's row-major order
// with the update `v > m || isnan(v)` from -inf, the rule and order of
// PyTorch's max_pool2d, so NaN propagates (fmaxf and __hmax would drop it),
// +-inf pass through, and the result equals the plain cube pad +
// F.max_pool2d bit for bit.  bf16 values compare as f32 (exact) and the
// winner's bits are stored back unchanged.
//
// What bounds it on an H100: bytes.  At bf16 [8,6,112,112,64] the faces
// (77.1 MB) are read once and the pooled faces (19.3 MB) written once:
// 96.3 MB, 0.029 ms at 3.35 TB/s; 8 compares per output value are far
// below any compute bound.  Neighbouring threads read neighbouring 16-byte
// chunks of one pixel's channels, and the overlapping windows (each input
// pixel is read by up to 4 outputs) are served from L1/L2.
//
// C interface, for ctypes: launches on the given stream and returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ void load_f32(const uint4& v, float* out) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}

// bf16 -> f32 is a shift of the bits: exact, NaN payloads kept.
__device__ __forceinline__ void load_bf16(const uint4& v, float* out) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[2 * k] = __uint_as_float(w[k] << 16);
    out[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint4 store_bf16(const float* m) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = (__float_as_uint(m[2 * k]) >> 16) | (__float_as_uint(m[2 * k + 1]) & 0xFFFF0000u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// IS_BF16: 8 bf16 channels per 16-byte vector, else 4 f32.
template <bool IS_BF16>
__global__ void cube_pool3x3s2(const uint4* __restrict__ x, const int* __restrict__ halo,
                               uint4* __restrict__ out, int N, int H, int CV) {
  constexpr int VEC = IS_BF16 ? 8 : 4;
  const int HO = H / 2;
  const long long total = static_cast<long long>(N) * 6 * HO * HO * CV;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int cv = static_cast<int>(t % CV);
  long long p = t / CV;
  const int j = static_cast<int>(p % HO);
  p /= HO;
  const int i = static_cast<int>(p % HO);
  p /= HO;
  const int f = static_cast<int>(p % 6);
  const long long n = p / 6;

  const long long face_px = static_cast<long long>(H) * H;
  const uint4* xb = x + n * 6 * face_px * CV + cv;  // this item's pixel 0, chunk cv
  const int* row0 = halo + f * (H + 1);            // padded row 0, columns 0..W
  const int* col0 = halo + 6 * (H + 1) + f * (H + 1);  // padded column 0, rows 0..H

  float m[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) m[k] = __int_as_float(0xff800000);  // -inf

#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int pr = 2 * i + a;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int pc = 2 * j + b;
      long long src;
      if (pr >= 1 && pc >= 1) {
        src = f * face_px + static_cast<long long>(pr - 1) * H + (pc - 1);
      } else if (pr == 0) {
        src = row0[pc];
      } else {
        src = col0[pr];
      }
      const uint4 v = xb[src * CV];
      float e[VEC];
      if constexpr (IS_BF16) {
        load_bf16(v, e);
      } else {
        load_f32(v, e);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if (e[k] > m[k] || isnan(e[k])) m[k] = e[k];
      }
    }
  }

  uint4 r;
  if constexpr (IS_BF16) {
    r = store_bf16(m);
  } else {
    r = make_uint4(__float_as_uint(m[0]), __float_as_uint(m[1]), __float_as_uint(m[2]),
                   __float_as_uint(m[3]));
  }
  out[t] = r;
}

}  // namespace

extern "C" int cp360_cube_pool3x3s2(const void* x, int is_bf16, const void* halo, void* out,
                                    int N, int H, int C, void* stream) {
  constexpr int threads = 256;
  const int vec = is_bf16 ? 8 : 4;
  const int CV = C / vec;
  const long long total = static_cast<long long>(N) * 6 * (H / 2) * (H / 2) * CV;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* xv = static_cast<const uint4*>(x);
  const int* hv = static_cast<const int*>(halo);
  uint4* ov = static_cast<uint4*>(out);
  if (is_bf16) {
    cube_pool3x3s2<true><<<blocks, threads, 0, st>>>(xv, hv, ov, N, H, CV);
  } else {
    cube_pool3x3s2<false><<<blocks, threads, 0, st>>>(xv, hv, ov, N, H, CV);
  }
  return static_cast<int>(cudaGetLastError());
}
