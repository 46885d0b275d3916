// Equirectangular -> cube faces: a direct 4-tap bilinear gather.
//
// Replaces the TPU kernels of cp360_tpu/ops/slot_gather.py::apply_plan_pallas
// (_phase1_kernel and _make_phase23_kernel).  Those split the gather into a
// per-row slot gather, a row distribution per conflict layer and a tap
// blend, only because Mosaic allowed gathers within one 128-lane group or
// one 8-row band (and src_w % 128 == 0).  A GPU thread can load any
// address, so one thread per output pixel reads its float source
// coordinates (the in_x / in_y maps of geometry/equi_cube.py), loads its 4
// taps for every channel and blends them.
//
// The arithmetic is that of cp360_tpu/ops/resample.py::_bilinear_gather
// (:55-80) in the same order: floor, clamp of the +1 neighbours and of the
// base tap to the frame, weights (1-fx)(1-fy), fx(1-fy), (1-fx)fy, fx fy,
// and the sum g00 w00 + g01 w01 + g10 w10 + g11 w11 from the left.  A u8
// frame is divided by 255 per tap first, as the all-device stage-1 step
// divides the frame before it samples (pipelines/extract.py::stage1_batch).
// Every operation is an explicitly rounded intrinsic so the compiler fuses
// nothing into an FMA that the plain version does not do.
//
// What bounds it on an H100: bytes.  One 960x1920x3 u8 frame (5.5 MB) in
// and 6x224x224x3 f32 faces (3.6 MB) out take 2.7 us at 3.35 TB/s; the two
// f32 maps (2.4 MB) are shared by every frame of a batch (they stay in the
// 50 MB L2), and the arithmetic is 11 flops per output value.  The taps of neighbouring threads
// are neighbouring pixels of the frame, so the gather stays in L1/L2.
//
// C interface, for ctypes: launches on the given stream and returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float tap(const uint8_t* p) {
  return __fdiv_rn(static_cast<float>(*p), 255.0f);
}

__device__ __forceinline__ float tap(const float* p) { return *p; }

template <typename T>
__global__ void equi_to_cube(const T* __restrict__ src, const float* __restrict__ map_x,
                             const float* __restrict__ map_y, float* __restrict__ out, int N,
                             int H, int W, int C, int FW) {
  const int per_cube = 6 * FW * FW;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(N) * per_cube) return;
  const int n = static_cast<int>(i / per_cube);
  const int pix = static_cast<int>(i - static_cast<long long>(n) * per_cube);

  const float xs = map_x[pix];
  const float ys = map_y[pix];
  const float x0f = floorf(xs);
  const float y0f = floorf(ys);
  const float fx = __fsub_rn(xs, x0f);
  const float fy = __fsub_rn(ys, y0f);
  int x0 = static_cast<int>(x0f);
  int y0 = static_cast<int>(y0f);
  const int x1 = min(max(x0 + 1, 0), W - 1);
  const int y1 = min(max(y0 + 1, 0), H - 1);
  x0 = min(max(x0, 0), W - 1);
  y0 = min(max(y0, 0), H - 1);

  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  const float w00 = __fmul_rn(gx, gy);
  const float w01 = __fmul_rn(fx, gy);
  const float w10 = __fmul_rn(gx, fy);
  const float w11 = __fmul_rn(fx, fy);

  const T* frame = src + static_cast<size_t>(n) * H * W * C;
  const T* p00 = frame + (static_cast<size_t>(y0) * W + x0) * C;
  const T* p01 = frame + (static_cast<size_t>(y0) * W + x1) * C;
  const T* p10 = frame + (static_cast<size_t>(y1) * W + x0) * C;
  const T* p11 = frame + (static_cast<size_t>(y1) * W + x1) * C;
  float* o = out + static_cast<size_t>(i) * C;
  for (int c = 0; c < C; ++c) {
    float v = __fmul_rn(tap(p00 + c), w00);
    v = __fadd_rn(v, __fmul_rn(tap(p01 + c), w01));
    v = __fadd_rn(v, __fmul_rn(tap(p10 + c), w10));
    v = __fadd_rn(v, __fmul_rn(tap(p11 + c), w11));
    o[c] = v;
  }
}

}  // namespace

extern "C" int cp360_equi_to_cube(const void* src, int src_is_u8, const void* map_x,
                                  const void* map_y, void* out, int N, int H, int W, int C,
                                  int FW, void* stream) {
  constexpr int threads = 256;
  const long long total = static_cast<long long>(N) * 6 * FW * FW;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mx = static_cast<const float*>(map_x);
  const float* my = static_cast<const float*>(map_y);
  if (src_is_u8) {
    equi_to_cube<uint8_t><<<blocks, threads, 0, st>>>(static_cast<const uint8_t*>(src), mx, my,
                                                      static_cast<float*>(out), N, H, W, C, FW);
  } else {
    equi_to_cube<float><<<blocks, threads, 0, st>>>(static_cast<const float*>(src), mx, my,
                                                    static_cast<float*>(out), N, H, W, C, FW);
  }
  return static_cast<int>(cudaGetLastError());
}
