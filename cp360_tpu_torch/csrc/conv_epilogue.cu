// The epilogue of every backbone conv: the inference batch norm after it,
// its bias, the block's residual and the activation as one pass,
//
//   y = act(((x + conv_bias) * scale + shift) + residual)
//
// over an NHWC tensor [..., C] in bf16 or f32: x the conv's output;
// conv_bias (VGG16's), scale and shift per-channel f32 vectors, each
// optional (a missing one is skipped: a batch norm gives scale and shift,
// a conv without one its bias as shift); residual optional, of x's shape
// and dtype; act ReLU, ReLU6 or none.
//
// Before, the trunk ran these as separate passes over each conv's output:
// VGG's bias add, an f32 batch norm (a cast up, a multiply, an add, a cast
// down), the residual add and the ReLU.  Here one pass reads x (and the
// residual) once and writes y once.
//
// Exactness: every step is one f32 operation in the order above, rounded
// to nearest (__fadd_rn, __fmul_rn: never contracted into an FMA), then
// the activation, then one rounding to the storage dtype (round to nearest
// even).  That is what ops/conv_epilogue.py's plain version computes with
// PyTorch's elementwise ops, so the two agree bit for bit; in f32 it is
// the explicit conv -> batch norm -> residual -> ReLU chain operation for
// operation.  The activations let NaN through as torch.relu and
// torch.clamp do (`v < 0 ? 0 : v`).
//
// What bounds it on an H100: bytes.  At VGG16-BN's first conv of a batch
// of 8 (bf16 [48,224,224,64], 154 M values) it reads and writes 2 B a
// value: 617 MB, 0.18 ms at 3.35 TB/s; a residual adds 2 B a value.  Four
// f32 operations and a compare a value are far below any compute bound,
// and the per-channel vectors stay in L1.  One thread moves 16 bytes of
// channels (8 bf16 or 4 f32): C * itemsize is a multiple of 16 and every
// pointer 16-byte aligned, as every backbone's conv outputs are (the
// wrapper refuses anything else).
//
// C interface, for ctypes: launches on the given stream and returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a C or a pointer
// the 16-byte vectors cannot take).  out may equal x (in place: each value is read
// and written by one thread, so x is not declared __restrict__).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNone = 0;
constexpr int kRelu = 1;
constexpr int kRelu6 = 2;

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == kRelu) {
    return v < 0.f ? 0.f : v;
  } else if constexpr (ACT == kRelu6) {
    return v < 0.f ? 0.f : (v > 6.f ? 6.f : v);
  } else {
    return v;
  }
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The channel vector of flat vector t in rows of CV vectors: 32-bit
// arithmetic where the tensor is small enough (the main path's always are).
__device__ __forceinline__ int channel_of(long long t, int CV, bool small) {
  return small ? static_cast<int>(static_cast<unsigned>(t) % static_cast<unsigned>(CV))
               : static_cast<int>(t % CV);
}

// The per-channel steps of one value, in the order of the header.
__device__ __forceinline__ float affine(float v, const float* __restrict__ pre,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ shift, int c) {
  if (pre != nullptr) v = __fadd_rn(v, pre[c]);
  if (scale != nullptr) v = __fmul_rn(v, scale[c]);
  if (shift != nullptr) v = __fadd_rn(v, shift[c]);
  return v;
}

// One 16-byte vector of VEC = 16 / sizeof(T) channels a thread.
template <typename T, int ACT, bool RES>
__global__ void epilogue(const uint4* x, const float* __restrict__ pre,
                         const float* __restrict__ scale, const float* __restrict__ shift,
                         const uint4* __restrict__ res, uint4* out, long long n_vec, int CV) {
  constexpr int VEC = 16 / sizeof(T);
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_vec) return;
  const int c0 = channel_of(t, CV, n_vec <= 0xFFFFFFFFll) * VEC;
  const uint4 xv = x[t];
  const T* xs = reinterpret_cast<const T*>(&xv);
  float v[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = affine(to_f32(xs[k]), pre, scale, shift, c0 + k);
  if constexpr (RES) {
    const uint4 rv = res[t];
    const T* rs = reinterpret_cast<const T*>(&rv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = __fadd_rn(v[k], to_f32(rs[k]));
  }
  uint4 ov;
  T* os = reinterpret_cast<T*>(&ov);
#pragma unroll
  for (int k = 0; k < VEC; ++k) os[k] = from_f32<T>(activate<ACT>(v[k]));
  out[t] = ov;
}

// The per-channel vectors of one call.
struct Channels {
  const float* pre;
  const float* scale;
  const float* shift;
};

template <typename T, int ACT, bool RES>
void launch(const void* x, Channels ch, const void* res, void* out, long long n, int C,
            cudaStream_t st) {
  constexpr int threads = 256;
  constexpr int VEC = 16 / sizeof(T);
  const long long n_vec = n / VEC;
  const unsigned blocks = static_cast<unsigned>((n_vec + threads - 1) / threads);
  epilogue<T, ACT, RES><<<blocks, threads, 0, st>>>(
      static_cast<const uint4*>(x), ch.pre, ch.scale, ch.shift, static_cast<const uint4*>(res),
      static_cast<uint4*>(out), n_vec, C / VEC);
}

template <typename T, int ACT>
void launch_res(const void* x, Channels ch, const void* res, void* out, long long n, int C,
                cudaStream_t st) {
  if (res != nullptr) {
    launch<T, ACT, true>(x, ch, res, out, n, C, st);
  } else {
    launch<T, ACT, false>(x, ch, res, out, n, C, st);
  }
}

template <typename T>
void launch_act(int act, const void* x, Channels ch, const void* res, void* out, long long n,
                int C, cudaStream_t st) {
  if (act == kRelu) {
    launch_res<T, kRelu>(x, ch, res, out, n, C, st);
  } else if (act == kRelu6) {
    launch_res<T, kRelu6>(x, ch, res, out, n, C, st);
  } else {
    launch_res<T, kNone>(x, ch, res, out, n, C, st);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// x, res (or null), out: n values in rows of C channels, contiguous, of
// the dtype is_bf16 names; pre, scale, shift: C f32 values each, or null;
// act 0 none, 1 ReLU, 2 ReLU6.
extern "C" int cp360_conv_epilogue(const void* x, int is_bf16, const void* pre,
                                   const void* scale, const void* shift, const void* res,
                                   void* out, long long n, int C, int act, void* stream) {
  if (n == 0) return 0;
  const int item = is_bf16 ? 2 : 4;
  if ((static_cast<long long>(C) * item) % 16 != 0 || !aligned16(x) || !aligned16(out) ||
      (res != nullptr && !aligned16(res))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Channels ch{static_cast<const float*>(pre), static_cast<const float*>(scale),
                    static_cast<const float*>(shift)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch_act<__nv_bfloat16>(act, x, ch, res, out, n, C, st);
  } else {
    launch_act<float>(act, x, ch, res, out, n, C, st);
  }
  return static_cast<int>(cudaGetLastError());
}
