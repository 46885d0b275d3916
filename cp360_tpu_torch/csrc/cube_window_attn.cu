// Window attention on cube faces, Swin's token mixer (ops/cube_window_attn.py):
//
//   out[t_i] = sum_j softmax_j(q_i . k_j / sqrt(32) + B[rel(i, j), h] (+ mask)) v_j
//
// per head h and window, over a window's M x M slots i, j (M*M <= 64).  q, k
// and v are the three C-wide parts of qkv [N*6, S, S, 3C] bf16 (the qkv GEMM's
// output) plus the f32 qkv bias; C = 32 * heads; B is the relative-position
// table [(2M-1)^2, heads] f32 at rel(i, j) = (r_i - r_j + M - 1)(2M - 1) +
// (c_i - c_j + M - 1).  A window's slots come from two tables made once per
// shape: src, int32 [6 * nw, M*M], the flat index of each slot's token in a
// cube's 6 * S * S tokens (for a shifted layer the cube pad's index map, so a
// window at a face's edge reads its out-of-face slots from the neighbouring
// faces in place, with no padded copy); and meta, uint8, bit 0 set for a slot
// of the window's own face, which alone gets an output, and bits 1-4 the
// slot's region in the published roll-and-mask form (has_mask: -100 between
// slots of different regions).
//
// It replaces no TPU kernel: the JAX package has no Swin.
//
// Exactness: q, k and v are bf16(qkv + bias) (the bias added in f32, one
// rounding); the scores are sums of bf16 products in f32 (tensor cores);
// the softmax runs in f32 (exp2 of the scores times log2 e); its numerators
// are rounded to bf16 for the product with v, summed in f32, divided by the
// f32 sum of the unrounded numerators and rounded once to bf16.
// ops/cube_window_attn.py's plain version rounds at the same points, so the
// two differ by the order of the f32 sums and exp2f against exp.
//
// What bounds it on an H100: per window and head, 2 * 49 * 49 * 32 * 2 =
// 307 k operations against q, k and v read (9.4 kB) and the output written
// (3.1 kB): about 24 operations a byte, where the card's tensor cores need
// ~295 (989 TFLOP/s over 3.35 TB/s).  So bytes: each window's q, k and v
// read once as its slots name them (a shifted layer reads a face's tokens
// (S/M + 1)^2 / (S/M)^2 times over, 1.27x at 56x56), its output written
// once.
//
// Design: one block a window and a group of up to 4 heads (one warp a
// head).  The block reads its slots' q, k and v as 16-byte vectors, a head
// group's 4 * 32 channels contiguous, adds the bias and stores them in
// shared memory, q and k row-major with rows of 40 bf16 and v transposed
// with rows of 72 (strides at which the fragment loads below are free of
// bank conflicts), the padding rows and columns to 64 zeroed.  Each warp
// then takes its head's four tiles of 16 query rows in turn: the scores of a
// tile against the 64 key columns are 16 mma.sync m16n8k16 (bf16 in, f32
// accumulators, 32 a thread), the bias, mask and row softmax run on those
// registers (a row's 64 values are spread over the 4 threads of a quad:
// two shuffles for its max and its sum), the numerators are repacked as
// the A operand of P.V in registers (the accumulator layout of two n8 tiles
// is the A layout of one k16 step), and P.V is 16 more mma.sync against
// v^T.  Each tile's outputs overwrite its own q rows; once every warp is
// done, the block writes its own-face slots' outputs as 16-byte vectors.
// Measured at Swin-B's shapes on a batch of 8 (48 faces; CUDA events over
// 50 launches): 0.214 / 0.267 ms at 56x56x128 regular / shifted, 0.110 /
// 0.175 at 28x28x256, 0.055 / 0.126 at 14x14x512, 0.028 at 7x7x1024: 15-22%
// of the bytes bound, against 2.25-0.39 ms for the gather and PyTorch's
// SDPA with the bias as its mask.
//
// C interface, for ctypes: launches on the given stream and returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a shape or a pointer
// it cannot take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int D = 32;           // the head size
constexpr int ROWS = 64;        // a window's slots padded to four m16 tiles
constexpr int QK_STRIDE = 40;   // bf16 a row of q and k in shared memory
constexpr int VT_STRIDE = 72;   // bf16 a row of v^T
constexpr int MAX_T = 225;      // (2M-1)^2 at M = 8
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK = -100.0f;
constexpr int kMaxDevices = 64;

struct HeadSmem {
  __nv_bfloat16 q[ROWS * QK_STRIDE];
  __nv_bfloat16 k[ROWS * QK_STRIDE];
  __nv_bfloat16 vt[D * VT_STRIDE];
};

__device__ __forceinline__ void unpack8(const uint4& v, float* out) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A slot's coordinate in the relative-position table's flat index:
// rel(i, j) = pos(i) - pos(j) + center.
__device__ __forceinline__ int pos_of(int slot, int m) {
  const int r = slot / m;
  return r * (2 * m - 1) + (slot - r * m);
}

template <int HG>
__global__ void __launch_bounds__(32 * HG)
cube_window_attn(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ qkv_bias,
            const float* __restrict__ table, const int* __restrict__ src,
            const uint8_t* __restrict__ meta, __nv_bfloat16* __restrict__ out, int S, int C,
            int heads, int nw, int m, int has_mask) {
  extern __shared__ uint4 smem_raw[];
  HeadSmem* hs = reinterpret_cast<HeadSmem*>(smem_raw);
  float* tab = reinterpret_cast<float*>(hs + HG);  // [HG][T], times log2 e
  int* slot_src = reinterpret_cast<int*>(tab + HG * MAX_T);
  int* slot_pos = slot_src + ROWS;  // pos_of(slot), -1 past the window's slots
  uint8_t* slot_meta = reinterpret_cast<uint8_t*>(slot_pos + ROWS);

  const int m2 = m * m;
  const int T = (2 * m - 1) * (2 * m - 1);
  const int cube = blockIdx.x / (6 * nw);
  const int wi = blockIdx.x - cube * 6 * nw;
  const int h0 = blockIdx.y * HG;
  const int tid = threadIdx.x;
  constexpr int NT = 32 * HG;
  const size_t cube_tokens = size_t(6) * S * S;
  const __nv_bfloat16* base = qkv + size_t(cube) * cube_tokens * 3 * C;

  for (int i = tid; i < ROWS; i += NT) {
    slot_src[i] = i < m2 ? src[size_t(wi) * m2 + i] : 0;
    slot_pos[i] = i < m2 ? pos_of(i, m) : -1;
    slot_meta[i] = i < m2 ? meta[size_t(wi) * m2 + i] : 0;
  }
  for (int i = tid; i < HG * T; i += NT) {
    const int hh = i / T;
    tab[hh * MAX_T + (i - hh * T)] = table[(i - hh * T) * heads + h0 + hh] * LOG2E;
  }
  // zero the padding: q and k rows m2..63, v^T columns m2..71
  const uint32_t zero = 0;
  for (int i = tid; i < HG * (ROWS - m2) * (QK_STRIDE / 2); i += NT) {
    const int hh = i / ((ROWS - m2) * (QK_STRIDE / 2));
    const int w = i - hh * (ROWS - m2) * (QK_STRIDE / 2);
    reinterpret_cast<uint32_t*>(hs[hh].q + m2 * QK_STRIDE)[w] = zero;
    reinterpret_cast<uint32_t*>(hs[hh].k + m2 * QK_STRIDE)[w] = zero;
  }
  for (int i = tid; i < HG * D * (VT_STRIDE - m2); i += NT) {
    const int hh = i / (D * (VT_STRIDE - m2));
    const int w = i - hh * D * (VT_STRIDE - m2);
    const int row = w / (VT_STRIDE - m2);
    hs[hh].vt[row * VT_STRIDE + m2 + (w - row * (VT_STRIDE - m2))] = __float2bfloat16(0.f);
  }
  __syncthreads();

  // q, k and v of the slots: a head is 4 vectors of 8 bf16, a group HG * 4
  constexpr int VPS = HG * 4;
  for (int it = tid; it < m2 * 3 * VPS; it += NT) {
    const int slot = it / (3 * VPS);
    const int rem = it - slot * 3 * VPS;
    const int part = rem / VPS;
    const int vv = rem - part * VPS;
    const int hh = vv >> 2, dv = (vv & 3) * 8;
    const int ch = part * C + (h0 + hh) * D + dv;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(base + size_t(slot_src[slot]) * 3 * C + ch);
    float f[8];
    unpack8(raw, f);
    if (qkv_bias != nullptr) {
      const float4 b0 = *reinterpret_cast<const float4*>(qkv_bias + ch);
      const float4 b1 = *reinterpret_cast<const float4*>(qkv_bias + ch + 4);
      f[0] = __fadd_rn(f[0], b0.x); f[1] = __fadd_rn(f[1], b0.y);
      f[2] = __fadd_rn(f[2], b0.z); f[3] = __fadd_rn(f[3], b0.w);
      f[4] = __fadd_rn(f[4], b1.x); f[5] = __fadd_rn(f[5], b1.y);
      f[6] = __fadd_rn(f[6], b1.z); f[7] = __fadd_rn(f[7], b1.w);
    }
    if (part < 2) {
      uint4 packed;
      packed.x = pack2(f[0], f[1]);
      packed.y = pack2(f[2], f[3]);
      packed.z = pack2(f[4], f[5]);
      packed.w = pack2(f[6], f[7]);
      __nv_bfloat16* row = (part == 0 ? hs[hh].q : hs[hh].k) + slot * QK_STRIDE + dv;
      *reinterpret_cast<uint4*>(row) = packed;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) hs[hh].vt[(dv + j) * VT_STRIDE + slot] = __float2bfloat16(f[j]);
    }
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  HeadSmem& H = hs[warp];
  const float* tb = tab + warp * MAX_T;
  const int center = (m - 1) * (2 * m - 1) + (m - 1);
  const float scale = rsqrtf(float(D)) * LOG2E;
  const float neg_inf = __int_as_float(0xff800000u);

#pragma unroll 1
  for (int mt = 0; mt < 4; ++mt) {
    const int r0 = mt * 16 + g;
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t a[4];
      a[0] = ld32(H.q + r0 * QK_STRIDE + ks * 16 + 2 * t4);
      a[1] = ld32(H.q + (r0 + 8) * QK_STRIDE + ks * 16 + 2 * t4);
      a[2] = ld32(H.q + r0 * QK_STRIDE + ks * 16 + 8 + 2 * t4);
      a[3] = ld32(H.q + (r0 + 8) * QK_STRIDE + ks * 16 + 8 + 2 * t4);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kr = H.k + (nt * 8 + g) * QK_STRIDE + ks * 16 + 2 * t4;
        mma16816(s[nt], a, ld32(kr), ld32(kr + 8));
      }
    }
    // scores in log2 units: scale, bias, mask; padded columns out
    float mx[2] = {neg_inf, neg_inf};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 8 * rr;
      const int rp = max(slot_pos[row], 0) + center;
      const int rl = slot_meta[row] >> 1;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + 2 * t4 + e;  // the thread's key columns
          const int cp = slot_pos[col];
          float v = neg_inf;
          if (cp >= 0) {
            v = fmaf(s[nt][2 * rr + e], scale, tb[rp - cp]);
            if (has_mask && (slot_meta[col] >> 1) != rl) v += MASK * LOG2E;
          }
          s[nt][2 * rr + e] = v;
          mx[rr] = fmaxf(mx[rr], v);
        }
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[nt][2 * rr + e] - mx[rr]);
          s[nt][2 * rr + e] = p;
          sum[rr] += p;
        }
      }
      sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 1);
      sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 2);
    }
    // P.V: the accumulators of n8 tiles 2kk, 2kk+1 are the A fragment of k step kk
    float o[4][4];
#pragma unroll
    for (int nd = 0; nd < 4; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = pack2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < 4; ++nd) {
        const __nv_bfloat16* vr = H.vt + (nd * 8 + g) * VT_STRIDE + kk * 16 + 2 * t4;
        mma16816(o[nd], a, ld32(vr), ld32(vr + 8));
      }
    }
    __syncwarp();
    const float inv0 = 1.f / sum[0], inv1 = 1.f / sum[1];
#pragma unroll
    for (int nd = 0; nd < 4; ++nd) {
      *reinterpret_cast<uint32_t*>(H.q + r0 * QK_STRIDE + nd * 8 + 2 * t4) =
          pack2(o[nd][0] * inv0, o[nd][1] * inv0);
      *reinterpret_cast<uint32_t*>(H.q + (r0 + 8) * QK_STRIDE + nd * 8 + 2 * t4) =
          pack2(o[nd][2] * inv1, o[nd][3] * inv1);
    }
  }
  __syncthreads();

  // the own-face slots' outputs, 16-byte vectors, a head group's channels contiguous
  __nv_bfloat16* obase = out + size_t(cube) * cube_tokens * C;
  for (int it = tid; it < m2 * VPS; it += NT) {
    const int slot = it / VPS;
    if (!(slot_meta[slot] & 1)) continue;
    const int vv = it - slot * VPS;
    const int hh = vv >> 2, dv = (vv & 3) * 8;
    *reinterpret_cast<uint4*>(obase + size_t(slot_src[slot]) * C + (h0 + hh) * D + dv) =
        *reinterpret_cast<const uint4*>(hs[hh].q + slot * QK_STRIDE + dv);
  }
}

template <int HG>
size_t smem_bytes() {
  return HG * sizeof(HeadSmem) + HG * MAX_T * sizeof(float) + 2 * ROWS * sizeof(int) + ROWS;
}

// cudaFuncSetAttribute once per device and instance (blocks of 4 heads take
// more than the default 48 kB of shared memory)
template <int HG>
cudaError_t prepare(int device) {
  static std::atomic<bool> done[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidValue;
  if (done[device].load()) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      cube_window_attn<HG>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_bytes<HG>()));
  if (err == cudaSuccess) done[device].store(true);
  return err;
}

template <int HG>
int launch(const void* qkv, const float* bias, const float* table, const int* src,
           const uint8_t* meta, void* out, int n_cubes, int S, int C, int heads, int nw,
           int m, int has_mask, cudaStream_t stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = prepare<HG>(device);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned(n_cubes) * 6u * unsigned(nw), unsigned(heads / HG));
  cube_window_attn<HG><<<grid, 32 * HG, smem_bytes<HG>(), stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), bias, table, src, meta,
      static_cast<__nv_bfloat16*>(out), S, C, heads, nw, m, has_mask);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int cp360_cube_window_attn(const void* qkv, const void* bias, const void* table,
                                      const void* src, const void* meta, void* out,
                                      int n_cubes, int S, int C, int heads, int nw, int m,
                                      int has_mask, cudaStream_t stream) {
  if (qkv == nullptr || table == nullptr || src == nullptr || meta == nullptr ||
      out == nullptr || n_cubes <= 0 || S <= 0 || heads <= 0 || C != heads * D || nw <= 0 ||
      m <= 0 || m * m > ROWS || (2 * m - 1) * (2 * m - 1) > MAX_T ||
      (reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out)) % 16 ||
      (bias != nullptr && reinterpret_cast<uintptr_t>(bias) % 16))
    return int(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  const float* t = static_cast<const float*>(table);
  const int* s = static_cast<const int*>(src);
  const uint8_t* mt = static_cast<const uint8_t*>(meta);
  if (heads % 4 == 0)
    return launch<4>(qkv, b, t, s, mt, out, n_cubes, S, C, heads, nw, m, has_mask, stream);
  if (heads % 2 == 0)
    return launch<2>(qkv, b, t, s, mt, out, n_cubes, S, C, heads, nw, m, has_mask, stream);
  return launch<1>(qkv, b, t, s, mt, out, n_cubes, S, C, heads, nw, m, has_mask, stream);
}
