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
// Both directions are one implicit GEMM over the 9 taps:
//   out[m, n] = bias[n] + sum_{tap<9} sum_{c} A_tap[m, c] * B_tap[c, n]
// with M = N_cubes * P rows (P = 6 * h * w positions of one cube;
// m = cube * P + p) and a depth of 9 * K.
//   - forward: A_tap[m] = x[cube * P + tab[tap, p]] through the [9, P]
//     source table (ops/cube_conv.py::source_table); B_tap = W[tap], the
//     HWIO kernel's [Cin, Cout] slice; K = Cin, N = Cout.
//   - input gradient (dx): the cube-pad map of one tap is not injective (an
//     input pixel q on a face edge feeds up to 3 outputs p of the same tap),
//     so A_tap[m] = sum_{j<3} dy[cube * P + tab3[tap, q, j]] over the
//     [9, P, 3] inverse table (ops/cube_conv.py::dx_tap_table, -1 = none);
//     B_tap = W[tap]^T, read transposed from the same kernel; K = Cout,
//     N = Cin; no bias.  This is the forward's work: 9 taps of products.
//     The 188 (tap, q) pairs per 7x7 cube that have 2 or 3 rows are summed
//     first (dx_row_sums, f32, one rounding) into a small buffer (12 MB at 8
//     windows, beside dy's 18.8 MB in L2); then every A row has one source,
//     a dy row or a summed row (ops/cube_conv.py::dx_gather_tables), and dx
//     runs the forward's loader.
//
// What bounds it on an H100: at the ConvLSTM's widths (Cin 2000/4000,
// Cout 4000, P = 294) and 8 windows a 4000->4000 conv is 677 GFLOP against
// a 288 MB weight stream, so the tensor cores bound it (0.685 ms at 989
// TFLOP/s vs 0.086 ms of weight bytes at 3.35 TB/s); at one window the two
// bounds meet (~0.086 ms each), and the weights must stream once.
//
// What the design does about it (bf16):
//   - warp specialisation: one producer warpgroup (registers lowered with
//     setmaxnreg) fills a 4-stage ring of 128x64 A and 64x256 B tiles; two
//     consumer warpgroups each run wgmma m64n256k16 on 64 of the 128 rows,
//     f32 accumulators in registers; full/empty mbarriers, no __syncthreads
//     in the main loop;
//   - B by TMA from a 3-D tensor map over the [9, Cin, Cout] kernel with the
//     128-byte swizzle: MN-major for the forward (wgmma's transpose bit),
//     K-major for dx.  The map's bounds zero-fill past Cin and Cout, so a
//     ragged tile never reads the next tap's rows;
//   - A gathered by the producer through the table into the same swizzled
//     K-major layout by hand: cp.async 16 B per row chunk (zero-filled for
//     rows past M), so the producer runs up to 4 stages ahead of the
//     consumers (a loader that summed dx's rows in registers would wait on
//     its loads and could not).  Each thread keeps its 8 rows' source
//     offsets and reads the table again only when the tap changes.
//   - tiles walk M fastest, so the blocks in flight share a few W strips and
//     W streams from device memory about once; the grid is persistent (one
//     block per SM striding over the work units), so one unit's epilogue
//     overlaps the next unit's loads;
//   - when the tiles alone fill the card poorly (one window: 3 x 16 tiles),
//     the wrapper splits the depth (9 * ceil(K/64) steps) into `splits`
//     contiguous ranges; each writes f32 partials to a workspace and a second
//     small pass sums them in a fixed order, adds the bias and rounds once.
//     No float atomics: results are bit-identical from run to run.  The
//     count is one per conv shape, never chosen from M, so an output does
//     not depend on the rest of its batch.
// The f32 path (parity only) runs 64x64x16 tiles of plain FMAs.
//
// C interface, for ctypes: every call launches on the given stream and
// returns the cudaError_t of its launches (cudaErrorInvalidValue if the
// tensor map cannot be encoded).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---- bf16: warp-specialised wgmma -----------------------------------------

constexpr int BM = 128;  // rows per tile: two consumer warpgroups x 64
constexpr int BN = 256;  // columns per tile: one m64n256k16 per 16 deep
constexpr int BK = 64;   // depth per stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK * 2;  // 16 KB
constexpr int B_BYTES = BN * BK * 2;  // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// the ring, 2 * STAGES mbarriers, and slack to align the ring to 1024 bytes
// (the 128-byte swizzle repeats every 8 rows of 128 bytes)
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
constexpr int THREADS = 384;  // warpgroups 0 and 1 consume, 2 produces
// 128 * 88 + 256 * 208 = 384 * 168, the launch's 168 registers per thread
constexpr int PRODUCER_REGS = 88;
constexpr int CONSUMER_REGS = 208;
// the full barrier waits for every producer thread and the TMA's bytes
constexpr unsigned FULL_ARRIVALS = 128 + 1;
constexpr unsigned EMPTY_ARRIVALS = 256;  // every consumer thread

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// The barrier counts this thread's arrival once all its earlier cp.async
// copies have landed.
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0)  // 0 bytes read: the 16 are zero-filled
               : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Orders generic-proxy shared-memory writes (the cp.async gathers) with the
// async proxy's reads (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile starting at
// `addr` (1024-byte aligned, or advanced from such a base along K within a
// swizzle row): lbo and sbo in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d[128] += A (64x16, K-major) * B (16x256); TRANS_B = 1 reads B MN-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One work unit: an M tile, an N tile and a contiguous range of the depth's
// steps (tap-major, 64 channels a step).  Units walk M fastest, then N,
// then the depth split.
struct Unit {
  int m0, n0, split, step_begin, step_end;
};

__device__ __forceinline__ Unit unit_of(int u, int tiles_m, int tiles, int steps, int splits) {
  Unit r;
  const int tile = u % tiles;
  r.split = u / tiles;
  r.m0 = (tile % tiles_m) * BM;
  r.n0 = (tile / tiles_m) * BN;
  r.step_begin = r.split * steps / splits;
  r.step_end = (r.split + 1) * steps / splits;
  return r;
}

// lo, hi += the two bf16 values packed in v (lo at the lower address)
__device__ __forceinline__ void add_bf16x2_to_f32(float& lo, float& hi, uint32_t v) {
  lo += __uint_as_float(v << 16);
  hi += __uint_as_float(v & 0xFFFF0000u);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// WT = false: forward.  a = x [M, K]; W [9, K, N] seen by the map as
// {N, K, 9}, B MN-major.  WT = true: dx.  a = dy [M, K]; W [9, N, K] seen
// as {K, N, 9}, B K-major; bias is null.  Row q of A_tap comes through
// tab [9, P]: entry s >= 0 is row cube * P + s of a, -1 a zero row, and
// s <= -2 row cube * E + (-2 - s) of sums [cubes * E, K] (dx's pre-summed
// rows, see dx_row_sums; the forward's table has no such entry).
// splits == 1 writes bf16 out (bias added); splits > 1 writes f32 partials
// ws [splits, M, N] for splitk_reduce.
template <bool WT>
__global__ void __launch_bounds__(THREADS, 1)
    cube_conv3x3_wgmma(const __grid_constant__ CUtensorMap wmap,
                       const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ sums,
                       const __nv_bfloat16* __restrict__ bias, const int* __restrict__ tab,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int M, int P,
                       int E, int K, int N, int splits) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full0 = base + STAGES * STAGE_BYTES;  // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + STAGES * 8;

  const int tiles_m = (M + BM - 1) / BM;
  const int tiles = tiles_m * ((N + BN - 1) / BN);
  const int units = tiles * splits;
  const int kchunks = (K + BK - 1) / BK;
  const int steps = 9 * kchunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, FULL_ARRIVALS);
      mbar_init(empty0 + 8 * s, EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  if (wg == 2) {
    // ---- producer: B by TMA (thread 0), A gathered by all 128 threads.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int col = t % 8;  // this thread's 16-byte chunk of each A row
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit un = unit_of(u, tiles_m, tiles, steps, splits);
      // off[i]: where the source of row t/8 + 16 i of the tile starts, as
      // an element offset into a (>= 0) or sums (-2 - offset), or -1 for a
      // zero row.  Refreshed when the tap changes, so the table is read
      // once per tap, not once per step.
      int off[8];
      for (int it = un.step_begin; it < un.step_end; ++it) {
        const int tap = it / kchunks;
        const int k0 = (it - tap * kchunks) * BK;
        if (it == un.step_begin || k0 == 0) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int gm = un.m0 + t / 8 + 16 * i;
            const int c = gm < M ? gm / P : 0;
            const int src = gm < M ? tab[tap * P + gm - c * P] : -1;
            off[i] = src >= 0 ? (c * P + src) * K : src == -1 ? -1 : -2 - (c * E - 2 - src) * K;
          }
        }
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t full = full0 + 8 * stage;
        const uint32_t sa = base + stage * STAGE_BYTES;
        const uint32_t sb = sa + A_BYTES;
        if (t == 0) {
          mbar_arrive_expect_tx(full, B_BYTES);
          if (WT) {
            tma_load_3d(sb, &wmap, full, k0, un.n0, tap);  // 256 rows (n) x 64 k
          } else {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)  // 4 boxes of 64 rows (k) x 64 n
              tma_load_3d(sb + j * (BK * 128), &wmap, full, un.n0 + 64 * j, k0, tap);
          }
        }
        const int kc = k0 + col * 8;
        const bool k_ok = kc < K;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = t / 8 + 16 * i;
          const bool ok = off[i] != -1 && k_ok;
          const __nv_bfloat16* src = off[i] >= 0 ? a + off[i] : sums + (-2 - off[i]);
          cp_async16(sa + r * 128 + ((col ^ (r & 7)) << 4), ok ? src + kc : a, ok);
        }
        cp_async_arrive_noinc(full);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    // Leave only when the consumers have released every stage: no copy of
    // this block is in flight after it.
    for (int s = 0; s < STAGES; ++s) {
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // ---- consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int warp = t / 32;
    const int lane = t % 32;
    int stage = 0;
    uint32_t phase = 0;
    float d[128];
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit un = unit_of(u, tiles_m, tiles, steps, splits);
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.0f;
      fence_acc(d);
      int prev = -1;
      for (int it = un.step_begin; it < un.step_end; ++it) {
        mbar_wait(full0 + 8 * stage, phase);
        fence_proxy_async();
        const uint32_t sa = base + stage * STAGE_BYTES + wg * (64 * 128);
        const uint32_t sb = base + stage * STAGE_BYTES + A_BYTES;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // A: 8-row groups 1024 bytes apart, k16 = 32 bytes along the row
          const uint64_t da = sw128_desc(sa + 32 * kk, 16, 1024);
          if (WT) {  // B K-major, like A
            wgmma_m64n256k16<0>(d, da, sw128_desc(sb + 32 * kk, 16, 1024));
          } else {  // B MN-major: 64-column blocks 8 KB apart (LBO), 8-k
                    // groups 1024 bytes apart (SBO); k16 = 2048 bytes
            wgmma_m64n256k16<1>(d, da, sw128_desc(sb + 2048 * kk, BK * 128, 1024));
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_acc(d);
        if (prev >= 0) mbar_arrive(empty0 + 8 * prev);  // the previous step is read
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d);
      if (prev >= 0) mbar_arrive(empty0 + 8 * prev);

      // Epilogue.  Register 4 j + 2 h + e of thread (warp, lane) holds row
      // 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e.
      const int row0 = un.m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = un.n0 + 8 * j + 2 * (lane % 4);
        if (c >= N) continue;
        float b0 = 0.0f, b1 = 0.0f;
        if (bias != nullptr && splits == 1) {
          b0 = __bfloat162float(bias[c]);
          b1 = __bfloat162float(bias[c + 1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row >= M) continue;
          const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
          if (splits == 1) {
            *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * N + c) =
                pack_bf16x2(v0 + b0, v1 + b1);
          } else {
            *reinterpret_cast<float2*>(
                ws + (static_cast<size_t>(un.split) * M + row) * N + c) = make_float2(v0, v1);
          }
        }
      }
    }
  }
}

// dx's pre-summed rows: sums[c * E + e] = dy[c * P + rows[e][0]] + ... for
// the (tap, pixel) pairs that several outputs read (rows [E, 3], -1 after
// the last), summed in f32 and rounded once to T; a thread does 8 channels
// in bf16 (K % 8 == 0), one in f32.
template <typename T>
__global__ void dx_row_sums(const T* __restrict__ dy, const int* __restrict__ rows,
                            T* __restrict__ sums, int cubes, int P, int E, int K) {
  constexpr int VEC = sizeof(T) == 2 ? 8 : 1;
  const int chunks = K / VEC;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(cubes) * E * chunks) return;
  const int row = static_cast<int>(idx / chunks);
  const int k0 = static_cast<int>(idx % chunks) * VEC;
  const int c = row / E;
  const int e = row - c * E;
  float f[8] = {};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int r = rows[e * 3 + j];
    if (r < 0) continue;
    const T* src = dy + static_cast<size_t>(c * P + r) * K + k0;
    if constexpr (VEC == 8) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
      add_bf16x2_to_f32(f[0], f[1], v.x);
      add_bf16x2_to_f32(f[2], f[3], v.y);
      add_bf16x2_to_f32(f[4], f[5], v.z);
      add_bf16x2_to_f32(f[6], f[7], v.w);
    } else {
      f[0] += src[0];
    }
  }
  T* dst = sums + static_cast<size_t>(row) * K + k0;
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                                                pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  } else {
    dst[0] = f[0];
  }
}

// out[m, n] = bf16(bias[n] + ws[0][m, n] + ws[1][m, n] + ...), summed in
// split order; 4 neighbouring columns a thread (N % 4 == 0).
__global__ void splitk_reduce(const float* __restrict__ ws, const __nv_bfloat16* __restrict__ bias,
                              __nv_bfloat16* __restrict__ out, int M, int N, int splits) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= total) return;
  float4 s = *reinterpret_cast<const float4*>(ws + i);
  for (int k = 1; k < splits; ++k) {
    const float4 p = *reinterpret_cast<const float4*>(ws + k * total + i);
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  if (bias != nullptr) {
    const int n = static_cast<int>(i % N);
    s.x += __bfloat162float(bias[n]);
    s.y += __bfloat162float(bias[n + 1]);
    s.z += __bfloat162float(bias[n + 2]);
    s.w += __bfloat162float(bias[n + 3]);
  }
  uint2 v;
  v.x = pack_bf16x2(s.x, s.y);
  v.y = pack_bf16x2(s.z, s.w);
  *reinterpret_cast<uint2*>(out + i) = v;
}

// cuTensorMapEncodeTiled, fetched from libcuda through the runtime (no
// -lcuda at link time).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// One call's operands, as the C interface passes them.  rows and sums
// (dx only, E > 0): the pre-summed rows' table and buffer.
struct Operands {
  const void* a;
  const void* w;
  const void* bias;
  const void* tab;
  const void* rows;
  void* sums;
  void* out;
  void* ws;
  int M, P, E, K, N, splits, num_sms;
};

template <bool WT>
int launch_bf16(const Operands& o, cudaStream_t st) {
  // The kernel [9, Cin, Cout] is {inner, outer, 9} with Cout inner: the
  // forward's {N, K, 9} (boxes of 64 n x 64 k), dx's {K, N, 9} (one box of
  // 64 k x 256 n).
  const cuuint64_t inner = WT ? o.K : o.N;
  const cuuint64_t outer = WT ? o.N : o.K;
  const cuuint64_t dims[3] = {inner, outer, 9};
  const cuuint64_t strides[2] = {inner * 2, inner * outer * 2};
  const cuuint32_t box[3] = {64, WT ? 256u : 64u, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(o.w), dims, strides,
             box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      cube_conv3x3_wgmma<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((o.M + BM - 1) / BM) * ((o.N + BN - 1) / BN);
  const int units = tiles * o.splits;
  const int grid = units < o.num_sms ? units : o.num_sms;
  const auto* bias = static_cast<const __nv_bfloat16*>(o.bias);
  auto* out = static_cast<__nv_bfloat16*>(o.out);
  cube_conv3x3_wgmma<WT><<<grid, THREADS, SMEM_BYTES, st>>>(
      map, static_cast<const __nv_bfloat16*>(o.a), static_cast<const __nv_bfloat16*>(o.sums),
      bias, static_cast<const int*>(o.tab), out, static_cast<float*>(o.ws), o.M, o.P, o.E, o.K,
      o.N, o.splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || o.splits == 1) return static_cast<int>(err);
  const size_t quads = static_cast<size_t>(o.M) * o.N / 4;
  splitk_reduce<<<static_cast<unsigned>((quads + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(o.ws), bias, out, o.M, o.N, o.splits);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32: plain FMAs ------------------------------------------------------

constexpr int FM = 64;
constexpr int FN = 64;
constexpr int FK = 16;
constexpr int F_THREADS = 256;

// WT = false: forward, w [9, K, N].  WT = true: dx, w [9, N, K] read
// transposed.  tab and sums as for the bf16 kernel.
template <bool WT>
__global__ void __launch_bounds__(F_THREADS)
    cube_conv3x3_f32(const float* __restrict__ x, const float* __restrict__ sums,
                     const float* __restrict__ w, const float* __restrict__ bias,
                     const int* __restrict__ tab, float* __restrict__ out, int M, int P, int E,
                     int K, int N) {
  __shared__ float As[FK][FM + 4];  // k-major, so a thread's 4 rows are adjacent
  __shared__ float Bs[FK][FN + 4];

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // output rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // output cols tx*4 .. tx*4+3
  const int m0 = blockIdx.y * FM;
  const int n0 = blockIdx.x * FN;

  // A loads: element e = tid + i*256 of the 64x16 tile is row e/16, channel
  // e%16 (16 neighbouring threads read 16 neighbouring channels).
  int a_cube[4], a_pos[4], a_sums[4];
  bool a_ok[4];
  const int a_k = tid % FK;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + tid / FK + i * (F_THREADS / FK);
    a_ok[i] = gm < M;
    const int n = a_ok[i] ? gm / P : 0;
    a_cube[i] = n * P;
    a_sums[i] = n * E;  // this cube's first pre-summed row
    a_pos[i] = a_ok[i] ? gm - n * P : 0;
  }

  float acc[4][4] = {};
  const int kchunks = (K + FK - 1) / FK;
  for (int it = 0; it < 9 * kchunks; ++it) {
    const int tap = it / kchunks;
    const int k0 = (it - tap * kchunks) * FK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kc = k0 + a_k;
      float v = 0.0f;
      const int src = a_ok[i] ? tab[tap * P + a_pos[i]] : -1;
      if (src >= 0 && kc < K) {
        v = x[static_cast<size_t>(a_cube[i] + src) * K + kc];
      } else if (WT && src <= -2 && kc < K) {
        v = sums[static_cast<size_t>(a_sums[i] - 2 - src) * K + kc];
      }
      As[a_k][tid / FK + i * (F_THREADS / FK)] = v;
    }
    // B loads: forward reads 64 neighbouring n of one k row; dx reads 16
    // neighbouring k of one n row (the transposed kernel's contiguous axis).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * F_THREADS;
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
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
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
int launch(const Operands& o, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (WT && o.E > 0) {  // dx: pre-sum the rows that several outputs read
    const size_t threads = static_cast<size_t>(o.M / o.P) * o.E * (is_bf16 ? o.K / 8 : o.K);
    const unsigned blocks = static_cast<unsigned>((threads + 255) / 256);
    if (is_bf16) {
      dx_row_sums<__nv_bfloat16><<<blocks, 256, 0, st>>>(
          static_cast<const __nv_bfloat16*>(o.a), static_cast<const int*>(o.rows),
          static_cast<__nv_bfloat16*>(o.sums), o.M / o.P, o.P, o.E, o.K);
    } else {
      dx_row_sums<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(o.a),
                                                  static_cast<const int*>(o.rows),
                                                  static_cast<float*>(o.sums), o.M / o.P, o.P,
                                                  o.E, o.K);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (is_bf16) return launch_bf16<WT>(o, st);
  dim3 grid((o.N + FN - 1) / FN, (o.M + FM - 1) / FM);
  cube_conv3x3_f32<WT><<<grid, F_THREADS, 0, st>>>(
      static_cast<const float*>(o.a), static_cast<const float*>(o.sums),
      static_cast<const float*>(o.w), static_cast<const float*>(o.bias),
      static_cast<const int*>(o.tab), static_cast<float*>(o.out), o.M, o.P, o.E, o.K, o.N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward: x [M, Cin], w [9, Cin, Cout], bias [Cout], tab [9, P] -> out
// [M, Cout].  bf16 with splits > 1 needs ws, f32 [splits, M, Cout]; f32
// ignores splits, ws and num_sms.
extern "C" int cp360_cube_conv3x3(const void* x, const void* w, const void* bias, const void* tab,
                                  void* out, void* ws, int M, int P, int Cin, int Cout,
                                  int splits, int num_sms, int is_bf16, void* stream) {
  const Operands o{x, w, bias, tab, nullptr, nullptr, out, ws, M, P, 0, Cin, Cout, splits,
                   num_sms};
  return launch<false>(o, is_bf16, stream);
}

// Input gradient: dy [M, Cout], w [9, Cin, Cout], tab [9, P] (-1 none, <= -2
// a pre-summed row), rows [E, 3], sums [M / P * E, Cout] (scratch, dy's
// dtype) -> dx [M, Cin]; ws f32 [splits, M, Cin] as above.
extern "C" int cp360_cube_conv3x3_dx(const void* dy, const void* w, const void* tab,
                                     const void* rows, void* sums, void* dx, void* ws, int M,
                                     int P, int E, int Cin, int Cout, int splits, int num_sms,
                                     int is_bf16, void* stream) {
  const Operands o{dy, w, nullptr, tab, rows, sums, dx, ws, M, P, E, Cout, Cin, splits,
                   num_sms};
  return launch<true>(o, is_bf16, stream);
}
