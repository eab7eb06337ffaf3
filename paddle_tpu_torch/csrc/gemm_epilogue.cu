// Fused GEMM + bias + activation epilogue (K7) for Hopper, sm_90a.
//
// Replaces the TPU kernel of paddle_tpu/ops/pallas/gemm_epilogue.py:
// _mm_kernel, launched by _gemm_epilogue_pallas (pallas_call). For x
// [M, K], w [K, N] (both row-major) and bias [N] or none:
//
//   out = act(x @ w + bias)      act: none, relu, or gelu (tanh form)
//
// The product accumulates in f32, the bias is added in f32 and the
// activation applied in the epilogue, then the result is rounded once to
// x's type; neither the pre-activation nor the bias ever reaches device
// memory. The TPU grid's K axis (a sum carried in VMEM scratch from one
// grid step to the next) becomes a loop inside the block.
//
// What bounds it on this card: operations. At Llama-2-7B's gate
// projection (4096 x 4096 @ 4096 x 11008, bf16) the product is 369 GFLOP,
// 0.37 ms at 989 TFLOP/s, against 0.15 GB of operands (0.04 ms at
// 3.35 TB/s). Only wgmma reaches the bf16 tensor-core rate, and only if
// the operands arrive without the threads' help: so TMA and wgmma.
//
// Three routes, chosen by the caller (ops/kernels/gemm_epilogue.py,
// route()) from the shape before the launch:
//
// - wgmma (bf16, K and N multiples of 8, K >= 8, x, w and out 16-byte
//   aligned: TMA's stride and base rule). A 128 x 256 output tile per
//   block of three warpgroups. Warpgroup 0 is the producer: it hands its
//   registers to the consumers (setmaxnreg), and one thread keeps a ring
//   of 4 stages of 64-deep K slices in flight with TMA (x's [128, 64] box,
//   K-major, and w's [64, 256] as it lies, as four [64, 64] N-major
//   boxes: a 128-byte swizzled box is at most 128 bytes wide), each stage
//   guarded by a full and an empty mbarrier. Warpgroups 1 and 2 each own
//   64 rows and run wgmma.mma_async m64n256k16 bf16 -> f32 straight from
//   shared memory: x as a K-major A operand and w as an MN-major B
//   operand (the transpose bit), so w is never transposed or copied. A
//   stage is released as soon as the wgmma group that read it has
//   retired (one group stays in flight). The epilogue adds the bias and
//   applies the activation to the f32 accumulators in registers, rounds
//   once to bf16, and writes the tile through the drained ring with
//   16-byte stores. TMA zero-fills boxes past M, N and K, so no load is
//   masked; stores are. Blocks run in groups of 16 row tiles, so a wave
//   of blocks shares its x rows and w columns in L2. The tensor maps are
//   built on the host by cuTensorMapEncodeTiled, reached through the
//   runtime's entry-point query, so the library needs no -lcuda (the
//   TMA and mbarrier helpers are hopper_tma.cuh's, shared with K8). Not yet:
//   a persistent grid (one tile's epilogue under the next one's loads)
//   and clusters sharing a TMA multicast.
// - mma.sync (the other bf16 shapes, e.g. K or N odd): the first bf16
//   design, a 128 x 128 tile of 8 warps on mma.sync m16n8k16 with element
//   loads masked at every edge and the w tile transposed while staged.
// - simt (f32): fused multiply-adds in full f32 (no TF32), as the TPU
//   kernel dots in f32; a 64 x 64 tile, 4 x 4 outputs a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_common.cuh"
#include "hopper_tma.cuh"

namespace {

using pt_attn::ld32;
using pt_attn::mma_bf16;
using pt_attn::pack_bf16;
using pt_attn::smem_u32;
using pt_attn::store;
using pt_attn::to_f32;

constexpr int kThreads = 256;

// mma.sync route (bf16)
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int KPAD = BK + 8;            // shared row length, elements
constexpr int MT = 4, NT = 4;           // a warp's 64 x 32: m16 / n8 tiles

// simt route (f32)
constexpr int FM = 64, FN = 64, FK = 16;

__device__ __forceinline__ float activate(float z, int act) {
  if (act == 1) return fmaxf(z, 0.f);
  if (act == 2) {
    const float k0 = 0.7978845608028654f;   // sqrt(2 / pi)
    const float inner = k0 * (z + 0.044715f * (z * z * z));
    return z * (0.5f * (1.f + tanhf(inner)));
  }
  return z;
}

__global__ void __launch_bounds__(kThreads)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int M, int N, int K,
                 int act) {
  __shared__ __align__(16) __nv_bfloat16 xs[BM][KPAD];
  __shared__ __align__(16) __nv_bfloat16 ws[BN][KPAD];   // [n][k]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64;      // warp's rows in the tile
  const int wn = (warp & 3) * 32;       // warp's columns
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: 128 rows x 4 chunks of 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 2, kc = (c & 3) * 8;
      const int gm = m0 + row, gk = k0 + kc;
      __nv_bfloat16* dst = &xs[row][kc];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gm < M && gk + e < K)
                     ? x[static_cast<long long>(gm) * K + gk + e] : zero;
    }
    // w tile: 32 rows of k x 16 chunks of 8 n, stored transposed
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int kr = c >> 4, nc = (c & 15) * 8;
      const int gk = k0 + kr, gn = n0 + nc;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        ws[nc + e][kr] = (gk < K && gn + e < N)
                             ? w[static_cast<long long>(gk) * N + gn + e]
                             : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = ld32(&xs[r][kk + 2 * t]);
        a[i][1] = ld32(&xs[r + 8][kk + 2 * t]);
        a[i][2] = ld32(&xs[r][kk + 2 * t + 8]);
        a[i][3] = ld32(&xs[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int cn = wn + j * 8 + g;
        const uint32_t b0 = ld32(&ws[cn][kk + 2 * t]);
        const uint32_t b1 = ld32(&ws[cn][kk + 2 * t + 8]);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
    __syncthreads();
  }

  // epilogue: c0, c1 at (g, 2t, 2t + 1), c2, c3 at (g + 8, ...)
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + wn + j * 8 + 2 * t + h;
      if (col >= N) continue;
      const float b = bias != nullptr ? to_f32(bias[col]) : 0.f;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = m0 + wm + i * 16 + g + hr * 8;
          if (row < M)
            store(out + static_cast<long long>(row) * N + col,
                  activate(acc[i][j][2 * hr + h] + b, act));
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out,
                int M, int N, int K, int act) {
  __shared__ float xs[FK][FM + 4];     // [k][m]
  __shared__ float ws[FK][FN + 4];     // [k][n]
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kThreads;
      const int row = e >> 4, kc = e & 15;          // x: 64 rows x 16
      const int gm = m0 + row, gk = k0 + kc;
      xs[kc][row] = (gm < M && gk < K) ? x[static_cast<long long>(gm) * K + gk]
                                       : 0.f;
      const int kr = e >> 6, nc = e & 63;            // w: 16 rows x 64
      const int gk2 = k0 + kr, gn = n0 + nc;
      ws[kr][nc] = (gk2 < K && gn < N) ? w[static_cast<long long>(gk2) * N + gn]
                                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx + 16 * j;
    if (col >= N) continue;
    const float b = bias != nullptr ? bias[col] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row < M)
        out[static_cast<long long>(row) * N + col] = activate(acc[i][j] + b, act);
    }
  }
}


// ------------------------------------------- wgmma route (bf16, TMA-fed)

namespace wg {

constexpr int TM = 128, TN = 256, TK = 64;  // output tile, K slice
constexpr int kStages = 4;
constexpr int kConsumers = 2;                // warpgroups of 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kGroupM = 16;                  // row tiles per raster group
constexpr int kAcc = TN / 2;                 // f32 accumulators a thread
constexpr int X_BYTES = TM * TK * 2;         // [128 rows][64 k], 128-byte rows
constexpr int W_BOX = TK * 64 * 2;           // [64 k][64 n], 128-byte rows
constexpr int STAGE = X_BYTES + (TN / 64) * W_BOX;
constexpr int OP = TN + 8;                   // padded output row, elements
constexpr size_t SMEM = 1024 /* alignment slack */ + kStages * STAGE +
                        2 * kStages * sizeof(uint64_t);
static_assert(X_BYTES % 1024 == 0 && W_BOX % 1024 == 0,
              "128-byte swizzle atoms are 1024-byte aligned");
static_assert(TM * OP * 2 <= kStages * STAGE,
              "the output tile reuses the ring");

using pt_tma::desc;
using pt_tma::mbar_arrive;
using pt_tma::mbar_expect_tx;
using pt_tma::mbar_init;
using pt_tma::mbar_wait;
using pt_tma::tma_load;

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A B over one k16 step: A (64 x 16) K-major, B (16 x N) MN-major
// (transpose bit set), both by descriptor
template <int N>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2], uint64_t a,
                                          uint64_t b);
template <>
__device__ __forceinline__ void wgmma_k16<128>(float (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
    "{\n"
    ".reg .pred p;\n"
    "setp.ne.b32 p, %66, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
    "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
    "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
    "%58, %59, %60, %61, %62, %63}, "
    "%64, %65, p, 1, 1, 0, 1;\n"
    "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_k16<256>(float (&d)[128], uint64_t a,
                                              uint64_t b) {
  asm volatile(
    "{\n"
    ".reg .pred p;\n"
    "setp.ne.b32 p, %130, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
    "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
    "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
    "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
    "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
    "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
    "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
    "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
    "%122, %123, %124, %125, %126, %127}, "
    "%128, %129, p, 1, 1, 0, 1;\n"
    "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

__global__ void __launch_bounds__(kThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __nv_bfloat16* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int M, int N, int K,
                  int act) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * STAGE);
  uint64_t* empty = full + kStages;

  // grouped raster: kGroupM row tiles, then the next column
  const int tiles_m = (M + TM - 1) / TM, tiles_n = (N + TN - 1) / TN;
  const int per_group = kGroupM * tiles_n;
  const int bid = blockIdx.x;
  const int first_m = bid / per_group * kGroupM;
  const int gm = tiles_m - first_m < kGroupM ? tiles_m - first_m : kGroupM;
  const int m0 = (first_m + bid % per_group % gm) * TM;
  const int n0 = bid % per_group / gm * TN;
  const int k_tiles = (K + TK - 1) / TK;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {   // producer: registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        unsigned char* st = smem + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
        tma_load(st, &xmap, kt * TK, m0, &full[s]);
#pragma unroll
        for (int b = 0; b < TN / 64; ++b)
          tma_load(st + X_BYTES + b * W_BOX, &wmap, n0 + 64 * b, kt * TK,
                   &full[s]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int c = wgi - 1;            // this consumer's 64 rows: c * 64 ..
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  float d[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) d[i] = 0.f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint32_t xa = smem_u32(smem + s * STAGE + c * 64 * 128);
    const uint32_t wa = smem_u32(smem + s * STAGE + X_BYTES);
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      // x: 16 k are 32 bytes along a swizzled 128-byte row, 8-row groups
      // 1024 bytes apart; w: 16 k are 16 rows of 128 bytes, 8-row groups
      // 1024 bytes apart, each next 64 columns one box (W_BOX) on
      wgmma_k16<TN>(d, desc(xa + kk * 32, 16, 1024),
                    desc(wa + kk * 16 * 128, W_BOX, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_acc(d);
    if (kt > 0) {   // the group that read the previous stage has retired
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(d);
      if (lane == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);
  // every load has landed and both consumers are done with the ring: it
  // takes the output tile
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");

  // epilogue: d[4j + 2h + e] is row 16 warp + lane / 4 + 8h, column
  // 8j + 2 (lane % 4) + e of this warpgroup's 64 x TN
  __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(smem) + c * 64 * OP;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr && n0 + col < N) {   // N % 8 == 0: col + 1 too
      b0 = to_f32(bias[n0 + col]);
      b1 = to_f32(bias[n0 + col + 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + (lane >> 2) + 8 * h;
      *reinterpret_cast<uint32_t*>(sc + row * OP + col) =
          pack_bf16(activate(d[4 * j + 2 * h] + b0, act),
                    activate(d[4 * j + 2 * h + 1] + b1, act));
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
  for (int i = t; i < 64 * (TN / 8); i += 128) {
    const int r = i / (TN / 8), ch = (i % (TN / 8)) * 8;
    const int row = m0 + c * 64 + r, col = n0 + ch;
    if (row < M && col < N)
      *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * N + col) =
          *reinterpret_cast<const uint4*>(sc + r * OP + ch);
  }
}

cudaError_t launch(const void* x, const void* w, const void* bias, void* out,
                   int M, int N, int K, int act, cudaStream_t st) {
  const pt_tma::EncodeTiled enc = pt_tma::encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  // bf16 rows read in boxes 64 wide (128 bytes): x [TM, 64], w [TK, 64]
  CUtensorMap xmap, wmap;
  if (!pt_tma::make_map(enc, &xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        M, K, TM, 64) ||
      !pt_tma::make_map(enc, &wmap, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        K, N, TK, 64))
    return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>((M + TM - 1) / TM) *
                           ((N + TN - 1) / TN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (e != cudaSuccess) return e;
  gemm_wgmma_kernel<<<static_cast<unsigned>(blocks), kThreads, SMEM, st>>>(
      xmap, wmap, static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), M, N, K, act);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// x [M, K], w [K, N], out [M, N] row-major contiguous, bias [N] or null,
// all of one type; act 0 = none, 1 = relu, 2 = gelu (tanh form). route 0 =
// simt (float32), 1 = mma.sync (bfloat16, any shape), 2 = wgmma
// (bfloat16, K >= 8, K and N multiples of 8, x, w and out 16-byte
// aligned; the caller picks it, this checks it). Returns a cudaError_t
// (0 = launched).
extern "C" int gemm_epilogue_launch(const void* x, const void* w,
                                    const void* bias, void* out, int M, int N,
                                    int K, int act, int route, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K < 0 || act < 0 || act > 2) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    gemm_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), M, N, K,
        act);
    return cudaGetLastError();
  }
  if (route == 2) {
    if (K < 8 || K % 8 != 0 || N % 8 != 0 || !pt_tma::aligned16(x) ||
        !pt_tma::aligned16(w) || !pt_tma::aligned16(out))
      return cudaErrorInvalidValue;
    return wg::launch(x, w, bias, out, M, N, K, act, st);
  }
  if (route != 1) return cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  gemm_bf16_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), M, N, K, act);
  return cudaGetLastError();
}
