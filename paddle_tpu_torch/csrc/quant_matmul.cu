// Int8 x int8 -> int32 matmul with a fused dequantize (K8) for Hopper,
// sm_90a.
//
// Replaces the TPU kernel of paddle_tpu/ops/pallas/quant_matmul.py:
// quantized_matmul (body _qmm_kernel). For int8 x [M, K] (row-major),
// the weight K-major, wt [N, K] (row n is column n of the reference's
// w [K, N]), an f32 scalar sx and f32 per-channel sw [N]:
//
//   acc = x @ wt^T                       exact, int32
//   out = float(acc) * sx * sw[n]        f32, in that order; out's type
//
// The int32 sum is exact (|acc| <= 127^2 K < 2^31 for K < 133,000), the
// conversion rounds to nearest, the two multiplies are written with
// __fmul_rn and the result is rounded once to out's type, so the output
// equals the plain version's (f32, then cast) bit for bit.
//
// What bounds it on this card: operations. At Llama-2-7B's gate
// projection with 4096 tokens (4096 x 4096 @ 4096 x 11008) the product is
// 369 G integer operations, 0.19 ms at the int8 tensor-core peak of
// 1979 TOP/s, against 0.16 GB of operands and f32 output (0.05 ms at
// 3.35 TB/s). Only wgmma reaches the int8 rate, and wgmma takes 8-bit
// operands K-major only (its transpose bit exists for 16-bit types), as
// mma.sync's s8 B fragment wants four K-neighbours in one register. So
// the weight is kept K-major, made once at conversion
// (quantization/qat.py), and neither route transposes anything.
//
// Two routes, chosen by the caller (ops/kernels/quant_matmul.py, route())
// from the shape before the launch:
//
// - wgmma (K a multiple of 16, N of 8, x, wt and out 16-byte aligned:
//   TMA's stride and base rule for int8 rows, and the 16-byte output
//   stores). K7's structure with s8 operands: a 128 x 256 output tile per
//   block of three warpgroups. Warpgroup 0 is the producer: it hands its
//   registers to the consumers (setmaxnreg), and one thread keeps a ring
//   of 4 stages of 128-deep K slices in flight with TMA (x's [128, 128]
//   box and wt's [256, 128], both K-major with the 128-byte swizzle, 48 KB
//   a stage), each stage guarded by a full and an empty mbarrier.
//   Warpgroups 1 and 2 each own 64 rows and run wgmma.mma_async
//   m64n256k32 s8 x s8 -> s32 straight from shared memory, four k32 steps
//   a stage, without .satfinite (the sum is exact). A stage is released
//   as soon as the wgmma group that read it has retired (one group stays
//   in flight). The epilogue dequantizes the int32 accumulators in
//   registers, rounds once to out's type, and writes the tile through the
//   drained ring with 16-byte stores. TMA zero-fills boxes past M, N and
//   K, so no load is masked; stores are. Blocks run in groups of 16 row
//   tiles, so a wave of blocks shares its x rows and wt rows in L2. The
//   tensor maps come from hopper_tma.cuh (cuTensorMapEncodeTiled through
//   the runtime: no -lcuda). Not yet: a persistent grid (one tile's
//   epilogue under the next one's loads) and clusters sharing a TMA
//   multicast.
// - mma.sync (every other shape, e.g. K or N odd): a 128 x 128 tile of 8
//   warps on mma.sync m16n8k32 (s8 x s8 -> s32) over 64-deep K steps. The
//   x and wt tiles are staged as they lie, [m][k] and [n][k] rows, so A
//   and B fragments are both plain 32-bit loads; rows are padded to 80
//   bytes, which keeps the fragment reads free of bank conflicts. Loads are
//   masked at every edge: 16 bytes where K is a multiple of 16 and x and wt
//   are 16-byte aligned, bytes elsewhere. Right, not fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_common.cuh"
#include "hopper_tma.cuh"

namespace {

using pt_attn::pack_bf16;
using pt_attn::smem_u32;
using pt_attn::store;

// --------------------------------------------------- mma.sync route

constexpr int kThreads = 256;
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int KPAD = BK + 16;            // shared row length, bytes
constexpr int MT = 4, NT = 4;            // a warp's 64 x 32: m16 / n8 tiles

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes of row r of a [rows, K] int8 matrix from column k on into
// dst, zero past the edges
template <bool VEC>
__device__ __forceinline__ void stage16(int8_t* dst,
                                        const int8_t* __restrict__ src,
                                        int rows, int K, int r, int k) {
  const long long off = static_cast<long long>(r) * K + k;
  if (VEC) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && k < K)
      v = __ldg(reinterpret_cast<const uint4*>(src + off));
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      dst[e] = (r < rows && k + e < K) ? src[off + e] : int8_t(0);
  }
}

template <typename TO, bool VEC>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
           const float* __restrict__ sx, const float* __restrict__ sw,
           TO* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t xs[BM][KPAD];
  __shared__ __align__(16) int8_t ws[BN][KPAD];     // [n][k], as wt lies
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // both tiles: 128 rows x 4 chunks of 16 bytes
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 2, kc = (c & 3) * 16;
      stage16<VEC>(&xs[row][kc], x, M, K, m0 + row, k0 + kc);
      stage16<VEC>(&ws[row][kc], wt, N, K, n0 + row, k0 + kc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = lds32(&xs[r][kk + 4 * t]);
        a[i][1] = lds32(&xs[r + 8][kk + 4 * t]);
        a[i][2] = lds32(&xs[r][kk + 4 * t + 16]);
        a[i][3] = lds32(&xs[r + 8][kk + 4 * t + 16]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int cn = wn + j * 8 + g;
        const uint32_t b0 = lds32(&ws[cn][kk + 4 * t]);
        const uint32_t b1 = lds32(&ws[cn][kk + 4 * t + 16]);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], a[i], b0, b1);
      }
    }
    __syncthreads();
  }

  // epilogue: c0, c1 at (g, 2t, 2t + 1), c2, c3 at (g + 8, ...)
  const float sxv = *sx;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + wn + j * 8 + 2 * t + h;
      if (col >= N) continue;
      const float swv = sw[col];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = m0 + wm + i * 16 + g + hr * 8;
          if (row < M)
            store(out + static_cast<long long>(row) * N + col,
                  __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * hr + h]),
                                      sxv), swv));
        }
      }
    }
  }
}

template <typename TO>
cudaError_t launch_mma(const int8_t* x, const int8_t* wt, const float* sx,
                       const float* sw, void* out, int M, int N, int K,
                       cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  TO* o = static_cast<TO*>(out);
  if (K % 16 == 0 && pt_tma::aligned16(x) && pt_tma::aligned16(wt))
    qmm_kernel<TO, true><<<grid, kThreads, 0, st>>>(x, wt, sx, sw, o, M, N, K);
  else
    qmm_kernel<TO, false><<<grid, kThreads, 0, st>>>(x, wt, sx, sw, o, M, N,
                                                     K);
  return cudaGetLastError();
}

// ------------------------------------------- wgmma route (s8, TMA-fed)

namespace wg {

constexpr int TM = 128, TN = 256, TK = 128;  // output tile, K slice (bytes)
constexpr int kStages = 4;
constexpr int kConsumers = 2;                // warpgroups of 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kGroupM = 16;                  // row tiles per raster group
constexpr int kAcc = TN / 2;                 // int32 accumulators a thread
constexpr int X_BYTES = TM * TK;             // [128 rows][128 k], K-major
constexpr int W_BYTES = TN * TK;             // [256 rows][128 k], K-major
constexpr int STAGE = X_BYTES + W_BYTES;
constexpr int OP = TN + 8;                   // padded output row, elements
constexpr size_t SMEM = 1024 /* alignment slack */ + kStages * STAGE +
                        2 * kStages * sizeof(uint64_t);
static_assert(X_BYTES % 1024 == 0 && W_BYTES % 1024 == 0,
              "128-byte swizzle atoms are 1024-byte aligned");
static_assert(TM * OP * 4 <= kStages * STAGE,
              "the f32 output tile reuses the ring");

using pt_tma::desc;
using pt_tma::mbar_arrive;
using pt_tma::mbar_expect_tx;
using pt_tma::mbar_init;
using pt_tma::mbar_wait;
using pt_tma::tma_load;

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(int (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A B^T over one k32 step: A (64 x 32) and B (256 x 32), both
// K-major, by descriptor
__device__ __forceinline__ void wgmma_s8(int (&d)[kAcc], uint64_t a,
                                         uint64_t b) {
  asm volatile(
    "{\n"
    ".reg .pred p;\n"
    "setp.ne.b32 p, %130, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
    "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
    "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
    "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
    "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
    "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
    "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
    "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
    "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
    "%127}, "
    "%128, %129, p;\n"
    "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// two neighbouring outputs of a row into the staged tile
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

template <typename TO>
__global__ void __launch_bounds__(kThreads, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 TO* __restrict__ out, int M, int N, int K) {
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
        tma_load(st + X_BYTES, &wmap, kt * TK, n0, &full[s]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int c = wgi - 1;            // this consumer's 64 rows: c * 64 ..
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  int d[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) d[i] = 0;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint32_t xa = smem_u32(smem + s * STAGE + c * 64 * TK);
    const uint32_t wa = smem_u32(smem + s * STAGE + X_BYTES);
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TK / 32; ++kk)
      // 32 k are 32 bytes along a swizzled 128-byte row of either
      // operand; 8-row groups 1024 bytes apart
      wgmma_s8(d, desc(xa + kk * 32, 16, 1024),
               desc(wa + kk * 32, 16, 1024));
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
  TO* sc = reinterpret_cast<TO*>(smem) + c * 64 * OP;
  const float sxv = *sx;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    float s0 = 0.f, s1 = 0.f;
    if (n0 + col < N) {   // N % 8 == 0: col + 1 too
      s0 = __ldg(sw + n0 + col);
      s1 = __ldg(sw + n0 + col + 1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + (lane >> 2) + 8 * h;
      put2(sc + row * OP + col,
           __fmul_rn(__fmul_rn(__int2float_rn(d[4 * j + 2 * h]), sxv), s0),
           __fmul_rn(__fmul_rn(__int2float_rn(d[4 * j + 2 * h + 1]), sxv),
                     s1));
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
  constexpr int CH = 16 / sizeof(TO);          // outputs a 16-byte store
  for (int i = t; i < 64 * (TN / CH); i += 128) {
    const int r = i / (TN / CH), ch = (i % (TN / CH)) * CH;
    const int row = m0 + c * 64 + r, col = n0 + ch;
    if (row < M && col < N)
      *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * N + col) =
          *reinterpret_cast<const uint4*>(sc + r * OP + ch);
  }
}

template <typename TO>
cudaError_t launch(const void* x, const void* wt, const float* sx,
                   const float* sw, void* out, int M, int N, int K,
                   cudaStream_t st) {
  const pt_tma::EncodeTiled enc = pt_tma::encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  // int8 rows read in boxes 128 bytes deep: x [TM, TK], wt [TN, TK]
  CUtensorMap xmap, wmap;
  if (!pt_tma::make_map(enc, &xmap, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M,
                        K, TM, TK) ||
      !pt_tma::make_map(enc, &wmap, wt, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N,
                        K, TN, TK))
    return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>((M + TM - 1) / TM) *
                           ((N + TN - 1) / TN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      qmm_wgmma_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (e != cudaSuccess) return e;
  qmm_wgmma_kernel<TO><<<static_cast<unsigned>(blocks), kThreads, SMEM,
                         st>>>(xmap, wmap, sx, sw, static_cast<TO*>(out), M,
                               N, K);
  return cudaGetLastError();
}

}  // namespace wg

template <typename TO>
cudaError_t launch(const void* x, const void* wt, const float* sx,
                   const float* sw, void* out, int M, int N, int K, int route,
                   cudaStream_t st) {
  if (route == 1) {
    if (K <= 0 || K % 16 != 0 || N % 8 != 0 || !pt_tma::aligned16(x) ||
        !pt_tma::aligned16(wt) || !pt_tma::aligned16(out))
      return cudaErrorInvalidValue;
    return wg::launch<TO>(x, wt, sx, sw, out, M, N, K, st);
  }
  if (route != 0) return cudaErrorInvalidValue;
  return launch_mma<TO>(static_cast<const int8_t*>(x),
                        static_cast<const int8_t*>(wt), sx, sw, out, M, N, K,
                        st);
}

}  // namespace

// x [M, K] and wt [N, K] int8 row-major contiguous (wt K-major: row n is
// output column n's weights); sx one float32, sw [N] float32; out [M, N]
// (out_dtype 0 = float32, 1 = bfloat16). route 0 = mma.sync (any shape),
// 1 = wgmma (K > 0 and a multiple of 16, N a multiple of 8, x, wt and out
// 16-byte aligned; the caller picks it, this checks it). K < 133,000
// keeps the int32 sum exact. Returns a cudaError_t (0 = launched).
extern "C" int quant_matmul_launch(const void* x, const void* wt,
                                   const void* sx, const void* sw, void* out,
                                   int M, int N, int K, int out_dtype,
                                   int route, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K < 0 || K >= 133000) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sxp = static_cast<const float*>(sx);
  const auto* swp = static_cast<const float*>(sw);
  if (out_dtype == 0)
    return launch<float>(x, wt, sxp, swp, out, M, N, K, route, st);
  if (out_dtype == 1)
    return launch<__nv_bfloat16>(x, wt, sxp, swp, out, M, N, K, route, st);
  return cudaErrorInvalidValue;
}
