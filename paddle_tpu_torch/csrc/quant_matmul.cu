// Int8 x int8 -> int32 matmul with a fused dequantize (K8) for Hopper,
// sm_90a.
//
// Replaces the TPU kernel of paddle_tpu/ops/pallas/quant_matmul.py:
// quantized_matmul (body _qmm_kernel). For int8 x [M, K] and w [K, N]
// (row-major), an f32 scalar sx and f32 per-channel sw [N]:
//
//   acc = x @ w                          exact, int32
//   out = float(acc) * sx * sw[n]        f32, in that order; out's type
//
// The int32 sum is exact (|acc| <= 127^2 K < 2^31 for K < 133,000), the
// conversion rounds to nearest and the two multiplies are written with
// __fmul_rn, so the output equals the plain version's bit for bit.
//
// What bounds it on this card: operations. At Llama-2-7B's gate
// projection with 4096 tokens (4096 x 4096 @ 4096 x 11008) the product is
// 369 G integer operations, 0.19 ms at the int8 tensor-core peak of
// 1979 TOP/s, against 0.26 GB of operands and output (0.08 ms at
// 3.35 TB/s).
//
// Design. One block of 256 threads per 128 x 128 output tile; the TPU
// grid's K axis (an int32 sum carried in VMEM scratch across grid steps)
// becomes a loop inside the block over 64-deep K steps staged in shared
// memory, and the int32 sum stays in registers until the dequantizing
// epilogue, so no int32 matrix reaches device memory. 8 warps of 64 x 32
// run mma.sync m16n8k32 (s8 x s8 -> s32). Its B operand wants four
// K-neighbours of one column in a register, but w is N-contiguous and
// ldmatrix's transpose moves 16-bit elements only, so the w tile is
// transposed byte-wise while it is staged: a thread reads a 4 x 4 byte
// block (four rows of four columns, 32-bit loads) and writes its four
// columns as four 32-bit words with __byte_perm. Shared rows are padded
// to 80 bytes, which keeps the fragment reads free of bank conflicts.
// Tails in M, N and K are masked (zero-filled), so every shape runs;
// wide loads where K is a multiple of 16 and N of 4, byte loads
// elsewhere. Simple first: no cp.async pipelining, no wgmma yet
// (ROADMAP, Queue 1).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_common.cuh"

namespace {

using pt_attn::store;

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

// four bytes of row gk of w from column gn on, zero past the edges
template <bool VEC>
__device__ __forceinline__ uint32_t w_word(const int8_t* __restrict__ w,
                                           int K, int N, int gk, int gn) {
  if (gk >= K) return 0u;
  const long long off = static_cast<long long>(gk) * N + gn;
  if (VEC) return gn < N ? __ldg(reinterpret_cast<const unsigned*>(w + off)) : 0u;
  uint32_t v = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (gn + e < N) v |= static_cast<uint32_t>(static_cast<uint8_t>(w[off + e])) << (8 * e);
  return v;
}

template <typename TO, bool VEC>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ sx, const float* __restrict__ sw,
           TO* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t xs[BM][KPAD];
  __shared__ __align__(16) int8_t ws[BN][KPAD];     // [n][k]
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
    // x tile: 128 rows x 4 chunks of 16 bytes
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 2, kc = (c & 3) * 16;
      const int gm = m0 + row, gk = k0 + kc;
      int8_t* dst = &xs[row][kc];
      if (VEC) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gm < M && gk < K)
          v = __ldg(reinterpret_cast<const uint4*>(
              x + static_cast<long long>(gm) * K + gk));
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          dst[e] = (gm < M && gk + e < K)
                       ? x[static_cast<long long>(gm) * K + gk + e] : int8_t(0);
      }
    }
    // w tile: 16 quads of k x 32 quads of n, each 4 x 4 bytes transposed
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int kq = c >> 5, nq = c & 31;
      const int gk = k0 + 4 * kq, gn = n0 + 4 * nq;
      const uint32_t r0 = w_word<VEC>(w, K, N, gk, gn);
      const uint32_t r1 = w_word<VEC>(w, K, N, gk + 1, gn);
      const uint32_t r2 = w_word<VEC>(w, K, N, gk + 2, gn);
      const uint32_t r3 = w_word<VEC>(w, K, N, gk + 3, gn);
      const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);   // r0b0 r1b0 r0b1 r1b1
      const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
      const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);   // r0b2 r1b2 r0b3 r1b3
      const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
      uint32_t* col = reinterpret_cast<uint32_t*>(&ws[4 * nq][4 * kq]);
      constexpr int kRowWords = KPAD / 4;
      col[0 * kRowWords] = __byte_perm(lo01, lo23, 0x5410);   // column n
      col[1 * kRowWords] = __byte_perm(lo01, lo23, 0x7632);   // n + 1
      col[2 * kRowWords] = __byte_perm(hi01, hi23, 0x5410);   // n + 2
      col[3 * kRowWords] = __byte_perm(hi01, hi23, 0x7632);   // n + 3
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
cudaError_t launch(const int8_t* x, const int8_t* w, const float* sx,
                   const float* sw, void* out, int M, int N, int K, bool vec,
                   cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  TO* o = static_cast<TO*>(out);
  if (vec)
    qmm_kernel<TO, true><<<grid, kThreads, 0, st>>>(x, w, sx, sw, o, M, N, K);
  else
    qmm_kernel<TO, false><<<grid, kThreads, 0, st>>>(x, w, sx, sw, o, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x [M, K], w [K, N] int8 row-major contiguous; sx one float32, sw [N]
// float32; out [M, N] (out_dtype 0 = float32, 1 = bfloat16).
// K < 133,000 keeps the int32 sum exact. Returns a cudaError_t
// (0 = launched).
extern "C" int quant_matmul_launch(const void* x, const void* w,
                                   const void* sx, const void* sw, void* out,
                                   int M, int N, int K, int out_dtype,
                                   void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K < 0 || K >= 133000) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sxp = static_cast<const float*>(sx);
  const auto* swp = static_cast<const float*>(sw);
  const bool vec = K % 16 == 0 && N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) & 3) == 0;
  if (out_dtype == 0)
    return launch<float>(xp, wp, sxp, swp, out, M, N, K, vec, st);
  if (out_dtype == 1)
    return launch<__nv_bfloat16>(xp, wp, sxp, swp, out, M, N, K, vec, st);
  return cudaErrorInvalidValue;
}
