// Fused GEMM + bias + activation epilogue (K7) for Hopper, sm_90a.
//
// Replaces the TPU kernel of paddle_tpu/ops/pallas/gemm_epilogue.py:
// _gemm_epilogue_pallas (body _mm_kernel). For x [M, K], w [K, N] (both
// row-major) and bias [N] or none:
//
//   out = act(x @ w + bias)      act: none, relu, or gelu (tanh form)
//
// The product accumulates in f32, the bias is added in f32 and the
// activation applied in the epilogue, then the result is rounded once to
// x's type. bf16 runs on the tensor cores (mma.sync m16n8k16, f32
// accumulate: bf16 products are exact in f32). f32 runs SIMT fused
// multiply-adds in full f32 (no TF32), as the TPU kernel dots in f32.
//
// What bounds it on this card: operations. At Llama-2-7B's gate
// projection (4096 x 4096 @ 4096 x 11008, bf16) the product is 369 GFLOP,
// 0.37 ms at 989 TFLOP/s, against 0.15 GB of operands (0.04 ms at
// 3.35 TB/s).
//
// Design. One block of 256 threads per output tile; the TPU grid's K axis
// (a sum carried in VMEM scratch from one grid step to the next) becomes
// a loop inside the block, and the f32 sum stays in registers until the
// epilogue, so neither the pre-activation nor the bias ever reaches
// device memory. bf16: a 128 x 128 tile, 8 warps of 64 x 32, 32-deep K
// steps staged in shared memory. mma.sync wants B by columns (two
// K-neighbours of one n in a register) and w is N-contiguous, so the w
// tile is transposed while it is staged; rows are padded to 40 elements,
// which keeps the fragment reads free of bank conflicts. f32: a 64 x 64
// tile, 4 x 4 outputs a thread, 16-deep K steps. Tails in M, N and K are
// masked (zero-filled), so every shape runs; 16-byte loads where K and N
// are multiples of 8, element loads elsewhere. Simple first: no cp.async
// pipelining and no wgmma yet (ROADMAP, Queue 1).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_common.cuh"

namespace {

using pt_attn::ld32;
using pt_attn::mma_bf16;
using pt_attn::store;
using pt_attn::to_f32;

constexpr int kThreads = 256;

// bf16 tiles
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int KPAD = BK + 8;            // shared row length, elements
constexpr int MT = 4, NT = 4;           // a warp's 64 x 32: m16 / n8 tiles

// f32 tiles
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

template <bool VEC>
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
      if (VEC && gm < M && gk < K) {
        *reinterpret_cast<uint4*>(dst) = __ldg(
            reinterpret_cast<const uint4*>(x + static_cast<long long>(gm) * K + gk));
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gm < M && gk + e < K)
                       ? x[static_cast<long long>(gm) * K + gk + e] : zero;
      }
    }
    // w tile: 32 rows of k x 16 chunks of 8 n, stored transposed
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int kr = c >> 4, nc = (c & 15) * 8;
      const int gk = k0 + kr, gn = n0 + nc;
      __nv_bfloat16 v[8];
      if (VEC && gk < K && gn < N) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(
            w + static_cast<long long>(gk) * N + gn));
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = h[e];
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (gk < K && gn + e < N)
                     ? w[static_cast<long long>(gk) * N + gn + e] : zero;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) ws[nc + e][kr] = v[e];
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x [M, K], w [K, N], out [M, N] row-major contiguous, bias [N] or null,
// all of one type (dtype 0 = float32, 1 = bfloat16); act 0 = none,
// 1 = relu, 2 = gelu (tanh form). Returns a cudaError_t (0 = launched).
extern "C" int gemm_epilogue_launch(const void* x, const void* w,
                                    const void* bias, void* out, int M, int N,
                                    int K, int act, int dtype, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K < 0 || act < 0 || act > 2) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    gemm_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), M, N, K,
        act);
    return cudaGetLastError();
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* bb = static_cast<const __nv_bfloat16*>(bias);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (K % 8 == 0 && N % 8 == 0 && aligned16(x) && aligned16(w))
    gemm_bf16_kernel<true><<<grid, kThreads, 0, st>>>(xb, wb, bb, ob, M, N, K,
                                                      act);
  else
    gemm_bf16_kernel<false><<<grid, kThreads, 0, st>>>(xb, wb, bb, ob, M, N, K,
                                                       act);
  return cudaGetLastError();
}
