// RMSNorm forward and backward (K5a, K5b) for Hopper, sm_90a.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/rms_norm.py:
// _pallas_fwd (K5a) and _pallas_bwd (K5b). Same functions, f32 math:
//
//   forward   out = x * rsqrt(mean(x^2) + eps) * w        per row, x's type
//   backward  xhat = x * rstd, gw = g * w
//             dx = rstd * (gw - xhat * mean(gw * xhat))   per row, x's type
//             dw = sum over every row of g * xhat         in f32, w's type
//
// Layouts (row-major, contiguous): x, g, out, dx [rows, d]; w, dw [d];
// f32 or bf16, w of x's type; d a multiple of 8.
//
// What bounds it on this card: bytes. Each element costs a handful of
// operations against 2 (bf16) or 4 (f32) bytes read or written, two orders
// of magnitude below the ridge point. At llama_350m's shape (8192 rows of
// 1024, bf16) the forward moves 33.6 MB, 0.010 ms at 3.35 TB/s.
//
// Design. One block per row (forward): each thread holds NCH 16-byte
// chunks of the row in registers, so x is read once; the sum of squares is
// a block reduction. Backward: the Pallas kernel carries dw across its
// sequential grid in VMEM scratch; blocks here run in no order, so each
// of nb blocks walks rows blockIdx.x, blockIdx.x + nb, ... and keeps its
// columns' share of dw in registers, writes it as one f32 row of a
// [nb, d] partial-sum buffer, and a second kernel sums the nb rows of each
// column in a fixed order. No float atomics: dw is the same bit for bit
// from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

using pt_attn::load16;
using pt_attn::store;
using pt_attn::warp_sum;

constexpr int kMaxThreads = 256;

__device__ __forceinline__ void store16(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* x) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// Sum of v over the block, the same value (same order) in every thread.
// blockDim.x is a multiple of 32.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[kMaxThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += part[w];
  __syncthreads();   // part is reused by the next call
  return s;
}

// this thread's c-th chunk of a row: index in 16-byte chunks, or -1
__device__ __forceinline__ int chunk(int c, int nch) {
  const int ch = threadIdx.x + c * static_cast<int>(blockDim.x);
  return ch < nch ? ch : -1;
}

template <typename T, int NCH>
__global__ void __launch_bounds__(kMaxThreads)
rms_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int nch = d / VEC;
  const long long row = static_cast<long long>(blockIdx.x) * d;
  float xv[NCH][VEC];
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int ch = chunk(c, nch);
    if (ch >= 0) {
      load16(x + row + ch * VEC, xv[c]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) xv[c][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss += xv[c][e] * xv[c][e];
  }
  const float rstd = rsqrtf(block_sum(ss) / d + eps);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int ch = chunk(c, nch);
    if (ch < 0) continue;
    float wv[VEC], y[VEC];
    load16(w + ch * VEC, wv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) y[e] = xv[c][e] * rstd * wv[e];
    store16(out + row + ch * VEC, y);
  }
}

template <typename T, int NCH>
__global__ void __launch_bounds__(kMaxThreads)
rms_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ g, T* __restrict__ dx,
               float* __restrict__ dw_part, int rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int nch = d / VEC;
  float wv[NCH][VEC], dwa[NCH][VEC];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int ch = chunk(c, nch);
#pragma unroll
    for (int e = 0; e < VEC; ++e) dwa[c][e] = wv[c][e] = 0.f;
    if (ch >= 0) load16(w + ch * VEC, wv[c]);
  }
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const long long row = static_cast<long long>(r) * d;
    float xv[NCH][VEC], gv[NCH][VEC];
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int ch = chunk(c, nch);
#pragma unroll
      for (int e = 0; e < VEC; ++e) xv[c][e] = gv[c][e] = 0.f;
      if (ch >= 0) {
        load16(x + row + ch * VEC, xv[c]);
        load16(g + row + ch * VEC, gv[c]);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss += xv[c][e] * xv[c][e];
    }
    const float rstd = rsqrtf(block_sum(ss) / d + eps);
    float dot = 0.f;   // sum of gw * xhat; xv becomes xhat
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        xv[c][e] *= rstd;
        dot += gv[c][e] * wv[c][e] * xv[c][e];
      }
    }
    const float mean_gx = block_sum(dot) / d;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int ch = chunk(c, nch);
      if (ch < 0) continue;
      float y[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        y[e] = rstd * (gv[c][e] * wv[c][e] - xv[c][e] * mean_gx);
        dwa[c][e] += gv[c][e] * xv[c][e];
      }
      store16(dx + row + ch * VEC, y);
    }
  }
  float* part = dw_part + static_cast<long long>(blockIdx.x) * d;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int ch = chunk(c, nch);
    if (ch < 0) continue;
#pragma unroll
    for (int e = 0; e < VEC; e += 4) store16(part + ch * VEC + e, dwa[c] + e);
  }
}

// dw[j] = sum over b of part[b][j], b in order
template <typename T>
__global__ void rms_dw_reduce_kernel(const float* __restrict__ part, int nb,
                                     int d, T* __restrict__ dw) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  float s = 0.f;
  for (int b = 0; b < nb; ++b) s += part[static_cast<long long>(b) * d + j];
  store(dw + j, s);
}

// threads per block and 16-byte chunks per thread for a row of d elements
template <typename T>
bool shape(int d, int* threads, int* nch_per_thread) {
  constexpr int VEC = 16 / sizeof(T);
  const int nch = d / VEC;
  int t = ((nch + 31) / 32) * 32;
  if (t > kMaxThreads) t = kMaxThreads;
  const int per = (nch + t - 1) / t;
  *threads = t;
  *nch_per_thread = per <= 1 ? 1 : per <= 2 ? 2 : per <= 4 ? 4 : per <= 8 ? 8
                                                                          : 0;
  return *nch_per_thread != 0;
}

template <typename T>
cudaError_t fwd(const void* x, const void* w, void* out, int rows, int d,
                float eps, cudaStream_t st) {
  int threads, per;
  if (!shape<T>(d, &threads, &per)) return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  switch (per) {
    case 1:
      rms_fwd_kernel<T, 1><<<rows, threads, 0, st>>>(xp, wp, op, d, eps);
      break;
    case 2:
      rms_fwd_kernel<T, 2><<<rows, threads, 0, st>>>(xp, wp, op, d, eps);
      break;
    case 4:
      rms_fwd_kernel<T, 4><<<rows, threads, 0, st>>>(xp, wp, op, d, eps);
      break;
    default:
      rms_fwd_kernel<T, 8><<<rows, threads, 0, st>>>(xp, wp, op, d, eps);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const void* w, const void* g, void* dx,
                void* dw, float* part, int rows, int d, int nb, float eps,
                cudaStream_t st) {
  int threads, per;
  if (!shape<T>(d, &threads, &per)) return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  switch (per) {
    case 1:
      rms_bwd_kernel<T, 1><<<nb, threads, 0, st>>>(xp, wp, gp, dxp, part,
                                                   rows, d, eps);
      break;
    case 2:
      rms_bwd_kernel<T, 2><<<nb, threads, 0, st>>>(xp, wp, gp, dxp, part,
                                                   rows, d, eps);
      break;
    case 4:
      rms_bwd_kernel<T, 4><<<nb, threads, 0, st>>>(xp, wp, gp, dxp, part,
                                                   rows, d, eps);
      break;
    default:
      rms_bwd_kernel<T, 8><<<nb, threads, 0, st>>>(xp, wp, gp, dxp, part,
                                                   rows, d, eps);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rms_dw_reduce_kernel<T><<<(d + 255) / 256, 256, 0, st>>>(
      part, nb, d, static_cast<T*>(dw));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int rms_norm_fwd_launch(const void* x, const void* w, void* out,
                                   int rows, int d, int dtype, float eps,
                                   void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (d <= 0 || d % 8 != 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, w, out, rows, d, eps, st);
  if (dtype == 1) return fwd<__nv_bfloat16>(x, w, out, rows, d, eps, st);
  return cudaErrorInvalidValue;
}

// dw_part: f32 scratch of nb * d elements, 1 <= nb <= rows.
extern "C" int rms_norm_bwd_launch(const void* x, const void* w,
                                   const void* g, void* dx, void* dw,
                                   void* dw_part, int rows, int d, int nb,
                                   int dtype, float eps, void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (d <= 0 || d % 8 != 0 || nb <= 0 || nb > rows)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(dw_part);
  if (dtype == 0) return bwd<float>(x, w, g, dx, dw, part, rows, d, nb, eps, st);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(x, w, g, dx, dw, part, rows, d, nb, eps, st);
  return cudaErrorInvalidValue;
}
