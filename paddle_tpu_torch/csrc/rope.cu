// Rotary position embedding (K6) for Hopper, sm_90a.
//
// Replaces the TPU kernel of paddle_tpu/ops/pallas/rope.py: _rope_call
// (reached through apply_rotary_pallas). The neox half rotation of x
// [B, S, H, D] at rows 0..S-1 of f32 tables cos, sin [S_max, D/2]:
//
//   out1 = x1 * c - sign * x2 * s      x1 = x[..., :D/2], x2 = x[..., D/2:]
//   out2 = x2 * c + sign * x1 * s      c, s = cos[s_pos], sin[s_pos]
//
// in f32, rounded once to x's type (f32 or bf16). sign = +1 rotates;
// sign = -1 applies the transpose, which is the backward: x is then the
// cotangent, and each product is rounded to x's type before the sum, as
// the VJP of the reference's composition does it (each `x1 * c` promotes
// its own copy of bf16 x1 to f32, so each cotangent is rounded back to
// bf16 before the two add). The backward is then the reference's VJP,
// and torch autograd's through the plain composition, bit for bit.
//
// What bounds it on this card: bytes. Six operations per pair of
// elements against 8 (bf16) or 16 (f32) bytes read and written, far below
// the ridge point. At llama_350m's q (8 x 1024 x 16 x 64, bf16) it moves
// 33.6 MB, 0.010 ms at 3.35 TB/s.
//
// Design. The Pallas kernel transposes x to [(B H), S, D] and stages a
// block of table rows per grid step; that is TPU blocking. Here x is
// indexed in place: one thread per (row, j) pair, consecutive threads on
// consecutive j, so the x1 and x2 halves and the table row are each read
// coalesced; the table (S x D/2 f32) stays in L2 across heads. Any S up
// to the table runs (no divisibility condition). The products and sums
// are written with __fmul_rn / __fadd_rn / __fsub_rn: nvcc would
// otherwise contract x1 * c - x2 * s into a fused multiply-add, one f32
// rounding off the plain version, which rounds each product. So the
// output is the plain version's bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

using pt_attn::store;
using pt_attn::to_f32;

constexpr int kThreads = 256;

// v rounded to T and back (the identity for f32)
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T, bool BWD>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ x, const float* __restrict__ cos_t,
            const float* __restrict__ sin_t, T* __restrict__ out,
            int n_pairs, int S, int H, int D2) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_pairs) return;
  const int j = i % D2;
  const int row = i / D2;                 // (b * S + s) * H + h
  const int pos = (row / H) % S;
  const long long base = static_cast<long long>(row) * (2 * D2) + j;
  const float x1 = to_f32(x[base]);
  const float x2 = to_f32(x[base + D2]);
  const float c = __ldg(cos_t + static_cast<long long>(pos) * D2 + j);
  const float s = __ldg(sin_t + static_cast<long long>(pos) * D2 + j);
  float o1, o2;
  if (BWD) {
    const T t{};
    o1 = __fadd_rn(round_to(__fmul_rn(x1, c), t), round_to(__fmul_rn(x2, s), t));
    o2 = __fsub_rn(round_to(__fmul_rn(x2, c), t), round_to(__fmul_rn(x1, s), t));
  } else {
    o1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
    o2 = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
  }
  store(out + base, o1);
  store(out + base + D2, o2);
}

template <typename T>
cudaError_t launch(const void* x, const float* c, const float* s, void* out,
                   int n_pairs, int S, int H, int D2, bool bwd,
                   cudaStream_t st) {
  const int blocks = (n_pairs + kThreads - 1) / kThreads;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (bwd)
    rope_kernel<T, true><<<blocks, kThreads, 0, st>>>(xp, c, s, op, n_pairs,
                                                      S, H, D2);
  else
    rope_kernel<T, false><<<blocks, kThreads, 0, st>>>(xp, c, s, op, n_pairs,
                                                       S, H, D2);
  return cudaGetLastError();
}

}  // namespace

// x, out [B, S, H, D] (dtype 0 = float32, 1 = bfloat16), cos, sin
// [s_max, D/2] float32, S <= s_max, D even, B * S * H * D < 2^31; sign +1
// or -1. Returns a cudaError_t (0 = launched).
extern "C" int rope_launch(const void* x, const void* cos_t, const void* sin_t,
                           void* out, int B, int S, int H, int D, int s_max,
                           int sign, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  if (D <= 0 || D % 2 != 0 || S > s_max || (sign != 1 && sign != -1))
    return cudaErrorInvalidValue;
  const long long pairs = static_cast<long long>(B) * S * H * (D / 2);
  if (2 * pairs >= (1LL << 31)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  const bool bwd = sign < 0;
  const int n = static_cast<int>(pairs);
  if (dtype == 0) return launch<float>(x, c, s, out, n, S, H, D / 2, bwd, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, c, s, out, n, S, H, D / 2, bwd, st);
  return cudaErrorInvalidValue;
}
