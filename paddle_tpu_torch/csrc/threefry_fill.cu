// jax.random's element-wise draws and dropout on one stream, for Hopper,
// sm_90a (R2).
//
// Replaces what the JAX package draws through jax.random inside its
// functional ops, jnp compositions with no pallas_call:
//   - the Gumbel noise -log(-log(uniform(minval, 1))) in f32
//     (paddle_tpu/nn/functional.py:161-172, gumbel_softmax's noise;
//     jax.random.gumbel);
//   - bernoulli's keep mask, uniform < p (alpha_dropout, :241-254);
//   - dropout (:208-228, and scaled_dot_product_attention's dropout of
//     the attention output, :929-930): keep = uniform(mask shape) <
//     1 - p, then where(keep, v / (1 - p), 0) ("upscale_in_train") or
//     where(keep, v, 0), in v's type; and its gradient, the vjp of the
//     same expression: where(keep, g, 0) / (1 - p), or where(keep, g, 0).
// Dropout never stores its mask: the backward draws it again from the
// saved key, element for element.
//
// Counters are flat indices: element i of a draw of n elements hashes
// (hi(i), lo(i)) (threefry.cuh). Dropout's mask has its own shape — the
// value's, with 1 on every axis not in ``axis`` — so element i of the
// value hashes the flat index of its mask element: the value's index
// decomposed over its shape and recomposed with the mask's strides
// (stride 0 on a broadcast axis).
//
// What bounds it on this card: bytes at dropout's f32 and bf16 sizes
// (the value read once, the result written once; ~60 integer operations
// of hashing an element), operations for the Gumbel draw (two f64 logs
// an element). A
// grid-stride loop of 256-thread blocks; the division is a true f32
// division (__fdiv_rn), rounded once to bf16 or f16, as XLA on the CPU
// computes v / (1 - p) in the reference.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 8192;
constexpr int kMaxRank = 8;
enum : int { kF32 = 0, kBF16 = 1, kF16 = 2 };
enum : int { kKeep = 0, kGumbel = 1 };
enum : int { kScale = 0, kMask = 1, kScaleGrad = 2 };

// the value's shape and, per axis, the mask's flat-index stride (0 where
// the mask broadcasts); rank 0: the mask is the value's shape
struct Bcast {
  int rank;
  long long size[kMaxRank];
  long long mstride[kMaxRank];
};

__device__ __forceinline__ unsigned long long mask_index(
    unsigned long long i, const Bcast& b) {
  if (b.rank == 0) return i;
  unsigned long long m = 0;
  for (int d = b.rank - 1; d >= 0; --d) {
    const unsigned long long sz = static_cast<unsigned long long>(b.size[d]);
    m += (i % sz) * static_cast<unsigned long long>(b.mstride[d]);
    i /= sz;
  }
  return m;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}

__global__ void __launch_bounds__(kThreads)
fill_kernel(uint32_t k0, uint32_t k1, int what, void* __restrict__ out,
            unsigned long long n, float lo) {
  const unsigned long long step =
      static_cast<unsigned long long>(gridDim.x) * kThreads;
  for (unsigned long long i =
           static_cast<unsigned long long>(blockIdx.x) * kThreads +
           threadIdx.x;
       i < n; i += step) {
    const uint32_t b = tf::bits32(k0, k1, i);
    if (what == kGumbel) {
      static_cast<float*>(out)[i] = tf::gumbel_f32(b, lo);
    } else {                                  // keep: uniform(0, 1) < lo
      static_cast<uint8_t*>(out)[i] = tf::unit_f32(b) < lo ? 1 : 0;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(uint32_t k0, uint32_t k1, const T* __restrict__ x,
               T* __restrict__ out, unsigned long long n, Bcast bc,
               int mode, float c, float keep_p) {
  const unsigned long long step =
      static_cast<unsigned long long>(gridDim.x) * kThreads;
  for (unsigned long long i =
           static_cast<unsigned long long>(blockIdx.x) * kThreads +
           threadIdx.x;
       i < n; i += step) {
    const bool keep =
        tf::unit_f32(tf::bits32(k0, k1, mask_index(i, bc))) < keep_p;
    const float v = to_f32(x[i]);
    float r;
    if (mode == kScale) {
      r = keep ? __fdiv_rn(v, c) : 0.0f;
    } else if (mode == kMask) {
      r = keep ? v : 0.0f;
    } else {                                  // kScaleGrad
      r = __fdiv_rn(keep ? v : 0.0f, c);
    }
    store(out + i, r);
  }
}

int blocks_for(unsigned long long n) {
  const unsigned long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// out[i] for i < n: what 0 the uint8 keep flag uniform < lo, 1 the f32
// Gumbel noise -log(-log(uniform(lo, 1)))
extern "C" int tf_fill_launch(uint32_t k0, uint32_t k1, int what, void* out,
                              long long n, float lo, void* stream) {
  if (n < 0 || what < kKeep || what > kGumbel) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (out == nullptr) return cudaErrorInvalidValue;
  fill_kernel<<<blocks_for(n), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      k0, k1, what, out, static_cast<unsigned long long>(n), lo);
  return cudaGetLastError();
}

// dropout of x (n elements of dtype 0 f32, 1 bf16, 2 f16) into out: mode
// 0 where(keep, x / c, 0), 1 where(keep, x, 0), 2 where(keep, x, 0) / c;
// keep = uniform < keep_p over the mask's flat index (rank 0: the
// element's; else size[rank] is x's shape and mstride[rank] the mask's
// strides, 0 where it broadcasts)
extern "C" int tf_dropout_launch(uint32_t k0, uint32_t k1, int dtype,
                                 const void* x, void* out, long long n,
                                 int rank, const long long* size,
                                 const long long* mstride, int mode,
                                 float c, float keep_p, void* stream) {
  if (n < 0 || rank < 0 || rank > kMaxRank || mode < kScale ||
      mode > kScaleGrad)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (x == nullptr || out == nullptr ||
      (rank > 0 && (size == nullptr || mstride == nullptr)))
    return cudaErrorInvalidValue;
  Bcast bc{};
  bc.rank = rank;
  for (int d = 0; d < rank; ++d) {
    if (size[d] < 1) return cudaErrorInvalidValue;
    bc.size[d] = size[d];
    bc.mstride[d] = mstride[d];
  }
  const unsigned long long un = static_cast<unsigned long long>(n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      dropout_kernel<<<blocks_for(un), kThreads, 0, st>>>(
          k0, k1, static_cast<const float*>(x), static_cast<float*>(out), un,
          bc, mode, c, keep_p);
      break;
    case kBF16:
      dropout_kernel<<<blocks_for(un), kThreads, 0, st>>>(
          k0, k1, static_cast<const __nv_bfloat16*>(x),
          static_cast<__nv_bfloat16*>(out), un, bc, mode, c, keep_p);
      break;
    case kF16:
      dropout_kernel<<<blocks_for(un), kThreads, 0, st>>>(
          k0, k1, static_cast<const __half*>(x), static_cast<__half*>(out),
          un, bc, mode, c, keep_p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
