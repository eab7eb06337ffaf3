// Seeded categorical sampling of the serving tick, one row a slot, for
// Hopper, sm_90a (R1).
//
// Replaces the draw the JAX package jits into its serving programs, a jnp
// composition with no pallas_call: paddle_tpu/inference/
// continuous_batching.py:2039-2048 (a prompt's first token), :2492-2503
// (each split decode step, vmapped over slots) and :2545-2571 (the fused
// tick), all of the form
//
//   key_in  = fresh ? PRNGKey(seed) : key          (fused ticks only)
//   next, sub = jax.random.split(key_in)
//   token   = jax.random.categorical(sub, logits[None])[0]
//           = argmax(logits + gumbel(sub, (1, V)))  (the first maximum)
//   key_out = emit ? next : key_in
//
// over logits that process_logits (temperature, top-k, top-p: plain torch
// before this kernel) left in f32. The Gumbel draw runs over shape
// [1, V], so element v's counter is (0, v). The kernel also flags a row
// whose raw logits (the model's, before process_logits, in f32, bf16 or
// f16) hold a NaN or an Inf: top-k and top-p fill such a row with -1e30,
// so the filtered row cannot tell.
//
// One block a row: every thread walks the row at a stride of the block,
// hashing (sub, v), turning the bits into Gumbel noise (threefry.cuh) and
// keeping its best (value, index); the block then reduces the pairs, a
// NaN above every number and the lower index winning ties, which is
// jnp.argmax's order and torch.argmax's. Thread 0 writes the token, the
// flag and the key. Nothing is accumulated in floating point, so the
// result does not depend on the block size or the reduction order.
//
// What bounds it on this card: at V = 32000 the row's 128 KB of logits
// take ~40 ns at the HBM rate, but each element costs two threefry
// hashes' worth of integer work (~100 operations) and two f64 logs, and
// one block a row keeps only S SMs busy at the serving batch (8 slots):
// it is bound by the blocks' own arithmetic, not by bytes. A kernel that
// spreads a row over many blocks is later work; this one is one launch a
// tick, where the plain torch draw is ~150.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
enum : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// is element v of a raw row of dtype dt a NaN or an Inf?
__device__ __forceinline__ bool nonfinite_at(const void* row, int dt, int v) {
  float x;
  if (dt == kBF16) {
    x = __bfloat162float(static_cast<const __nv_bfloat16*>(row)[v]);
  } else if (dt == kF16) {
    x = __half2float(static_cast<const __half*>(row)[v]);
  } else {
    x = static_cast<const float*>(row)[v];
  }
  return !isfinite(x);
}

// is (a, ia) ahead of (b, ib) in argmax order?
__device__ __forceinline__ bool ahead(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ahead(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

__global__ void __launch_bounds__(kThreads)
sample_rows_kernel(const float* __restrict__ logits, long long ld, int V,
                   const void* __restrict__ raw, long long raw_ld,
                   int raw_dt, const uint32_t* keys,
                   const int* __restrict__ seeds,
                   const int* __restrict__ fresh,
                   const int* __restrict__ emit, int* __restrict__ tokens,
                   uint32_t* keys_out, int* __restrict__ bad) {
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  const int s = blockIdx.x;
  uint32_t k0, k1;
  if (fresh[s]) {
    k0 = 0u;                                   // PRNGKey of an int32 seed
    k1 = static_cast<uint32_t>(seeds[s]);
  } else {
    k0 = keys[2 * s];
    k1 = keys[2 * s + 1];
  }
  const uint2 sub = tf::threefry2x32(k0, k1, 0u, 1u);   // split(key)[1]
  const float* row = logits + static_cast<long long>(s) * ld;
  const char* raw_row = static_cast<const char*>(raw) +
                        static_cast<long long>(s) * raw_ld *
                            (raw_dt == kF32 ? 4 : 2);
  float best = -INFINITY;
  int bi = INT_MAX;
  int nonfinite = 0;
  for (int v = threadIdx.x; v < V; v += kThreads) {
    const float x = row[v];
    nonfinite |= nonfinite_at(raw_row, raw_dt, v);
    const float g = tf::gumbel_f32(
        tf::bits32(sub.x, sub.y, static_cast<unsigned>(v)), tf::kTinyF32);
    const float val = __fadd_rn(g, x);
    if (ahead(val, v, best, bi)) { best = val; bi = v; }
  }
  nonfinite = __syncthreads_or(nonfinite);
  warp_best(best, bi);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { s_val[warp] = best; s_idx[warp] = bi; }
  __syncthreads();
  if (warp == 0) {
    best = lane < kWarps ? s_val[lane] : -INFINITY;
    bi = lane < kWarps ? s_idx[lane] : INT_MAX;
    warp_best(best, bi);
    if (lane == 0) {
      tokens[s] = bi;
      bad[s] = nonfinite;
      uint2 out = make_uint2(k0, k1);
      if (emit[s]) out = tf::threefry2x32(k0, k1, 0u, 0u);  // split[0]
      keys_out[2 * s] = out.x;
      keys_out[2 * s + 1] = out.y;
    }
  }
}

}  // namespace

// One draw per row of logits [S, V] (f32, rows ld elements apart): tokens
// int32 [S], keys_out uint32 [S, 2] (may alias keys), bad int32 [S] from
// raw [S, V] (dtype 0 f32, 1 bf16, 2 f16, rows raw_ld elements apart).
extern "C" int sample_rows_launch(const float* logits, long long ld, int S,
                                  int V, const void* raw, long long raw_ld,
                                  int raw_dt, const uint32_t* keys,
                                  const int* seeds, const int* fresh,
                                  const int* emit, int* tokens,
                                  uint32_t* keys_out, int* bad,
                                  void* stream) {
  if (S < 0 || V < 1 || ld < V || raw_ld < V || raw_dt < kF32 ||
      raw_dt > kF16)
    return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  if (logits == nullptr || raw == nullptr || keys == nullptr || seeds == nullptr ||
      fresh == nullptr || emit == nullptr || tokens == nullptr ||
      keys_out == nullptr || bad == nullptr)
    return cudaErrorInvalidValue;
  sample_rows_kernel<<<S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, ld, V, raw, raw_ld, raw_dt, keys, seeds, fresh, emit, tokens,
      keys_out, bad);
  return cudaGetLastError();
}
