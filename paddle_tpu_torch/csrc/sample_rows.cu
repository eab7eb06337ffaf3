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
// What bounds it on this card: arithmetic and latency, not bytes. At 8 x
// 32000 the rows' 1.5 MB take ~0.5 us at the HBM rate, but each element
// costs one Threefry-2x32 hash and two f64 logs: at least ~141
// instructions (chip_smoke.py's NEED: 68 integer, 64 FP64, the uniform
// float and the compare), ~1 us of a whole card's issue slots; the
// compiled loop issues ~66 ALU, ~61 IMAD / VIADD, ~20 FP32 and 64 FP64 an
// element. One block a row kept 8 of 132 SMs busy there. So the design
// spreads the work over the whole card, one 8-element step a thread at 1
// or 8 rows (what is left, ~13 us, is one thread's latency: 8 hashes, 16
// dependent f64 logs and the merge), and keeps everything else out of
// the loop:
//   - a row over many blocks: plan() in ops/kernels/sample_rows.py gives
//     blocks a row (>= 2 blocks an SM at the serving batch of 8, one a row
//     at 1024 rows) and the chunk each walks, 8 elements a thread a step,
//     16-byte loads of the f32 logits and of the raw row (the vector
//     route; the scalar route loads one element at a time);
//   - the raw row's dtype is a template parameter: no branch in the loop;
//   - each block reduces its (value, index) pairs and the raw flag and
//     writes them to a workspace; the last block of the row to finish,
//     found by an integer ticket counter that it resets, merges them. The
//     pairs form a total order (a NaN above every number, the lower index
//     winning ties: jnp.argmax's and torch.argmax's first maximum), so the
//     token does not depend on the block count, the block size or the
//     order blocks finish in. The merge writes keys_out only after every
//     block of its row has read keys (they may alias).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kStep = 8;            // elements a thread takes a step
enum : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// the raw row's element as f32, by its storage type
template <typename Raw> struct RawElem;
template <> struct RawElem<float> {
  using Bits = float;
  static __device__ __forceinline__ float f32(Bits x) { return x; }
};
template <> struct RawElem<__nv_bfloat16> {
  using Bits = unsigned short;
  static __device__ __forceinline__ float f32(Bits x) {
    return __bfloat162float(__ushort_as_bfloat16(x));
  }
};
template <> struct RawElem<__half> {
  using Bits = unsigned short;
  static __device__ __forceinline__ float f32(Bits x) {
    return __half2float(__ushort_as_half(x));
  }
};

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

// element v of the row: its logit plus the Gumbel noise of (sub, v)
__device__ __forceinline__ void take(float x, int v, uint2 sub, float& best,
                                     int& bi) {
  const float g = tf::gumbel_f32(
      tf::bits_at(sub.x, sub.y, static_cast<uint32_t>(v)), tf::kTinyF32);
  const float val = __fadd_rn(g, x);
  if (ahead(val, v, best, bi)) { best = val; bi = v; }
}

template <typename Raw, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
sample_rows_kernel(const float* __restrict__ logits, long long ld, int V,
                   const void* __restrict__ raw_v, long long raw_ld,
                   const uint32_t* keys, const int* __restrict__ seeds,
                   const int* __restrict__ fresh,
                   const int* __restrict__ emit, int* __restrict__ tokens,
                   uint32_t* keys_out, int* __restrict__ bad, int blocks,
                   int chunk, int4* __restrict__ ws,
                   unsigned int* __restrict__ tickets) {
  using Bits = typename RawElem<Raw>::Bits;
  __shared__ float s_val[kMaxWarps];
  __shared__ int s_idx[kMaxWarps];
  __shared__ int s_last;
  const int s = blockIdx.y, part = blockIdx.x;
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
  const Bits* raw = static_cast<const Bits*>(raw_v) +
                    static_cast<long long>(s) * raw_ld;
  const int v_end = min(V, (part + 1) * chunk);
  float best = -INFINITY;
  int bi = INT_MAX;
  bool nonfinite = false;
  for (int v0 = part * chunk + threadIdx.x * kStep; v0 < v_end;
       v0 += blockDim.x * kStep) {
    if (kVec && v0 + kStep <= v_end) {
      alignas(16) float x[kStep];
      alignas(16) Bits r[kStep];
      *reinterpret_cast<float4*>(x) =
          *reinterpret_cast<const float4*>(row + v0);
      *reinterpret_cast<float4*>(x + 4) =
          *reinterpret_cast<const float4*>(row + v0 + 4);
#pragma unroll
      for (int w = 0; w < kStep * static_cast<int>(sizeof(Bits)) / 16; ++w)
        reinterpret_cast<uint4*>(r)[w] =
            reinterpret_cast<const uint4*>(raw + v0)[w];
#pragma unroll
      for (int e = 0; e < kStep; ++e) {
        nonfinite |= !isfinite(RawElem<Raw>::f32(r[e]));
        take(x[e], v0 + e, sub, best, bi);
      }
    } else {
      for (int v = v0; v < min(v0 + kStep, v_end); ++v) {
        nonfinite |= !isfinite(RawElem<Raw>::f32(raw[v]));
        take(row[v], v, sub, best, bi);
      }
    }
  }
  const int any_bad = __syncthreads_or(nonfinite);
  warp_best(best, bi);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  if (lane == 0) { s_val[warp] = best; s_idx[warp] = bi; }
  __syncthreads();
  if (warp != 0) return;
  best = lane < warps ? s_val[lane] : -INFINITY;
  bi = lane < warps ? s_idx[lane] : INT_MAX;
  warp_best(best, bi);
  int flag = any_bad;
  if (blocks > 1) {
    // this block's pair to the workspace; the row's last block merges
    if (lane == 0) {
      ws[s * blocks + part] = make_int4(__float_as_int(best), bi, flag, 0);
      __threadfence();
      s_last = atomicAdd(&tickets[s], 1u) == static_cast<unsigned>(blocks - 1);
    }
    __syncwarp();
    if (!s_last) return;
    __threadfence();
    best = -INFINITY;
    bi = INT_MAX;
    flag = 0;
    for (int b = lane; b < blocks; b += 32) {
      const int4 e = __ldcg(ws + s * blocks + b);
      const float ev = __int_as_float(e.x);
      if (ahead(ev, e.y, best, bi)) { best = ev; bi = e.y; }
      flag |= e.z;
    }
    warp_best(best, bi);
    flag = __any_sync(0xffffffffu, flag);
  }
  if (lane == 0) {
    tokens[s] = bi;
    bad[s] = flag;
    uint2 out = make_uint2(k0, k1);
    if (emit[s]) out = tf::threefry2x32(k0, k1, 0u, 0u);  // split[0]
    keys_out[2 * s] = out.x;
    keys_out[2 * s + 1] = out.y;
    if (blocks > 1) tickets[s] = 0u;          // ready for the next launch
  }
}

template <typename Raw>
void launch_as(bool vec, dim3 grid, int threads, cudaStream_t st,
               const float* logits, long long ld, int V, const void* raw,
               long long raw_ld, const uint32_t* keys, const int* seeds,
               const int* fresh, const int* emit, int* tokens,
               uint32_t* keys_out, int* bad, int blocks, int chunk, int4* ws,
               unsigned int* tickets) {
  if (vec) {
    sample_rows_kernel<Raw, true><<<grid, threads, 0, st>>>(
        logits, ld, V, raw, raw_ld, keys, seeds, fresh, emit, tokens,
        keys_out, bad, blocks, chunk, ws, tickets);
  } else {
    sample_rows_kernel<Raw, false><<<grid, threads, 0, st>>>(
        logits, ld, V, raw, raw_ld, keys, seeds, fresh, emit, tokens,
        keys_out, bad, blocks, chunk, ws, tickets);
  }
}

}  // namespace

// One draw per row of logits [S, V] (f32, rows ld elements apart): tokens
// int32 [S], keys_out uint32 [S, 2] (may alias keys), bad int32 [S] from
// raw [S, V] (dtype 0 f32, 1 bf16, 2 f16, rows raw_ld elements apart).
// The plan: blocks a row, each walking chunk elements (a multiple of 8)
// with threads threads; vec 1 takes 16-byte loads (logits, raw and their
// rows 16-byte aligned). With blocks > 1, ws is int32 [S, blocks, 4] of
// scratch and tickets uint32 [S] zeros, left zero by the launch: launches
// that share a tickets buffer must not overlap (one stream).
extern "C" int sample_rows_launch(const float* logits, long long ld, int S,
                                  int V, const void* raw, long long raw_ld,
                                  int raw_dt, const uint32_t* keys,
                                  const int* seeds, const int* fresh,
                                  const int* emit, int* tokens,
                                  uint32_t* keys_out, int* bad, int blocks,
                                  int chunk, int threads, int vec, void* ws,
                                  void* tickets, void* stream) {
  if (S < 0 || V < 1 || ld < V || raw_ld < V || raw_dt < kF32 ||
      raw_dt > kF16 || blocks < 1 || chunk < kStep || chunk % kStep != 0 ||
      static_cast<long long>(blocks - 1) * chunk >= V ||
      static_cast<long long>(blocks) * chunk < V || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || S > 65535)
    return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  if (logits == nullptr || raw == nullptr || keys == nullptr ||
      seeds == nullptr || fresh == nullptr || emit == nullptr ||
      tokens == nullptr || keys_out == nullptr || bad == nullptr ||
      (blocks > 1 && (ws == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, S);
  int4* w = static_cast<int4*>(ws);
  unsigned int* t = static_cast<unsigned int*>(tickets);
  switch (raw_dt) {
    case kF32:
      launch_as<float>(vec != 0, grid, threads, st, logits, ld, V, raw,
                       raw_ld, keys, seeds, fresh, emit, tokens, keys_out,
                       bad, blocks, chunk, w, t);
      break;
    case kBF16:
      launch_as<__nv_bfloat16>(vec != 0, grid, threads, st, logits, ld, V,
                               raw, raw_ld, keys, seeds, fresh, emit, tokens,
                               keys_out, bad, blocks, chunk, w, t);
      break;
    default:
      launch_as<__half>(vec != 0, grid, threads, st, logits, ld, V, raw,
                        raw_ld, keys, seeds, fresh, emit, tokens, keys_out,
                        bad, blocks, chunk, w, t);
  }
  return cudaGetLastError();
}
