// Device code shared by the port's kernels: K1 (paged_attention.cu), K2
// (ragged_prefill.cu), K3 (fused_tick.cu), K4 (flash_attention.cu), K5
// (rms_norm.cu), K6 (rope.cu), K7 (gemm_epilogue.cu) and K8
// (quant_matmul.cu).
//
// - element helpers: f32 loads and stores of f32/bf16, 16-byte row loads,
//   warp sums and sums or maxima over a few neighbouring lanes;
// - mma.sync m16n8k16 bf16 fragment helpers (K2's, K3's, K4's and K7's
//   tensor-core tiles), ldmatrix fragment loads and 16- and 4-byte
//   cp.async copies (K2's and K4's pipelined loads);
// - decode_attend: one query row per kv head's GQA group over paged K/V
//   (K1's design). K1 runs it over a slot's block table; K3's C == 1
//   kernel runs it over the slot's run of the page schedule. The caller
//   says where key j lies in the pool.
//
// _build.py hashes this header into every kernel library's name, so an
// edit here rebuilds all of them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace pt_attn {

constexpr int kMaxRep = 8;          // largest GQA ratio (Llama-2-70B)
constexpr float kNegInf = -1e30f;   // the TPU kernels' mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of a pool row as floats
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// reduce over the N consecutive lanes (N a power of two, at most 32) that
// share one row of a tile
template <int N>
__device__ __forceinline__ float lanes_max(float v) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
template <int N>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------ mma.sync m16n8k16 bf16
//
// Fragments of a warp's 16 x 8 x 16 product, lane = 4 * g + t: A (16 x 16,
// row-major) a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1], a2 = A[g][2t+8,
// 2t+9], a3 = A[g+8][2t+8, 2t+9]; B (16 x 8, by column) b0 = B[2t, 2t+1][g],
// b1 = B[2t+8, 2t+9][g]; C (16 x 8) c0, c1 = C[g][2t, 2t+1], c2, c3 =
// C[g+8][2t, 2t+1]. The C fragments of two neighbouring n-tiles are the A
// fragment of one k-step of the next product (scores -> P V).

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 32-bit address of a shared-memory pointer, as PTX's shared-space
// instructions take it
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix .x4: lanes 8i .. 8i + 7 give the row addresses (16 bytes each,
// 16-byte aligned) of 8 x 8 matrix i; r[i] receives matrix i's fragment,
// row lane / 4, columns 2 (lane % 4) and + 1 (.trans: its transpose, so
// a [key][dim] tile is read as the k-major B operand of P V)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// 16-byte asynchronous copy global -> shared (both 16-byte aligned); with
// pred false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
// 4-byte asynchronous copy (one f32), zero-filled when pred is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// reduce over the 4 lanes that hold one fragment row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One block of WARPS warps attends the rep query vectors of kv head g
// (q and o point at the first of them, rep * HD contiguous elements)
// over keys 0 .. n_keys - 1. key_row(j) gives key j's row in the pool
// (page * pg + offset in the page), or a negative value to skip it; the
// block never reads a row it was not given.
//
// The warps take the keys round-robin; in a warp each lane holds HD / 32
// dims of q, the K and V rows and the accumulator, the dot product is a
// warp shuffle reduction and the online softmax state (m, l, acc) of
// every query vector lives in registers. At the end the warps' partial
// states merge through shared memory. No key at all writes zeros (the
// l == 0 guard of the TPU kernels).
template <typename T, int HD, int WARPS, typename KeyRow>
__device__ __forceinline__ void decode_attend(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, T* __restrict__ o, int rep, int kvh, int g,
    int n_keys, KeyRow key_row, float scale) {
  constexpr int EPL = (HD + 31) / 32;   // dims per lane
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d0 = lane * EPL;
  const bool has = d0 < HD;             // hd = 16: lanes 16..31 hold none

  float qr[kMaxRep][EPL], acc[kMaxRep][EPL], m[kMaxRep], l[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[r][e] = 0.f;
      qr[r][e] = (r < rep && has) ? to_f32(q[r * HD + d0 + e]) : 0.f;
    }
  }

#pragma unroll 2
  for (int j = warp; j < n_keys; j += WARPS) {
    const long long row = key_row(j);
    if (row < 0) continue;   // warp-uniform: the shuffles stay converged
    const long long base = (row * kvh + g) * HD + d0;
    float kr[EPL], vr[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kr[e] = has ? to_f32(kp[base + e]) : 0.f;
      vr[e] = has ? to_f32(vp[base + e]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot += qr[r][e] * kr[e];
        const float sc = warp_sum(dot) * scale;
        const float m_new = fmaxf(m[r], sc);
        const float corr = expf(m[r] - m_new);
        const float p = expf(sc - m_new);
        l[r] = l[r] * corr + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = acc[r][e] * corr + p * vr[e];
        m[r] = m_new;
      }
    }
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[WARPS][kMaxRep];
  __shared__ float sm_l[WARPS][kMaxRep];
  __shared__ float sm_acc[WARPS][kMaxRep][HD];
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
  }
  if (has) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) sm_acc[warp][r][d0 + e] = acc[r][e];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rep * HD; i += WARPS * 32) {
    const int r = i / HD;
    const int d = i % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float lsum = 0.f, acc_d = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(sm_m[w][r] - mx);
      lsum += sm_l[w][r] * c;
      acc_d += sm_acc[w][r][d] * c;
    }
    store(o + i, lsum == 0.f ? 0.f : acc_d / lsum);
  }
}

}  // namespace pt_attn
