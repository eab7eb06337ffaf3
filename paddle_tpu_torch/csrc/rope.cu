// Rotary position embedding (K6) for Hopper, sm_90a.
//
// Replaces the TPU kernel of paddle_tpu/ops/pallas/rope.py: _rope_call
// (reached through apply_rotary_pallas). The neox half rotation of x
// [B, S, H, D] at rows 0..S-1 of tables cos, sin [S_max, D/2] (f32 or
// bf16, whatever x's type):
//
//   out1 = x1 * c - sign * x2 * s      x1 = x[..., :D/2], x2 = x[..., D/2:]
//   out2 = x2 * c + sign * x1 * s      c, s = cos[s_pos], sin[s_pos]
//
// in f32, rounded once to x's type (f32 or bf16). With bf16 tables and
// bf16 x each product is first rounded to bf16, as the reference's
// kernel and its composition compute bf16 * bf16 (with f32 x the
// products are f32 either way). sign = +1 rotates;
// sign = -1 applies the transpose, which is the backward: x is then the
// cotangent, and each product is rounded to x's type before the sum, as
// the VJP of the reference's composition does it (each `x1 * c` promotes
// its own copy of bf16 x1 to f32, so each cotangent is rounded back to
// bf16 before the two add). The backward is then the reference's VJP,
// and torch autograd's through the plain composition, bit for bit. The
// products and sums are written with __fmul_rn / __fadd_rn / __fsub_rn:
// nvcc would otherwise contract x1 * c - x2 * s into a fused multiply-add,
// one f32 rounding off the plain version, which rounds each product.
//
// One launch may rotate two tensors at the same positions: q [B, S, Hq,
// D] and k [B, S, Hk, D] (Hk <= Hq under GQA), the counterpart of the
// reference model's single rope dispatch over (q, k). Hk = 0 is the
// single-tensor launch.
//
// What bounds it on this card: bytes. Six operations per pair of
// elements against 8 (bf16) or 16 (f32) bytes read and written, far below
// the ridge point. At llama_350m's q (8 x 1024 x 16 x 64, bf16) it moves
// 33.6 MB, 0.010 ms at 3.35 TB/s; q and k together twice that.
//
// Design. The Pallas kernel transposes x to [(B H), S, D] and stages a
// block of table rows per grid step; that is TPU blocking. Here x is
// indexed in place. A thread owns one 16-byte chunk of a head row's
// first half (8 bf16 or 4 f32 values of j) and the matching chunk of its
// second half, at one position (b, s). It loads its cos and sin chunk
// once, into registers, and then walks a group of the position's heads
// (q's, then k's), kInFlight heads' 16-byte loads issued before it
// computes, with 16-byte stores. So the table is read once per position
// and head group, not once per element and head, and no division is done
// per element. Consecutive threads hold consecutive chunks of one
// position: a warp's loads cover whole 32-byte sectors. The head groups
// and the grid come from a static plan (ops/kernels/rope.py: plan):
// enough (group, position, chunk) items to fill the card once at the
// occupancy query's blocks a SM, each group as wide as that allows.
// Shapes whose D/2 is not a multiple of the chunk, or whose pointers are
// not 16-byte aligned, take the same kernel with one element a chunk
// (the scalar body).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "attention_common.cuh"

namespace {

using pt_attn::store;
using pt_attn::to_f32;

constexpr int kThreads = 256;
// heads whose loads are issued together; 4 was no faster on an H100 (an
// in-call A/B, PERF.md §6)
constexpr int kInFlight = 2;

// v rounded to T and back (the identity for f32)
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

// V elements of type E at p as floats; p is aligned to V * sizeof(E)
// bytes when that is 8 or a multiple of 16
template <int V, typename E>
__device__ __forceinline__ void load_chunk(const E* __restrict__ p,
                                           float (&v)[V]) {
  constexpr int kBytes = V * static_cast<int>(sizeof(E));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(E));
#pragma unroll
    for (int w = 0; w < kBytes / 16; ++w) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[w];
      const E* e = reinterpret_cast<const E*>(&u);
#pragma unroll
      for (int i = 0; i < kPer; ++i) v[w * kPer + i] = to_f32(e[i]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const E* e = reinterpret_cast<const E*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(p[i]);
  }
}

// V floats rounded to T and stored at p (16-byte aligned when V * sizeof(T)
// is 16)
template <int V, typename T>
__device__ __forceinline__ void store_chunk(T* __restrict__ p,
                                            const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) store(e + i, v[i]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) store(p + i, v[i]);
  }
}

// TT: the tables' type; products round to T only when it is bf16 (or in
// the backward)
template <typename T, typename TT, bool BWD, int V>
__device__ __forceinline__ void rotate(const float (&x1)[V],
                                       const float (&x2)[V],
                                       const float (&c)[V],
                                       const float (&s)[V], float (&o1)[V],
                                       float (&o2)[V]) {
  const T t{};
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (BWD) {
      o1[i] = __fadd_rn(round_to(__fmul_rn(x1[i], c[i]), t),
                        round_to(__fmul_rn(x2[i], s[i]), t));
      o2[i] = __fsub_rn(round_to(__fmul_rn(x2[i], c[i]), t),
                        round_to(__fmul_rn(x1[i], s[i]), t));
    } else if (sizeof(TT) == 2) {   // bf16 tables
      o1[i] = __fsub_rn(round_to(__fmul_rn(x1[i], c[i]), t),
                        round_to(__fmul_rn(x2[i], s[i]), t));
      o2[i] = __fadd_rn(round_to(__fmul_rn(x2[i], c[i]), t),
                        round_to(__fmul_rn(x1[i], s[i]), t));
    } else {
      o1[i] = __fsub_rn(__fmul_rn(x1[i], c[i]), __fmul_rn(x2[i], s[i]));
      o2[i] = __fadd_rn(__fmul_rn(x2[i], c[i]), __fmul_rn(x1[i], s[i]));
    }
  }
}

// Item i = (g * positions + p) * chunks + c: head group g, position p =
// b * S + s, chunk c of the half row. Heads 0..hq-1 of the walk are q's,
// hq..hq+hk-1 k's; group g walks heads [g * gh, min((g + 1) * gh, hq +
// hk)). A grid-stride loop over the items (one pass when the plan fills
// the card once).
template <typename T, typename TT, bool BWD, int V>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
            T* __restrict__ oq, T* __restrict__ ok,
            const TT* __restrict__ cos_t, const TT* __restrict__ sin_t,
            int positions, int S, int hq, int hk, int D2, int chunks,
            int gh, int items) {
  const int D = 2 * D2;
  const int heads = hq + hk;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < items;
       i += gridDim.x * kThreads) {
    const int c = i % chunks;
    const int pg = i / chunks;
    const int p = pg % positions;
    const int h0 = (pg / positions) * gh;
    const int h1 = min(h0 + gh, heads);
    const int j = c * V;
    const long long trow = static_cast<long long>(p % S) * D2 + j;
    float cs[V], sn[V];
    load_chunk<V>(cos_t + trow, cs);
    load_chunk<V>(sin_t + trow, sn);
    // element offset of head h's row (and chunk j) at position p, in q
    // or in k
    auto row = [&](int h) -> long long {
      return (h < hq ? (static_cast<long long>(p) * hq + h) * D
                     : (static_cast<long long>(p) * hk + (h - hq)) * D) + j;
    };
    int h = h0;
    for (; h + kInFlight <= h1; h += kInFlight) {
      float x1[kInFlight][V], x2[kInFlight][V], o1[V], o2[V];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const T* x = h + u < hq ? q : k;
        const long long r = row(h + u);
        load_chunk<V>(x + r, x1[u]);
        load_chunk<V>(x + r + D2, x2[u]);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        T* out = h + u < hq ? oq : ok;
        const long long r = row(h + u);
        rotate<T, TT, BWD, V>(x1[u], x2[u], cs, sn, o1, o2);
        store_chunk<V>(out + r, o1);
        store_chunk<V>(out + r + D2, o2);
      }
    }
    for (; h < h1; ++h) {
      const long long r = row(h);
      float x1[V], x2[V], o1[V], o2[V];
      load_chunk<V>((h < hq ? q : k) + r, x1);
      load_chunk<V>((h < hq ? q : k) + r + D2, x2);
      rotate<T, TT, BWD, V>(x1, x2, cs, sn, o1, o2);
      store_chunk<V>((h < hq ? oq : ok) + r, o1);
      store_chunk<V>((h < hq ? oq : ok) + r + D2, o2);
    }
  }
}

template <typename T, typename TT, bool BWD, int V>
cudaError_t run(const void* q, const void* k, const void* cos_t,
                const void* sin_t, void* oq, void* ok, int positions, int S,
                int hq, int hk, int d2, int chunks, int gh, int items,
                int blocks, cudaStream_t st) {
  rope_kernel<T, TT, BWD, V><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<T*>(oq), static_cast<T*>(ok),
      static_cast<const TT*>(cos_t), static_cast<const TT*>(sin_t),
      positions, S, hq, hk, d2, chunks, gh, items);
  return cudaGetLastError();
}

template <typename T, typename TT, bool BWD, int V>
cudaError_t occupancy(int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, rope_kernel<T, TT, BWD, V>, kThreads, 0);
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>, Tag<TT>, bool BWD, int V) for the codes of the C interface:
// dtype / table_dtype 0 = float32, 1 = bfloat16; sign -1 = backward;
// vec 1 = the 16-byte body, 0 = the scalar body
template <typename F>
cudaError_t dispatch(int dtype, int table_dtype, int sign, int vec, F&& f) {
  auto by_vec = [&](auto t, auto tt, auto bwd) -> cudaError_t {
    using T = typename decltype(t)::type;
    if (vec)
      return f(t, tt, bwd,
               std::integral_constant<int, 16 / static_cast<int>(sizeof(T))>{});
    return f(t, tt, bwd, std::integral_constant<int, 1>{});
  };
  auto by_sign = [&](auto t, auto tt) -> cudaError_t {
    if (sign < 0) return by_vec(t, tt, std::true_type{});
    return by_vec(t, tt, std::false_type{});
  };
  auto by_table = [&](auto t) -> cudaError_t {
    if (table_dtype == 0) return by_sign(t, Tag<float>{});
    if (table_dtype == 1) return by_sign(t, Tag<__nv_bfloat16>{});
    return cudaErrorInvalidValue;
  };
  if (dtype == 0) return by_table(Tag<float>{});
  if (dtype == 1) return by_table(Tag<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// q, oq [B, S, hq, D] and k, ok [B, S, hk, D] (hk = 0: no k; dtype 0 =
// float32, 1 = bfloat16), cos, sin [s_max, D/2] (table_dtype likewise),
// S <= s_max, D even, each tensor under 2^31 elements; sign +1 or -1;
// vec 1 for the 16-byte body (D/2 a multiple of 16 bytes' elements, every
// pointer 16-byte aligned), 0 for the scalar body; gh heads a group and
// blocks from the plan. Returns a cudaError_t (0 = launched).
extern "C" int rope_qk_launch(const void* q, const void* k, const void* cos_t,
                              const void* sin_t, void* oq, void* ok, int B,
                              int S, int hq, int hk, int D, int s_max,
                              int sign, int dtype, int table_dtype, int vec,
                              int gh, int blocks, void* stream) {
  if (B < 0 || S < 0 || hq <= 0 || hk < 0 || D <= 0 || D % 2 != 0
      || S > s_max || (sign != 1 && sign != -1) || gh <= 0 || blocks <= 0
      || (hk > 0 && (k == nullptr || ok == nullptr)))
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  const int d2 = D / 2;
  const int esize = dtype == 1 ? 2 : 4;
  const int v = vec ? 16 / esize : 1;
  if (vec && (d2 % v != 0 || !aligned16(q) || !aligned16(oq)
              || !aligned16(cos_t) || !aligned16(sin_t)
              || (hk > 0 && (!aligned16(k) || !aligned16(ok)))))
    return cudaErrorMisalignedAddress;
  const long long positions = static_cast<long long>(B) * S;
  const long long chunks = d2 / v;
  const long long groups = (hq + hk + gh - 1) / gh;
  const long long items = groups * positions * chunks;
  // the grid-stride loop's index stays below 2^31
  if (positions * hq * D >= (1LL << 31) || positions * hk * D >= (1LL << 31)
      || items + static_cast<long long>(blocks) * kThreads >= (1LL << 31))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, table_dtype, sign, vec,
                  [&](auto t, auto tt, auto bwd, auto vw) -> cudaError_t {
    return run<typename decltype(t)::type, typename decltype(tt)::type,
               decltype(bwd)::value, decltype(vw)::value>(
        q, k, cos_t, sin_t, oq, ok, static_cast<int>(positions), S, hq, hk,
        d2, static_cast<int>(chunks), gh, static_cast<int>(items), blocks,
        st);
  });
}

// *blocks_per_sm: resident blocks of the kernel a SM for dtype,
// table_dtype, sign and vec (codes as rope_qk_launch), from the occupancy
// query. Returns a cudaError_t.
extern "C" int rope_blocks_per_sm(int dtype, int table_dtype, int sign,
                                  int vec, int* blocks_per_sm) {
  return dispatch(dtype, table_dtype, sign, vec,
                  [&](auto t, auto tt, auto bwd, auto vw) -> cudaError_t {
    return occupancy<typename decltype(t)::type, typename decltype(tt)::type,
                     decltype(bwd)::value, decltype(vw)::value>(
        blocks_per_sm);
  });
}
