// The bf16 row-tile body of the paged prefill kernels: K2
// (ragged_prefill.cu), whose keys lie at the slot's block-table columns,
// and K3 at C >= 2 (fused_tick.cu), whose keys lie at the slot's run of
// the page schedule. The caller's key map says where key i of the walk
// lies in the pool and at which position; everything else is shared.
//
// - One block of 4 warps per (slot, kv head, tile of 64 query vectors):
//   64 / rep chunk rows times the rep query heads of the kv head, so each
//   K/V row gathered serves the whole GQA group and the whole row tile.
//   Blocks of the last row tiles (the longest causal walks) are
//   scheduled first, so the tail of the grid is short tiles.
// - The block walks keys in tiles of 64 up to the key map's last key.
//   Each key tile's K and V rows are gathered with 16-byte cp.async into
//   a ring of two stages: tile i + 1's gather is in flight while tile
//   i's products run. Keys past the frontier are zero-filled without
//   being read, and no table or schedule entry past it is read. A tile
//   of rows wholly past the slot's take writes zeros and reads nothing.
// - Both products on mma.sync m16n8k16 bf16 with f32 accumulators; each
//   warp loads its 16 query vectors' Q fragments from device memory into
//   registers once and holds them for the whole walk; K fragments by
//   ldmatrix, V fragments by ldmatrix.trans, so V is consumed as it lies.
//   Rows in shared memory are padded by 16 bytes, which keeps every
//   ldmatrix free of bank conflicts. The softmax runs in base 2 (exp2f,
//   one instruction). Probabilities are rounded to bf16 for P V, as the
//   plain versions round them to q's type. A warp skips a key tile that
//   none of its vectors may see.
// - Shared memory holds only the ring (70 KB at hd 128), so three blocks
//   can share an SM (K2 runs three, K3 two: fused_tick.cu); the output
//   goes through the drained ring to 16-byte stores. Pool offsets are
//   computed in 64 bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_common.cuh"

namespace pt_attn {

constexpr int kMmaThreads = 128;  // 4 warps x 16 query vectors
constexpr int kVecs = 64;         // query vectors (rows x GQA heads) a block
constexpr int kKeyTile = 64;      // key positions per stage
constexpr int kStages = 2;        // ring of key tiles in shared memory

// shared rows are padded by 16 bytes: every ldmatrix is conflict-free
template <int HD>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (HD + 8) * kStages * 2 * kKeyTile;
}

// Block (s, g, z): slot s, kv head g and query vectors v = 0 .. nvec - 1
// of a tile of rows, vector v being row r0 + v / rep of the chunk under
// query head g * rep + v % rep. The grid's z runs the row tiles from the
// last (longest causal walk) to the first. maxp is the table's width:
// no key at or past maxp * pg is visible.
struct RowTile {
  int s, g, rep, nvec, r0, C, nh;
  long long t0;
  long long hi;   // the last key position any vector may see; -1: none

  __device__ __forceinline__ RowTile(const int* t0s, const int* lasts,
                                     int C_, int nh_, int kvh, int pg,
                                     int maxp)
      : s(blockIdx.x), g(blockIdx.y), rep(nh_ / kvh), C(C_), nh(nh_) {
    const int R = kVecs / rep;          // chunk rows per block
    nvec = R * rep;
    r0 = static_cast<int>(gridDim.z - 1 - blockIdx.z) * R;
    const int rows = (C - r0) < R ? (C - r0) : R;
    t0 = t0s[s];
    const long long last = lasts[s];
    const long long span = static_cast<long long>(maxp) * pg;
    hi = t0 + r0 + rows - 1;
    if (last < hi) hi = last;
    if (span - 1 < hi) hi = span - 1;
    // an idle slot, or rows wholly past the slot's take
    if (last < 0 || t0 + r0 > last) hi = -1;
  }
  // vector v's row of hd elements in q and out; -1 when v is no row
  __device__ __forceinline__ long long vec(int v) const {
    const int row = r0 + v / rep;
    if (v >= nvec || row >= C) return -1;
    return (static_cast<long long>(s) * C + row) * nh + g * rep + v % rep;
  }
  // vector v's causal limit min(t0 + row, hi); -1 when v is no row
  __device__ __forceinline__ long long limit(int v) const {
    const int row = r0 + v / rep;
    if (v >= nvec || row >= C) return -1;
    return t0 + row < hi ? t0 + row : hi;
  }
};

// K2's key map: key i of the walk is position i, at block-table column
// i / pg of the slot. A key map gives:
// - last(): the walk's last key (-1: none);
// - row(stage, kk, i, first): key i's pool row (page * pg + offset), or
//   -1 for a key no row may see (its chunks are zero-filled without a
//   read); called for each 16-byte chunk of key i, held as key kk of
//   ring stage `stage` (`first`: the chunk at column 0);
// - pos(stage, kk, i): the position of key kk of stage `stage`, the
//   walk's key i, for the causal mask.
struct TableKeys {
  const int* row_bt;  // the slot's block-table row
  int pg;
  long long hi;       // RowTile::hi

  __device__ __forceinline__ long long last() const { return hi; }
  __device__ __forceinline__ long long row(int /*stage*/, int /*kk*/, int i,
                                           bool /*first*/) const {
    if (i > hi) return -1;
    return static_cast<long long>(row_bt[i / pg]) * pg + i % pg;
  }
  __device__ __forceinline__ long long pos(int /*stage*/, int /*kk*/,
                                           long long i) const {
    return i;
  }
};

// The block's row tile t against the keys of `keys`, out = softmax(Q K^T
// * scale) V for every vector of the tile. sKV: the ring, dynamic shared
// memory of mma_smem_bytes<HD>().
template <int HD, typename Keys>
__device__ __forceinline__ void rows_mma_walk(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, __nv_bfloat16* __restrict__ out,
    const RowTile& t, const Keys& keys, int kvh, float scale,
    __nv_bfloat16* sKV) {
  const long long walk_hi = keys.last();
  using bf16 = __nv_bfloat16;
  constexpr int P = HD + 8;              // padded row pitch, elements
  constexpr int CH = HD / 8;             // 16-byte chunks in a row
  constexpr int KS = HD / 16;            // k-steps of Q K^T
  constexpr int NS = kKeyTile / 8;       // n-tiles of the scores
  constexpr int NO = HD / 8;             // n-tiles of the accumulator
  static_assert(kMmaThreads == 4 * 32 && kVecs == 4 * 16, "4 warps x 16");

  if (walk_hi < 0) {                     // read nothing, write zeros
    for (int i = threadIdx.x; i < kVecs * CH; i += kMmaThreads) {
      const long long at = t.vec(i / CH);
      if (at >= 0)
        *reinterpret_cast<uint4*>(out + at * HD + (i % CH) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int fr = lane >> 2;              // fragment row (and fr + 8)
  const int fc = (lane & 3) * 2;         // fragment column pair
  const int mi = lane >> 3;              // the ldmatrix matrix this lane
  const int mr = lane & 7;               // addresses, and its row there
  const int n_tiles = static_cast<int>(walk_hi / kKeyTile) + 1;

  // gather key tile i into its stage: key j's row under kv head g, or
  // zeros without a read for a key the map does not give
  auto gather = [&](int i) {
    const int stage = i % kStages;
    bf16* sk = sKV + stage * 2 * kKeyTile * P;
    bf16* sv = sk + kKeyTile * P;
    for (int e = threadIdx.x; e < kKeyTile * CH; e += kMmaThreads) {
      const int kk = e / CH;
      const int c = (e % CH) * 8;
      const int j = i * kKeyTile + kk;   // walk_hi < maxp * pg fits an int
      const long long r = keys.row(stage, kk, j, c == 0);
      const bool ok = r >= 0;
      const long long off = ok ? (r * kvh + t.g) * HD + c : 0;
      cp_async16(sk + kk * P + c, kp + off, ok);
      cp_async16(sv + kk * P + c, vp + off, ok);
    }
  };

  gather(0);
  cp_async_commit();
  // Q fragments straight from global memory, held for the whole walk
  uint32_t qa[KS][4];
  {
    const long long at0 = t.vec(warp * 16 + fr);
    const long long at1 = t.vec(warp * 16 + fr + 8);
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int c = k * 16 + fc;
      qa[k][0] = at0 >= 0 ? ld32(q + at0 * HD + c) : 0u;
      qa[k][1] = at1 >= 0 ? ld32(q + at1 * HD + c) : 0u;
      qa[k][2] = at0 >= 0 ? ld32(q + at0 * HD + c + 8) : 0u;
      qa[k][3] = at1 >= 0 ? ld32(q + at1 * HD + c + 8) : 0u;
    }
  }

  // scores in base 2 (exp2f is one instruction): softmax is unchanged
  const float scale2 = scale * 1.4426950408889634f;   // scale * log2(e)
  long long lim[2];                      // causal limits of rows fr, fr + 8
  float m[2], l[2];                      // running max (base 2) and sum
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lim[h] = t.limit(warp * 16 + fr + 8 * h);
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  // the last key any of this warp's vectors may see
  long long warp_lim = lim[0] > lim[1] ? lim[0] : lim[1];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long x = __shfl_xor_sync(0xffffffffu, warp_lim, o);
    warp_lim = x > warp_lim ? x : warp_lim;
  }
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) gather(i + 1);
    cp_async_commit();                   // (an empty group on the last)
    cp_async_wait<1>();                  // this thread's copies of tile i
    __syncthreads();                     // everyone's
    const long long k0 = static_cast<long long>(i) * kKeyTile;
    // a key's position is never below its index in the walk
    if (k0 <= warp_lim) {                // warp-uniform
      const int stage = i % kStages;
      const bf16* sk = sKV + stage * 2 * kKeyTile * P;
      const bf16* sv = sk + kKeyTile * P;
      float sc[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
      }
      // S = Q K^T: one ldmatrix.x4 gives the B fragments of two n-tiles
#pragma unroll
      for (int k = 0; k < KS; ++k) {
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, sk + (np * 16 + (mi >> 1) * 8 + mr) * P + k * 16 +
                             (mi & 1) * 8);
          mma_bf16(sc[2 * np], qa[k], b[0], b[1]);
          mma_bf16(sc[2 * np + 1], qa[k], b[2], b[3]);
        }
      }

      // online softmax of fragment rows fr (h = 0) and fr + 8 (h = 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bool ok[NS][2];
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kk = n * 8 + fc + e;
            ok[n][e] = keys.pos(stage, kk, k0 + kk) <= lim[h];
            const float x = ok[n][e] ? sc[n][2 * h + e] * scale2 : kNegInf;
            sc[n][2 * h + e] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = quad_max(mx);
        const float m_new = fmaxf(m[h], mx);
        const float corr = exp2f(m[h] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ok[n][e] ? exp2f(sc[n][2 * h + e] - m_new) : 0.f;
            sc[n][2 * h + e] = p;
            psum += p;
          }
        }
        l[h] = l[h] * corr + quad_sum(psum);
        m[h] = m_new;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[n][2 * h] *= corr;
          o[n][2 * h + 1] *= corr;
        }
      }

      // O += P V: the score fragments of keys 16j .. 16j + 15 are the A
      // fragment of one k-step; ldmatrix.trans gives V's B fragments of
      // two n-tiles
#pragma unroll
      for (int j = 0; j < kKeyTile / 16; ++j) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                                pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                                pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                                pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, sv + (j * 16 + (mi & 1) * 8 + mr) * P +
                                   np * 16 + (mi >> 1) * 8);
          mma_bf16(o[2 * np], pa, b[0], b[1]);
          mma_bf16(o[2 * np + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncthreads();                     // stage i % kStages is free again
  }

  // the ring is drained (the loop ends on a barrier): the warp's 16 rows
  // of stage 0 take its output, then go out in 16-byte stores
  bf16* so = sKV + warp * 16 * P;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = l[h] == 0.f ? 0.f : 1.f / l[h];
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(so + (fr + 8 * h) * P + n * 8 + fc) =
          pack_bf16(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
  }
  __syncwarp();
  for (int e = lane; e < 16 * CH; e += 32) {
    const long long at = t.vec(warp * 16 + e / CH);
    if (at >= 0)
      *reinterpret_cast<uint4*>(out + at * HD + (e % CH) * 8) =
          *reinterpret_cast<const uint4*>(so + (e / CH) * P + (e % CH) * 8);
  }
}

}  // namespace pt_attn
