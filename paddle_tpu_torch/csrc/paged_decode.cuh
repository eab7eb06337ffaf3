// The bf16 split-K decode body: one query row per slot (the rep query
// vectors of a kv head's GQA group) over paged K/V, for K1
// (paged_attention.cu), whose keys lie at the slot's block-table
// columns, and K3 at C == 1 (fused_tick.cu), whose keys lie at the
// slot's run of the page schedule.
//
// What bounds it: bytes. Each visible K and V row is read once, against
// 4 * rep * hd operations per key: two orders of magnitude below the
// card's ridge point. So the design is about keeping enough 16-byte
// copies in flight over the whole card:
//
// - Split over pages. One block per (slot, kv head, split); split z
//   walks a fixed run of pages_per_split pages (table columns, or
//   schedule entries). The split count comes from static shapes (the
//   table's or the live slice's width and the card's SM count; the
//   wrapper's plan), never from the lengths, which live on the card. A
//   block whose split starts past the slot's visible keys reads nothing.
// - Gather. Before its walk the block stages its pages' pool ids (and
//   their first positions) in shared memory: each table or schedule
//   entry is read once, by one thread, and none past the frontier. Key
//   tiles of 64 are then gathered with 16-byte cp.async into a ring of
//   kSplitStages tiles; keys past the frontier are zero-filled without a
//   read.
// - Products on mma.sync m16n8k16 with f32 accumulators. The rep query
//   vectors are the A rows, zero-padded to 16 (rows 8..15 are always
//   padding: rep <= 8), held in registers for the walk; each warp takes
//   16 keys of every tile and keeps its own (m, l, acc). K by ldmatrix,
//   V by ldmatrix.trans as it lies. The softmax runs in base 2 and the
//   probabilities are rounded to bf16 for P V, as in K2. With rep = 1
//   fifteen A rows of sixteen are padding: the tensor cores are idle
//   most of the time either way.
// - Merge. The warps merge in index order through the drained ring;
//   the block then writes its split's (m, l) and unnormalised f32
//   acc[hd] per query vector to a workspace [S, nh, splits, hd + 2]
//   (acc, m, l), and split_merge_kernel merges the splits of each
//   vector in index order (no atomics: a call is bitwise repeatable).
//   With one split the block writes the output itself. A vector with no
//   visible key writes zeros (the l == 0 guard); a split with no key
//   writes only its (m, l) and reads nothing but its length or run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_common.cuh"

namespace pt_attn {

constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kSplitKeys = 64;        // keys a tile
constexpr int kSplitStages = 2;       // tiles in the ring
constexpr int kMaxSplitPages = 64;    // pages a split, at most

template <int HD>
constexpr size_t split_smem_bytes() {
  return sizeof(__nv_bfloat16) * (HD + 8) * kSplitStages * 2 * kSplitKeys;
}

// The pages of one split, staged by the block before its walk: page e
// holds the split's keys e * pg .. e * pg + pg - 1.
struct SplitPages {
  int id[kMaxSplitPages];     // pool page id; -1: the page is not read
  int base[kMaxSplitPages];   // absolute position of the page's key 0
};

// The rep query vectors at q (rep * HD contiguous elements) of kv head g
// against the split's keys 0 .. n - 1 (in `pages`); a key is visible when
// its page is read and its position is at most lim. Writes the split's
// result: normalised to out (rep * HD elements) when out is given, else
// acc, m and l to ws (the first vector's row; the next vector's row is
// ws_stride floats on). smem: split_smem_bytes<HD>() of dynamic shared
// memory. Every thread of the block calls it.
template <int HD>
__device__ __forceinline__ void split_decode(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, int rep, int kvh, int g, int pg,
    const SplitPages& pages, int n, long long lim, float scale,
    __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
    long long ws_stride, unsigned char* smem) {
  using bf16 = __nv_bfloat16;
  constexpr int P = HD + 8;              // padded row pitch, elements
  constexpr int CH = HD / 8;             // 16-byte chunks in a row
  constexpr int KS = HD / 16;            // k-steps of Q K^T
  constexpr int NO = HD / 8;             // n-tiles of the accumulator
  static_assert(kSplitKeys == kSplitWarps * 16, "16 keys a warp");
  static_assert(sizeof(float) * kSplitWarps * kMaxRep * (HD + 2) <=
                    sizeof(bf16) * P * kSplitStages * 2 * kSplitKeys,
                "the merge fits the ring");
  if (n == 0) {                          // no key: read nothing more
    for (int i = threadIdx.x; i < rep * HD; i += kSplitThreads) {
      if (out != nullptr) {
        store(out + i, 0.f);
      } else if (i % HD == 0) {          // l == 0: the merge skips acc
        float* row = ws + (i / HD) * ws_stride;
        row[HD] = kNegInf;
        row[HD + 1] = 0.f;
      }
    }
    return;
  }
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int fr = lane >> 2;              // fragment row: query vector fr
  const int fc = (lane & 3) * 2;         // fragment column pair
  const int mi = lane >> 3;              // the ldmatrix matrix this lane
  const int mr = lane & 7;               // addresses, and its row there
  const int n_tiles = (n + kSplitKeys - 1) / kSplitKeys;

  auto visible = [&](int j) {
    if (j >= n) return false;
    const int e = j / pg;
    return pages.id[e] >= 0 && pages.base[e] + (j - e * pg) <= lim;
  };
  // gather key tile i into its stage; an invisible key is zero-filled
  auto gather = [&](int i) {
    bf16* sk = ring + (i % kSplitStages) * 2 * kSplitKeys * P;
    bf16* sv = sk + kSplitKeys * P;
    for (int e = threadIdx.x; e < kSplitKeys * CH; e += kSplitThreads) {
      const int kk = e / CH;
      const int c = (e % CH) * 8;
      const int j = i * kSplitKeys + kk;
      const bool ok = visible(j);
      long long off = 0;
      if (ok) {
        const int pe = j / pg;
        off = ((static_cast<long long>(pages.id[pe]) * pg + (j - pe * pg)) *
                   kvh + g) * HD + c;
      }
      cp_async16(sk + kk * P + c, kp + off, ok);
      cp_async16(sv + kk * P + c, vp + off, ok);
    }
  };

  // the ring's first kSplitStages - 1 tiles in flight
#pragma unroll
  for (int i = 0; i < kSplitStages - 1; ++i) {
    if (i < n_tiles) gather(i);
    cp_async_commit();
  }
  // A rows fr < rep: the query vectors; a1 and a3 (rows fr + 8) are zero
  uint32_t qa[KS][2];
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int c = fr * HD + k * 16 + fc;
    qa[k][0] = fr < rep ? ld32(q + c) : 0u;
    qa[k][1] = fr < rep ? ld32(q + c + 8) : 0u;
  }

  const float scale2 = scale * 1.4426950408889634f;   // scale * log2(e)
  float m = kNegInf, l = 0.f;            // row fr's running max and sum
  float o[NO][2];                        // row fr's accumulator columns
#pragma unroll
  for (int d = 0; d < NO; ++d) o[d][0] = o[d][1] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + kSplitStages - 1 < n_tiles) gather(i + kSplitStages - 1);
    cp_async_commit();                   // (empty groups at the end)
    cp_async_wait<kSplitStages - 1>();   // this thread's copies of tile i
    __syncthreads();                     // everyone's
    const int kw = i * kSplitKeys + warp * 16;   // the warp's first key
    if (kw < n) {                        // warp-uniform
      const bf16* sk =
          ring + (i % kSplitStages) * 2 * kSplitKeys * P + warp * 16 * P;
      const bf16* sv = sk + kSplitKeys * P;
      // S = Q K^T over the warp's 16 keys: two n-tiles of 8
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        uint32_t b[4];
        ldmatrix_x4(b, sk + ((mi >> 1) * 8 + mr) * P + k * 16 + (mi & 1) * 8);
        const uint32_t a[4] = {qa[k][0], 0u, qa[k][1], 0u};
        mma_bf16(sc[0], a, b[0], b[1]);
        mma_bf16(sc[1], a, b[2], b[3]);
      }
      // online softmax of row fr over keys kw + 8n + fc + e
      bool ok[2][2];
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ok[nt][e] = visible(kw + nt * 8 + fc + e);
          const float x = ok[nt][e] ? sc[nt][e] * scale2 : kNegInf;
          sc[nt][e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = quad_max(mx);
      const float m_new = fmaxf(m, mx);
      const float corr = exp2f(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ok[nt][e] ? exp2f(sc[nt][e] - m_new) : 0.f;
          sc[nt][e] = p;
          psum += p;
        }
      }
      l = l * corr + quad_sum(psum);
      m = m_new;
      // O += P V: one k-step of 16 keys; rows fr + 8 of P are zero, and
      // so are the accumulator's rows fr + 8, kept out of registers
      const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), 0u,
                              pack_bf16(sc[1][0], sc[1][1]), 0u};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sv + ((mi & 1) * 8 + mr) * P + np * 16 +
                                 (mi >> 1) * 8);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float d[4] = {o[2 * np + h][0] * corr, o[2 * np + h][1] * corr,
                        0.f, 0.f};
          mma_bf16(d, pa, b[2 * h], b[2 * h + 1]);
          o[2 * np + h][0] = d[0];
          o[2 * np + h][1] = d[1];
        }
      }
    }
    __syncthreads();                     // stage i % kSplitStages is free
  }

  // the ring is drained (the loop ends on a barrier): the warps' states
  // meet there and merge in warp order
  float* s_acc = reinterpret_cast<float*>(smem);     // [warp][vec][HD]
  float* s_m = s_acc + kSplitWarps * kMaxRep * HD;    // [warp][vec]
  float* s_l = s_m + kSplitWarps * kMaxRep;
  if (fr < rep) {
    float* a = s_acc + (warp * kMaxRep + fr) * HD + fc;
#pragma unroll
    for (int d = 0; d < NO; ++d) {
      a[d * 8] = o[d][0];
      a[d * 8 + 1] = o[d][1];
    }
    if ((lane & 3) == 0) {
      s_m[warp * kMaxRep + fr] = m;
      s_l[warp * kMaxRep + fr] = l;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rep * HD; i += kSplitThreads) {
    const int r = i / HD;
    const int d = i % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w)
      mx = fmaxf(mx, s_m[w * kMaxRep + r]);
    float lsum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float c = exp2f(s_m[w * kMaxRep + r] - mx);
      lsum += s_l[w * kMaxRep + r] * c;
      acc += s_acc[(w * kMaxRep + r) * HD + d] * c;
    }
    if (out != nullptr) {
      store(out + i, lsum == 0.f ? 0.f : acc / lsum);
    } else {
      float* row = ws + r * ws_stride;
      row[d] = acc;
      if (d == 0) {
        row[HD] = mx;
        row[HD + 1] = lsum;
      }
    }
  }
}

// Merge the splits of one query vector (block x) in index order: out[x] =
// sum_z acc_z 2^(m_z - M) / sum_z l_z 2^(m_z - M), M = max_z m_z; zeros
// when no split saw a key. ws [vectors, splits, HD + 2] (acc, m, l).
// A split with l == 0 adds nothing: its acc is never read.
template <int HD>
__global__ void __launch_bounds__(HD < 32 ? 32 : HD)
split_merge_kernel(const float* __restrict__ ws,
                   __nv_bfloat16* __restrict__ out, int splits) {
  const int d = threadIdx.x;
  if (d >= HD) return;
  const float* w = ws + static_cast<long long>(blockIdx.x) * splits *
                            (HD + 2);
  float mx = kNegInf;
  for (int z = 0; z < splits; ++z) mx = fmaxf(mx, w[z * (HD + 2) + HD]);
  float lsum = 0.f, acc = 0.f;
  for (int z = 0; z < splits; ++z) {
    const float* row = w + z * (HD + 2);
    const float lz = row[HD + 1];
    if (lz > 0.f) {
      const float c = exp2f(row[HD] - mx);
      lsum += lz * c;
      acc += row[d] * c;
    }
  }
  store(out + static_cast<long long>(blockIdx.x) * HD + d,
        lsum == 0.f ? 0.f : acc / lsum);
}

}  // namespace pt_attn
