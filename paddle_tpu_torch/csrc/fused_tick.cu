// Fused mixed prefill/decode tick attention (K3) for Hopper, sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_tick.py:
// _fused_tick_pallas -> pallas_call(_fused_tick_kernel). Same function:
// one serving tick's attention in one launch. Each slot carries C query
// rows starting at absolute position t0[s] (a prompt chunk at its prefix
// offset, or a decode row in row 0); row c attends to key positions
// <= t0[s] + c, and ONLY through the pages that the schedule lists for
// the slot. The schedule (sched_slot, sched_page) is slot-major, in page
// order, with pad entries carrying slot == S at its end; a page it does
// not list is never read. A slot with last[s] < 0 is idle and writes
// zeros. Every row of out is written: rows past a slot's take (chunk
// padding, rows 1.. of a decode slot) hold finite values the caller
// discards. GQA in-kernel; online softmax in f32 with the -1e30 mask.
//
// Layouts (row-major, contiguous):
//   q                    [S, C, nh, hd]     f32 or bf16
//   k/v pages            [P, pg, kvh, hd]   same type as q
//   block_tables         [S, W]             int32, the live slice
//   t0, last             [S]                int32 (last = t0 + take - 1)
//   sched_slot/page      [G]                int32
//   out                  [S, C, nh, hd]     same type as q
//
// What bounds it on this card, at the serving shapes of Llama-2-7B
// (S = 8, 32 heads, hd = 128, 16-token pages): on a decode-only tick
// (C = 1) the K/V bytes of the scheduled pages, two orders of magnitude
// below the ridge point; on an admission tick (C = 512, prompts of a few
// hundred to ~2k tokens) bytes and bf16 tensor-core operations are of
// one order (chip_smoke.py's admission tick: the live rows of q, every
// row of out and the scheduled K/V are 174 MB, 0.052 ms at 3.35 TB/s;
// 4 * hd * nh FLOPs per visible key and row are 28.8 GFLOP, 0.029 ms at
// 989 TFLOP/s).
//
// The Pallas grid walks the schedule in order and carries the softmax
// state of a slot across its run in VMEM scratch. Blocks here run in no
// order, so each block finds its slot's run [lo, hi) in sched_slot by
// binary search and walks it itself. Two block shapes, picked by C:
//
// - C == 1 (the steady state, every live slot a decode row): K1's design
//   and code (decode_attend in attention_common.cuh), with key j found
//   through the run's schedule entry lo + j / pg instead of the block
//   table's column j / pg. One block per (slot, kv head) carries the kv
//   head's rep query heads; 8 warps take the keys round-robin.
// - C >= 2: one block per (slot, kv head, tile of rows). The tile holds
//   64 query vectors: 64 / rep rows times the rep query heads of the kv
//   head, so each K/V row gathered into shared memory serves the whole
//   GQA group and the whole row tile. The block walks its run in tiles
//   of 32 key positions up to the tile's causal frontier
//   min(t0 + last row, last); key rows past it are neither read nor
//   computed, and a tile of rows wholly past the slot's take writes
//   zeros without reading anything (RowTile and stage_keys below, shared
//   by both tile kernels). In bf16 both products run on mma.sync
//   m16n8k16 tensor-core tiles with f32 accumulators: 4 warps of 16
//   query vectors each, Q fragments held in registers for the whole
//   walk, probabilities rounded to bf16 for P V (the plain version
//   rounds them to q's type too). In f32 they run SIMT, so f32 keeps f32
//   products: each thread keeps 4 query vectors' softmax state and a
//   4 x (hd / 8) slice of their accumulators in registers and computes a
//   4 x 4 block of scores from shared memory.
//
// What it does not do yet: wgmma, TMA or cp.async pipelining (a tile's
// loads and products do not overlap), split-K over pages for long
// single rows. Pool offsets are computed in 64 bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "attention_common.cuh"

namespace {

using namespace pt_attn;

// first index in the sorted a[0, n) holding a value >= x
__device__ __forceinline__ int first_at_least(const int* __restrict__ a,
                                              int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// ----------------------------------------------------------- C == 1

constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;

template <typename T, int HD>
__global__ void __launch_bounds__(kDecThreads)
fused_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ t0s,
                    const int* __restrict__ lasts,
                    const int* __restrict__ ss, const int* __restrict__ sp,
                    T* __restrict__ out, int nh, int kvh, int pg, int W,
                    int G, float scale) {
  const int s = blockIdx.x;
  const int g = blockIdx.y;
  const int rep = nh / kvh;
  const long long t0 = t0s[s];
  const long long last = lasts[s];
  const long long lim = t0 < last ? t0 : last;   // row 0's frontier
  int lo = 0, n_keys = 0;               // an idle slot sees no key: zeros
  if (last >= 0) {
    lo = first_at_least(ss, G, s);
    n_keys = (first_at_least(ss, G, s + 1) - lo) * pg;
  }
  const int* row_bt = bt + static_cast<long long>(s) * W;
  const long long at = (static_cast<long long>(s) * nh + g * rep) * HD;
  decode_attend<T, HD, kDecWarps>(
      q + at, kp, vp, out + at, rep, kvh, g, n_keys,
      [=](int j) -> long long {
        const int pidx = sp[lo + j / pg];
        const int off = j % pg;
        if (pidx < 0 || pidx >= W ||
            static_cast<long long>(pidx) * pg + off > lim)
          return -1;
        return static_cast<long long>(row_bt[pidx]) * pg + off;
      },
      scale);
}

// ------------------------------------------ C >= 2: the row-tile walk

constexpr int kRowThreads = 128;
constexpr int kVecs = 64;     // query vectors (rows x GQA heads) per block
constexpr int kKeys = 32;     // key positions per shared-memory tile

// Block (s, g, z) of a row-tile kernel: slot s, kv head g, and query
// vectors v = 0 .. nvec - 1 of the z-th tile of rows, vector v being row
// r0 + v / rep of the chunk under query head g * rep + v % rep.
struct RowTile {
  int s, g, rep, nvec, r0, C, nh;
  long long t0, last;
  long long frontier;   // causal frontier: min(t0 + the last row, last)

  __device__ __forceinline__ RowTile(const int* t0s, const int* lasts,
                                     int C_, int nh_, int kvh)
      : s(blockIdx.x), g(blockIdx.y), rep(nh_ / kvh), C(C_), nh(nh_) {
    const int R = kVecs / rep;          // chunk rows per block
    nvec = R * rep;
    r0 = blockIdx.z * R;
    const int rows = (C - r0) < R ? (C - r0) : R;
    t0 = t0s[s];
    last = lasts[s];
    frontier = t0 + r0 + rows - 1;
    if (last < frontier) frontier = last;
  }
  // an idle slot, or rows wholly past the slot's take: read nothing
  __device__ __forceinline__ bool empty() const {
    return last < 0 || t0 + r0 > last;
  }
  // vector v's row of hd elements in q and out; -1 when v is no row
  __device__ __forceinline__ long long vec(int v) const {
    const int row = r0 + v / rep;
    if (v >= nvec || row >= C) return -1;
    return (static_cast<long long>(s) * C + row) * nh + g * rep + v % rep;
  }
  // vector v's causal limit min(t0 + row, last); -1 when v is no row
  __device__ __forceinline__ long long limit(int v) const {
    const int row = r0 + v / rep;
    if (v >= nvec || row >= C) return -1;
    return t0 + row < last ? t0 + row : last;
  }
};

template <typename T, int HD>
__device__ __forceinline__ void zero_tile(const RowTile& t,
                                          T* __restrict__ out) {
  for (int i = threadIdx.x; i < t.nvec * HD; i += blockDim.x) {
    const long long at = t.vec(i / HD);
    if (at >= 0) store(out + at * HD + i % HD, 0.f);
  }
}

// The slot's run of the schedule: entries lo .. lo + n_pos / pg - 1.
struct KeyRun {
  int lo, n_pos;
  const int* row_bt;
  __device__ __forceinline__ KeyRun(const RowTile& t, const int* ss,
                                    const int* bt, int G, int W, int pg)
      : lo(first_at_least(ss, G, t.s)),
        row_bt(bt + static_cast<long long>(t.s) * W) {
    n_pos = (first_at_least(ss, G, t.s + 1) - lo) * pg;
  }
};

// Stage the key tile at run position i0: thread k < kKeys writes key
// i0 + k's pool offset (its K/V row under kv head g) and absolute
// position into s_base[k] and s_pos[k], or -1 for a key that no row of
// the tile may see (past the frontier, past the run, or a schedule entry
// outside the table). A barrier for the whole block: returns whether any
// key of the tile is visible.
template <int HD>
__device__ __forceinline__ bool stage_keys(const RowTile& t,
                                           const KeyRun& run, int i0,
                                           const int* __restrict__ sp,
                                           int pg, int W, int kvh,
                                           long long* s_base, int* s_pos) {
  int vis = 0;
  if (threadIdx.x < kKeys) {
    const int i = i0 + threadIdx.x;
    long long base = -1;
    int pos = -1;
    if (i < run.n_pos) {
      const int pidx = sp[run.lo + i / pg];
      const int off = i % pg;
      const long long p = static_cast<long long>(pidx) * pg + off;
      if (pidx >= 0 && pidx < W && p <= t.frontier) {
        pos = static_cast<int>(p);
        base = ((static_cast<long long>(run.row_bt[pidx]) * pg + off) * kvh +
                t.g) * HD;
        vis = 1;
      }
    }
    s_base[threadIdx.x] = base;
    s_pos[threadIdx.x] = pos;
  }
  return __syncthreads_or(vis) != 0;
}

// ------------------------------------------------------ C >= 2, f32

constexpr int kVpt = 4;       // query vectors per thread
constexpr int kGroup = 8;     // threads sharing a group of kVpt vectors
constexpr int kKpt = kKeys / kGroup;   // scores per thread and vector
static_assert(kVecs == kVpt * kRowThreads / kGroup, "thread layout");

template <int HD>
constexpr size_t rows_smem_bytes() {
  return kKeys * (sizeof(long long) + sizeof(int)) +
         sizeof(float) * ((kVecs + 2 * kKeys) * (HD + 1) +
                          kVecs * (kKeys + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kRowThreads)
fused_rows_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const int* __restrict__ bt,
                  const int* __restrict__ t0s, const int* __restrict__ lasts,
                  const int* __restrict__ ss, const int* __restrict__ sp,
                  T* __restrict__ out, int C, int nh, int kvh, int pg, int W,
                  int G, float scale) {
  constexpr int DPT = HD / kGroup;      // accumulator dims per thread
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int LD = HD + 1;            // padded f32 row: no bank conflicts
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // per key of the tile: pool offset of its K/V row and its absolute
  // position, or -1 when no row of the tile may see it
  long long* s_base = reinterpret_cast<long long*>(smem_raw);
  int* s_pos = reinterpret_cast<int*>(s_base + kKeys);
  float* s_q = reinterpret_cast<float*>(s_pos + kKeys);   // [kVecs][LD]
  float* s_k = s_q + kVecs * LD;                          // [kKeys][LD]
  float* s_v = s_k + kKeys * LD;                          // [kKeys][LD]
  float* s_p = s_v + kKeys * LD;                          // [kVecs][kKeys+1]

  const RowTile t(t0s, lasts, C, nh, kvh);
  if (t.empty()) {
    zero_tile<T, HD>(t, out);
    return;
  }
  const int tr = threadIdx.x / kGroup;  // this thread's vector group
  const int tk = threadIdx.x % kGroup;

  for (int i = threadIdx.x; i < kVecs * HD; i += kRowThreads) {
    const long long at = t.vec(i / HD);
    s_q[(i / HD) * LD + i % HD] = at >= 0 ? to_f32(q[at * HD + i % HD]) : 0.f;
  }
  long long lim[kVpt];                  // each vector's causal limit
  float m[kVpt], l[kVpt], acc[kVpt][DPT];
#pragma unroll
  for (int i = 0; i < kVpt; ++i) {
    lim[i] = t.limit(tr * kVpt + i);
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  const KeyRun run(t, ss, bt, G, W, pg);
  for (int i0 = 0; i0 < run.n_pos; i0 += kKeys) {
    if (!stage_keys<HD>(t, run, i0, sp, pg, W, kvh, s_base, s_pos))
      continue;   // nothing here is visible

    // gather the tile's K and V rows through the block table
    for (int i = threadIdx.x; i < kKeys * (HD / VEC); i += kRowThreads) {
      const int kk = i / (HD / VEC);
      const int c = (i % (HD / VEC)) * VEC;
      const long long base = s_base[kk];
      float kx[VEC], vx[VEC];
      if (base >= 0) {
        load16(kp + base + c, kx);
        load16(vp + base + c, vx);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s_k[kk * LD + c + e] = kx[e];
        s_v[kk * LD + c + e] = vx[e];
      }
    }
    __syncthreads();

    // scores of this thread's kVpt vectors against keys tk + kGroup * j
    float sc[kVpt][kKpt];
#pragma unroll
    for (int i = 0; i < kVpt; ++i) {
#pragma unroll
      for (int j = 0; j < kKpt; ++j) sc[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qd[kVpt], kd[kKpt];
#pragma unroll
      for (int i = 0; i < kVpt; ++i) qd[i] = s_q[(tr * kVpt + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kKpt; ++j) kd[j] = s_k[(tk + kGroup * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kVpt; ++i) {
#pragma unroll
        for (int j = 0; j < kKpt; ++j) sc[i][j] += qd[i] * kd[j];
      }
    }

    // online softmax per vector; probabilities to shared memory
#pragma unroll
    for (int i = 0; i < kVpt; ++i) {
      bool ok[kKpt];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKpt; ++j) {
        const int pos = s_pos[tk + kGroup * j];
        ok[j] = pos >= 0 && pos <= lim[i];
        sc[i][j] = ok[j] ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = lanes_max<kGroup>(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kKpt; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        psum += p;
        s_p[(tr * kVpt + i) * (kKeys + 1) + tk + kGroup * j] = p;
      }
      l[i] = l[i] * corr + lanes_sum<kGroup>(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
    }
    __syncwarp();      // a vector group's kGroup lanes share one warp

    // acc += P V over the tile's keys; dims tk + kGroup * c
#pragma unroll 4
    for (int kk = 0; kk < kKeys; ++kk) {
      float pk[kVpt];
#pragma unroll
      for (int i = 0; i < kVpt; ++i)
        pk[i] = s_p[(tr * kVpt + i) * (kKeys + 1) + kk];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const float vv = s_v[kk * LD + tk + kGroup * c];
#pragma unroll
        for (int i = 0; i < kVpt; ++i) acc[i][c] += pk[i] * vv;
      }
    }
    __syncthreads();   // the next tile rewrites s_base .. s_p
  }

#pragma unroll
  for (int i = 0; i < kVpt; ++i) {
    const long long at = t.vec(tr * kVpt + i);
    if (at >= 0) {
      T* o = out + at * HD;
#pragma unroll
      for (int c = 0; c < DPT; ++c)
        store(o + tk + kGroup * c, l[i] == 0.f ? 0.f : acc[i][c] / l[i]);
    }
  }
}

// ---------------------------------------------- C >= 2, bf16: tensor cores
//
// The same tiling and walk as fused_rows_kernel, with the two products
// on mma.sync m16n8k16 bf16 tiles and f32 accumulators: each of the 4
// warps owns 16 query vectors, holds their Q fragments in registers for
// the whole walk, and keeps its scores, the online softmax state of its
// fragment rows and a 16 x hd accumulator in registers. The
// probabilities are rounded to bf16 for P V, as the plain version rounds
// them to q's type. The fragment helpers (mma_bf16, pack_bf16, ld32,
// quad_max, quad_sum) are in attention_common.cuh.

template <int HD>
__global__ void __launch_bounds__(kRowThreads)
fused_rows_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ kp,
                      const __nv_bfloat16* __restrict__ vp,
                      const int* __restrict__ bt, const int* __restrict__ t0s,
                      const int* __restrict__ lasts,
                      const int* __restrict__ ss, const int* __restrict__ sp,
                      __nv_bfloat16* __restrict__ out, int C, int nh, int kvh,
                      int pg, int W, int G, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int QP = HD + 8;        // padded row of sQ and sK (bf16)
  constexpr int VP = kKeys + 8;     // padded row of sVt, V transposed
  constexpr int CH = HD / 8;        // 16-byte chunks in a row
  constexpr int KS = HD / 16;       // k-steps of Q K^T
  constexpr int NS = kKeys / 8;     // n-tiles of the scores
  constexpr int NO = HD / 8;        // n-tiles of the accumulator
  static_assert(kRowThreads == 4 * 32 && kVecs == 4 * 16, "4 warps x 16");
  __shared__ __align__(16) bf16 sQ[kVecs * QP];
  __shared__ __align__(16) bf16 sK[kKeys * QP];
  __shared__ __align__(16) bf16 sVt[HD * VP];
  __shared__ long long s_base[kKeys];
  __shared__ int s_pos[kKeys];

  const RowTile t(t0s, lasts, C, nh, kvh);
  if (t.empty()) {
    zero_tile<bf16, HD>(t, out);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int fr = lane >> 2;         // fragment row (and fr + 8)
  const int fc = (lane & 3) * 2;    // fragment column pair

  for (int i = threadIdx.x; i < kVecs * CH; i += kRowThreads) {
    const long long at = t.vec(i / CH);
    const int c = (i % CH) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (at >= 0) x = __ldg(reinterpret_cast<const uint4*>(q + at * HD + c));
    *reinterpret_cast<uint4*>(&sQ[(i / CH) * QP + c]) = x;
  }
  long long lim[2];                 // causal limits of rows fr, fr + 8
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lim[h] = t.limit(warp * 16 + fr + 8 * h);
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }
  __syncthreads();
  uint32_t qa[KS][4];
  const bf16* qw = sQ + warp * 16 * QP;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    qa[k][0] = ld32(qw + fr * QP + k * 16 + fc);
    qa[k][1] = ld32(qw + (fr + 8) * QP + k * 16 + fc);
    qa[k][2] = ld32(qw + fr * QP + k * 16 + fc + 8);
    qa[k][3] = ld32(qw + (fr + 8) * QP + k * 16 + fc + 8);
  }

  const KeyRun run(t, ss, bt, G, W, pg);
  for (int i0 = 0; i0 < run.n_pos; i0 += kKeys) {
    if (!stage_keys<HD>(t, run, i0, sp, pg, W, kvh, s_base, s_pos))
      continue;   // nothing here is visible

    // K rows as they lie; V transposed (consecutive lanes take
    // consecutive keys of one chunk: no bank conflicts on the stores)
    for (int i = threadIdx.x; i < kKeys * CH; i += kRowThreads) {
      const int kk = i / CH;
      const int c = (i % CH) * 8;
      const long long base = s_base[kk];
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (base >= 0) x = __ldg(reinterpret_cast<const uint4*>(kp + base + c));
      *reinterpret_cast<uint4*>(&sK[kk * QP + c]) = x;
    }
    for (int i = threadIdx.x; i < kKeys * CH; i += kRowThreads) {
      const int kk = i % kKeys;
      const int c = (i / kKeys) * 8;
      const long long base = s_base[kk];
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (base >= 0) x = __ldg(reinterpret_cast<const uint4*>(vp + base + c));
      const bf16* xv = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int e = 0; e < 8; ++e) sVt[(c + e) * VP + kk] = xv[e];
    }
    __syncthreads();

    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < KS; ++k) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const bf16* kr = sK + (n * 8 + fr) * QP + k * 16 + fc;
        mma_bf16(sc[n], qa[k], ld32(kr), ld32(kr + 8));
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
          const int pos = s_pos[n * 8 + fc + e];
          ok[n][e] = pos >= 0 && pos <= lim[h];
          const float x = ok[n][e] ? sc[n][2 * h + e] * scale : kNegInf;
          sc[n][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = quad_max(mx);
      const float m_new = fmaxf(m[h], mx);
      const float corr = expf(m[h] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ok[n][e] ? expf(sc[n][2 * h + e] - m_new) : 0.f;
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
    // fragment of one k-step
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                              pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                              pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                              pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const bf16* vr = sVt + (n * 8 + fr) * VP + j * 16 + fc;
        mma_bf16(o[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
    __syncthreads();   // the next tile rewrites s_base .. sVt
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long at = t.vec(warp * 16 + fr + 8 * h);
    if (at >= 0) {
      bf16* op = out + at * HD;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const float a = l[h] == 0.f ? 0.f : o[n][2 * h] / l[h];
        const float b = l[h] == 0.f ? 0.f : o[n][2 * h + 1] / l[h];
        *reinterpret_cast<uint32_t*>(op + n * 8 + fc) = pack_bf16(a, b);
      }
    }
  }
}

// ------------------------------------------------------------- launch

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const int* bt;
  const int* t0;
  const int* last;
  const int* ss;
  const int* sp;
  void* out;
  int S, C, nh, kvh, pg, W, G;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD>
cudaError_t launch_hd(const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.kp);
  const T* vp = static_cast<const T*>(a.vp);
  T* out = static_cast<T*>(a.out);
  if (a.C == 1) {
    const dim3 grid(a.S, a.kvh);
    fused_decode_kernel<T, HD><<<grid, kDecThreads, 0, a.stream>>>(
        q, kp, vp, a.bt, a.t0, a.last, a.ss, a.sp, out, a.nh, a.kvh, a.pg,
        a.W, a.G, a.scale);
    return cudaGetLastError();
  }
  const int R = kVecs / (a.nh / a.kvh);
  const int tiles = (a.C + R - 1) / R;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(a.S, a.kvh, tiles);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    fused_rows_mma_kernel<HD><<<grid, kRowThreads, 0, a.stream>>>(
        q, kp, vp, a.bt, a.t0, a.last, a.ss, a.sp, out, a.C, a.nh, a.kvh,
        a.pg, a.W, a.G, a.scale);
    return cudaGetLastError();
  } else {
    constexpr size_t smem = rows_smem_bytes<HD>();
    const cudaError_t e = cudaFuncSetAttribute(
        fused_rows_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    fused_rows_kernel<T, HD><<<grid, kRowThreads, smem, a.stream>>>(
        q, kp, vp, a.bt, a.t0, a.last, a.ss, a.sp, out, a.C, a.nh, a.kvh,
        a.pg, a.W, a.G, a.scale);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch(const Args& a, int hd) {
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(a);
    case 64:
      return launch_hd<T, 64>(a);
    case 128:
      return launch_hd<T, 128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int fused_tick_launch(const void* q, const void* k_pages,
                                 const void* v_pages,
                                 const void* block_tables, const void* t0,
                                 const void* last, const void* sched_slot,
                                 const void* sched_page, void* out, int S,
                                 int C, int nh, int kvh, int hd, int pg,
                                 int W, int G, int dtype, float sm_scale,
                                 void* stream) {
  if (S <= 0 || C <= 0) return cudaSuccess;
  if (kvh <= 0 || nh % kvh != 0 || nh / kvh > pt_attn::kMaxRep ||
      kvh > 65535 || pg <= 0 || W <= 0 || G < 0 ||
      static_cast<long long>(G) * pg > INT_MAX)
    return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages,
               static_cast<const int*>(block_tables),
               static_cast<const int*>(t0), static_cast<const int*>(last),
               static_cast<const int*>(sched_slot),
               static_cast<const int*>(sched_page), out, S, C, nh, kvh, pg,
               W, G, sm_scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch<float>(a, hd);
  if (dtype == 1) return launch<__nv_bfloat16>(a, hd);
  return cudaErrorInvalidValue;
}
