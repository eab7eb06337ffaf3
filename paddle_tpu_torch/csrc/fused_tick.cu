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
// order, so each block finds its slot's run [lo, hi) in sched_slot and
// walks it itself. The run lists the slot's live-table columns in
// increasing order (build_schedule's): a key's position is never below
// its index in the run, so a walk by run index stops at the frontier.
//
// bf16, picked by C:
// - C == 1 (the steady state, every live slot a decode row): K1's
//   split-K body (paged_decode.cuh): one block per (slot, kv head, split
//   of the run), the split's schedule entries and their table pages
//   staged once in shared memory, 64-key tiles on a two-stage 16-byte
//   cp.async ring, mma.sync, and a merge kernel over the splits. The
//   split plan comes from W, the live slice's width: static per ladder
//   width.
// - C >= 2: K2's row-tile body (paged_prefill.cuh): one block of 4 warps
//   per (slot, kv head, 64 query vectors), long row tiles first, 64-key
//   tiles on the same kind of ring, Q fragments held in registers, K by
//   ldmatrix and V by ldmatrix.trans, base-2 softmax (two blocks a SM:
//   at three the run's key map spills); key i of the walk found through
//   the run (sp[lo + i / pg], then the live table), never through a
//   column the schedule does not list.
// The block finds its run with one pass of the whole block over
// sched_slot (slot_run), not a chain of dependent loads.
//
// f32 keeps the first port's SIMT kernels (f32 products, no TF32): at C == 1
// K1's f32 body (decode_attend) over the run found by binary search; at
// C >= 2 one block per (slot, kv head, 64 query vectors), 32-key tiles
// staged in shared memory, each thread holding 4 vectors' softmax state
// and a 4 x (hd / 8) slice of their accumulators (RowTile and
// stage_keys below).
//
// Pool offsets are computed in 64 bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "attention_common.cuh"
#include "paged_decode.cuh"
#include "paged_prefill.cuh"

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

// ----------------------------------------------------- f32, C == 1

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

// ------------------------------------------------- f32, C >= 2

constexpr int kRowThreads = 128;
constexpr int kKeys = 32;     // key positions per shared-memory tile

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
      if (pidx >= 0 && pidx < W && p <= t.hi) {
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

  const RowTile t(t0s, lasts, C, nh, kvh, pg, W);
  if (t.hi < 0) {
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

// ------------------------------------------------------------- bf16

// [lo, hi) of slot s's run in the sorted sched_slot[0, G): the entries
// below s and up to s, counted by the whole block in one pass (no chain
// of dependent loads), into run[0] and run[1]. A barrier for the block.
__device__ __forceinline__ void slot_run(const int* __restrict__ ss, int G,
                                         int s, int* run) {
  __shared__ int part[32][2];
  int below = 0, upto = 0;
  for (int i = threadIdx.x; i < G; i += blockDim.x) {
    const int v = ss[i];
    below += v < s;
    upto += v <= s;
  }
  below = __reduce_add_sync(0xffffffffu, below);
  upto = __reduce_add_sync(0xffffffffu, upto);
  if ((threadIdx.x & 31) == 0) {
    part[threadIdx.x >> 5][0] = below;
    part[threadIdx.x >> 5][1] = upto;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int lo = 0, hi = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      lo += part[w][0];
      hi += part[w][1];
    }
    run[0] = lo;
    run[1] = hi;
  }
  __syncthreads();
}

// C == 1: the split-K body of paged_decode.cuh over the slot's run.
// Split z holds run entries z * pps ..; entry e's page is the live
// table's column sp[lo + e], and its keys sit at positions sp[lo + e] *
// pg .. A key is visible at most up to row 0's frontier min(t0, last).
// The run lists columns in increasing order (build_schedule's), so a
// key's position is never below its index in the run, and the walk
// stops at index min(run keys, lim + 1): no schedule entry past it is
// read.
template <int HD>
__global__ void __launch_bounds__(kSplitThreads, 3)
fused_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ kp,
                          const __nv_bfloat16* __restrict__ vp,
                          const int* __restrict__ bt,
                          const int* __restrict__ t0s,
                          const int* __restrict__ lasts,
                          const int* __restrict__ ss,
                          const int* __restrict__ sp,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ ws, int nh, int kvh, int pg,
                          int W, int G, int pps, int splits, float scale) {
  __shared__ SplitPages pages;
  __shared__ int run[2];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s = blockIdx.x;
  const int g = blockIdx.y;
  const int z = blockIdx.z;
  const int rep = nh / kvh;
  const long long t0 = t0s[s];
  const long long last = lasts[s];
  const long long lim = t0 < last ? t0 : last;   // row 0's frontier
  const int e0 = z * pps;                // the split's first run entry
  long long n = 0;                       // an idle slot sees no key, nor
  if (last >= 0 && static_cast<long long>(e0) * pg <= lim) {  // a split
    slot_run(ss, G, s, run);             // past the frontier
    long long walk = static_cast<long long>(run[1] - run[0]) * pg;
    if (lim + 1 < walk) walk = lim + 1;
    n = walk - static_cast<long long>(e0) * pg;
    if (n < 0) n = 0;
    if (n > static_cast<long long>(pps) * pg)
      n = static_cast<long long>(pps) * pg;
    const int* run_sp = sp + run[0] + e0;
    const int* row_bt = bt + static_cast<long long>(s) * W;
    for (int e = threadIdx.x; e * static_cast<long long>(pg) < n;
         e += kSplitThreads) {
      const int pidx = run_sp[e];
      const bool ok = pidx >= 0 && pidx < W;
      pages.id[e] = ok ? row_bt[pidx] : -1;
      pages.base[e] = ok ? pidx * pg : 0;
    }
  }
  __syncthreads();
  const long long v0 = static_cast<long long>(s) * nh + g * rep;
  const bool direct = splits == 1;
  split_decode<HD>(q + v0 * HD, kp, vp, rep, kvh, g, pg, pages,
                   static_cast<int>(n), lim, scale,
                   direct ? out + v0 * HD : nullptr,
                   direct ? nullptr : ws + (v0 * splits + z) * (HD + 2),
                   static_cast<long long>(splits) * (HD + 2), smem_raw);
}

// C >= 2: K2's row-tile body (paged_prefill.cuh) over the slot's run:
// key i of the walk is run entry i / pg, the live table's column
// sp[lo + i / pg], at position sp[lo + i / pg] * pg + i % pg. The
// gathering thread of a key's first chunk records its position (or
// kNoPos: a key no row may see) for the mask. The run lists columns in
// increasing order, so the walk ends at index min(run keys - 1, hi),
// RowTile's frontier over the live slice.
constexpr int kNoPos = INT_MAX;
__shared__ int ring_pos[kStages * kKeyTile];   // the ring's key positions

struct RunKeys {
  const int* run_sp;  // the slot's run of sched_page
  const int* row_bt;  // the slot's row of the live table
  int pg, W;
  long long hi;       // RowTile::hi
  long long walk;     // the last key of the walk: min(run keys - 1, hi)

  __device__ __forceinline__ long long last() const { return walk; }
  // -1 past the walk, for a schedule entry outside the live table, or
  // past the frontier
  __device__ __forceinline__ long long row(int stage, int kk, int i,
                                           bool first) const {
    long long r = -1;
    int p = kNoPos;
    if (i <= walk) {
      const int pidx = run_sp[i / pg];
      const int off = i % pg;
      if (pidx >= 0 && pidx < W &&
          static_cast<long long>(pidx) * pg + off <= hi) {
        p = pidx * pg + off;
        r = static_cast<long long>(row_bt[pidx]) * pg + off;
      }
    }
    if (first) ring_pos[stage * kKeyTile + kk] = p;
    return r;
  }
  __device__ __forceinline__ long long pos(int stage, int kk,
                                           long long /*i*/) const {
    return ring_pos[stage * kKeyTile + kk];
  }
};

// Two blocks a SM, not K2's three: under three's 168-register cap the
// run's key map spills at hd 128 (60-100 bytes on the card); at two it
// takes 212 registers and spills nothing.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 2)
fused_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ kp,
                         const __nv_bfloat16* __restrict__ vp,
                         const int* __restrict__ bt,
                         const int* __restrict__ t0s,
                         const int* __restrict__ lasts,
                         const int* __restrict__ ss,
                         const int* __restrict__ sp,
                         __nv_bfloat16* __restrict__ out, int C, int nh,
                         int kvh, int pg, int W, int G, float scale) {
  __shared__ int run[2];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const RowTile t(t0s, lasts, C, nh, kvh, pg, W);
  int lo = 0;
  long long walk = -1;                   // no key
  if (t.hi >= 0) {                       // block-uniform
    slot_run(ss, G, t.s, run);
    lo = run[0];
    walk = static_cast<long long>(run[1] - lo) * pg - 1;
    if (t.hi < walk) walk = t.hi;
  }
  const RunKeys keys{sp + lo, bt + static_cast<long long>(t.s) * W, pg, W,
                     t.hi, walk};
  rows_mma_walk<HD>(q, kp, vp, out, t, keys, kvh, scale,
                    reinterpret_cast<__nv_bfloat16*>(smem_raw));
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
  float* ws;
  int S, C, nh, kvh, pg, W, G, pps, splits;
  float scale;
  cudaStream_t stream;
};

template <int HD>
cudaError_t launch_f32(const Args& a) {
  const float* q = static_cast<const float*>(a.q);
  const float* kp = static_cast<const float*>(a.kp);
  const float* vp = static_cast<const float*>(a.vp);
  float* out = static_cast<float*>(a.out);
  if (a.C == 1) {
    const dim3 grid(a.S, a.kvh);
    fused_decode_kernel<float, HD><<<grid, kDecThreads, 0, a.stream>>>(
        q, kp, vp, a.bt, a.t0, a.last, a.ss, a.sp, out, a.nh, a.kvh, a.pg,
        a.W, a.G, a.scale);
    return cudaGetLastError();
  }
  const int tiles = (a.C + kVecs / (a.nh / a.kvh) - 1) /
                    (kVecs / (a.nh / a.kvh));
  if (tiles > 65535) return cudaErrorInvalidValue;
  constexpr size_t smem = rows_smem_bytes<HD>();
  const cudaError_t e = cudaFuncSetAttribute(
      fused_rows_kernel<float, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(a.S, a.kvh, tiles);
  fused_rows_kernel<float, HD><<<grid, kRowThreads, smem, a.stream>>>(
      q, kp, vp, a.bt, a.t0, a.last, a.ss, a.sp, out, a.C, a.nh, a.kvh,
      a.pg, a.W, a.G, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const Args& a) {
  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* kp = static_cast<const bf16*>(a.kp);
  const bf16* vp = static_cast<const bf16*>(a.vp);
  bf16* out = static_cast<bf16*>(a.out);
  if (a.C == 1) {
    if (a.pps < 1 || a.pps > kMaxSplitPages || a.splits < 1 ||
        a.splits > 65535 ||
        static_cast<long long>(a.pps) * a.splits < a.W ||
        (a.splits > 1 && a.ws == nullptr))
      return cudaErrorInvalidValue;
    constexpr size_t smem = split_smem_bytes<HD>();
    cudaError_t e = cudaFuncSetAttribute(
        fused_decode_split_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    const dim3 grid(a.S, a.kvh, a.splits);
    fused_decode_split_kernel<HD><<<grid, kSplitThreads, smem, a.stream>>>(
        q, kp, vp, a.bt, a.t0, a.last, a.ss, a.sp, out, a.ws, a.nh, a.kvh,
        a.pg, a.W, a.G, a.pps, a.splits, a.scale);
    e = cudaGetLastError();
    if (e != cudaSuccess || a.splits == 1) return e;
    split_merge_kernel<HD><<<a.S * a.nh, HD < 32 ? 32 : HD, 0, a.stream>>>(
        a.ws, out, a.splits);
    return cudaGetLastError();
  }
  const int tiles = (a.C + kVecs / (a.nh / a.kvh) - 1) /
                    (kVecs / (a.nh / a.kvh));
  if (tiles > 65535) return cudaErrorInvalidValue;
  constexpr size_t smem = mma_smem_bytes<HD>();
  const cudaError_t e = cudaFuncSetAttribute(
      fused_prefill_mma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(a.S, a.kvh, tiles);
  fused_prefill_mma_kernel<HD><<<grid, kMmaThreads, smem, a.stream>>>(
      q, kp, vp, a.bt, a.t0, a.last, a.ss, a.sp, out, a.C, a.nh, a.kvh,
      a.pg, a.W, a.G, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const Args& a, int dtype) {
  if (dtype == 0) return launch_f32<HD>(a);
  if (dtype == 1) return launch_bf16<HD>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. At C == 1 bf16 takes the split plan
// (pages_per_split schedule entries a split, `splits` splits covering
// W) and, with more than one split, a float32 workspace of S * nh *
// splits * (hd + 2) elements; every other route ignores them. Returns a
// cudaError_t (0 = launched).
extern "C" int fused_tick_launch(const void* q, const void* k_pages,
                                 const void* v_pages,
                                 const void* block_tables, const void* t0,
                                 const void* last, const void* sched_slot,
                                 const void* sched_page, void* out,
                                 void* workspace, int S, int C, int nh,
                                 int kvh, int hd, int pg, int W, int G,
                                 int pages_per_split, int splits, int dtype,
                                 float sm_scale, void* stream) {
  if (S <= 0 || C <= 0) return cudaSuccess;
  if (kvh <= 0 || nh % kvh != 0 || nh / kvh > pt_attn::kMaxRep ||
      kvh > 65535 || pg <= 0 || W <= 0 || G < 0 ||
      static_cast<long long>(G) * pg > INT_MAX ||
      static_cast<long long>(W) * pg > INT_MAX)
    return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages,
               static_cast<const int*>(block_tables),
               static_cast<const int*>(t0), static_cast<const int*>(last),
               static_cast<const int*>(sched_slot),
               static_cast<const int*>(sched_page), out,
               static_cast<float*>(workspace), S, C, nh, kvh, pg, W, G,
               pages_per_split, splits, sm_scale,
               static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 16:
      return launch_hd<16>(a, dtype);
    case 64:
      return launch_hd<64>(a, dtype);
    case 128:
      return launch_hd<128>(a, dtype);
    default:
      return cudaErrorInvalidValue;
  }
}
