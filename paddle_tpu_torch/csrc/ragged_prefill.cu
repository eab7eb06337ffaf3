// Ragged prefill attention over the paged KV pool (K2) for Hopper,
// sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/ragged_prefill.py:
// _ragged_prefill_kernel, launched by _ragged_prefill_pallas
// (pallas_call). Same function: each slot carries one packed prompt chunk
// of C query rows starting at absolute position t0[s]; row c attends
// causally to key positions <= min(t0[s] + c, last[s], maxp * pg - 1)
// through the slot's block table; a slot with last[s] < 0 (the
// scheduler's idle sentinel) is skipped and writes zeros; GQA in-kernel;
// online softmax in f32 with the -1e30 mask.
//
// Layouts (row-major, contiguous):
//   q            [S, C, nh, hd]       f32 or bf16
//   k/v pages    [P, pg, kvh, hd]     same type as q
//   block_tables [S, maxp]            int32 page ids
//   t0, last     [S]                  int32 (last = t0 + take - 1, or -1)
//   out          [S, C, nh, hd]       same type as q
//
// What bounds it on this card: at the serving shapes of Llama-2-7B (8
// slots of 512-row chunks over up to ~2k keys, 32 heads of 128) bytes
// and bf16 tensor-core operations are of one order (chip_smoke.py's k2
// phase: 0.055 ms of bytes at 3.35 TB/s against 0.03 ms of operations at
// 989 TFLOP/s). So the kernel must read each K/V row few times and keep
// the tensor cores fed while it gathers.
//
// bf16: tensor cores fed by asynchronous copies.
// - One block of 4 warps per (slot, kv head, tile of 64 query vectors):
//   64 / rep chunk rows times the rep query heads of the kv head, so each
//   K/V row gathered serves the whole GQA group and the whole row tile.
//   Blocks of the last row tiles (the longest causal walks) are
//   scheduled first, so the tail of the grid is short tiles.
// - The block walks keys in tiles of 64 positions up to the tile's causal
//   frontier min(t0 + its last row, last, maxp * pg - 1). Each key tile's
//   K and V rows are gathered through the block table with 16-byte
//   cp.async into a ring of two stages: tile i + 1's gather is in flight
//   while tile i's products run. Keys past the frontier are zero-filled
//   without being read, and block_tables is never indexed past it (nor
//   past its width). A tile of rows wholly past last writes zeros and
//   reads nothing.
// - Both products on mma.sync m16n8k16 bf16 with f32 accumulators; each
//   warp loads its 16 query vectors' Q fragments from device memory into
//   registers once and holds them for the whole walk; K fragments by
//   ldmatrix, V fragments by ldmatrix.trans, so V is consumed as it lies.
//   Rows in shared memory are padded by 16 bytes, which keeps every
//   ldmatrix free of bank conflicts. The softmax runs in base 2 (exp2f,
//   one instruction). Probabilities are rounded to bf16 for P V, as the
//   plain version rounds them to q's type. A warp skips a key tile that
//   none of its vectors may see.
// - Shared memory holds only the ring (70 KB at hd 128), so three blocks
//   share an SM; the output goes through the drained ring to 16-byte
//   stores. Pool offsets are computed in 64 bits.
//
// f32: the SIMT kernel of the first port (f32 keeps f32 products; no
// TF32): one block per (slot, query head, 32 rows), 16-key tiles staged
// in shared memory as f32, 4 threads per row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "attention_common.cuh"

namespace {

using namespace pt_attn;

// ------------------------------------------------------ f32: SIMT

constexpr int kThreads = 128;
constexpr int kRows = 32;             // query rows per block
constexpr int kTpr = kThreads / kRows;  // threads per query row (4)
constexpr int kKeys = 16;             // key positions per shared tile
constexpr int kKpt = kKeys / kTpr;    // scores per thread per tile (4)

// reduce over the kTpr consecutive lanes that share one query row
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = kTpr / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = kTpr / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
ragged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                      const T* __restrict__ vp, const int* __restrict__ bt,
                      const int* __restrict__ t0s,
                      const int* __restrict__ lasts, T* __restrict__ out,
                      int C, int nh, int kvh, int pg, int maxp,
                      float scale) {
  constexpr int DPT = HD / kTpr;      // output dims per thread
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int g = h / (nh / kvh);
  const int r = threadIdx.x / kTpr;   // this thread's row in the tile
  const int sub = threadIdx.x % kTpr;
  const int row = r0 + r;             // its row in the chunk
  const long long t0 = t0s[s];
  const long long last = lasts[s];
  const long long span = static_cast<long long>(maxp) * pg;

  // keys visible to the tile: up to its last row's causal frontier,
  // the slot's last written position and the table's span
  const int rows = (C - r0) < kRows ? (C - r0) : kRows;
  long long hi = t0 + r0 + rows - 1;
  if (last < hi) hi = last;
  if (span - 1 < hi) hi = span - 1;
  const long long pos = t0 + row;     // absolute position of this row

  __shared__ float sq[kRows][HD + 1];
  __shared__ float sk[kKeys][HD + 1];
  __shared__ float sv[kKeys][HD + 1];
  __shared__ float sp[kRows][kKeys + 1];

  for (int i = threadIdx.x; i < kRows * HD; i += kThreads) {
    const int rr = i / HD;
    const int d = i % HD;
    const int cr = r0 + rr;
    sq[rr][d] = (cr < C && hi >= 0)
        ? to_f32(q[((static_cast<long long>(s) * C + cr) * nh + h) * HD + d])
        : 0.f;
  }

  float acc[DPT];
#pragma unroll
  for (int e = 0; e < DPT; ++e) acc[e] = 0.f;
  float m = kNegInf, l = 0.f;
  const int* row_bt = bt + static_cast<long long>(s) * maxp;

  // hi < 0: an idle slot (last < 0) or nothing visible — skip every key
  for (long long k0 = 0; k0 <= hi; k0 += kKeys) {
    __syncthreads();   // previous tile fully consumed (and sq written)
    for (int i = threadIdx.x; i < kKeys * HD; i += kThreads) {
      const int kk = i / HD;
      const int d = i % HD;
      const long long j = k0 + kk;
      if (j <= hi) {
        const long long page = row_bt[j / pg];
        const long long idx = ((page * pg + j % pg) * kvh + g) * HD + d;
        sk[kk][d] = to_f32(kp[idx]);
        sv[kk][d] = to_f32(vp[idx]);
      } else {
        sk[kk][d] = 0.f;
        sv[kk][d] = 0.f;
      }
    }
    __syncthreads();

    float sc[kKpt];
    bool ok[kKpt];
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kKpt; ++i) {
      const int kk = sub + kTpr * i;
      const long long j = k0 + kk;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot += sq[r][d] * sk[kk][d];
      ok[i] = j <= hi && j <= pos;
      sc[i] = ok[i] ? dot * scale : kNegInf;
      mx = fmaxf(mx, sc[i]);
    }
    mx = row_max(mx);
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kKpt; ++i) {
      const float p = ok[i] ? expf(sc[i] - m_new) : 0.f;
      psum += p;
      sp[r][sub + kTpr * i] = p;
    }
    l = l * corr + row_sum(psum);
    m = m_new;
    __syncwarp();      // the row's 4 threads share one warp
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = sub + kTpr * e;
      float a = acc[e] * corr;
#pragma unroll
      for (int kk = 0; kk < kKeys; ++kk) a += sp[r][kk] * sv[kk][d];
      acc[e] = a;
    }
    __syncwarp();      // sp is rewritten by the next tile
  }

  if (row < C) {
    T* o = out + ((static_cast<long long>(s) * C + row) * nh + h) * HD;
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      store(o + sub + kTpr * e, l == 0.f ? 0.f : acc[e] / l);
  }
}

// ---------------------------------- bf16: mma.sync fed by cp.async

constexpr int kMmaThreads = 128;  // 4 warps x 16 query vectors
constexpr int kVecs = 64;         // query vectors (rows x GQA heads) a block
constexpr int kKeyTile = 64;      // key positions per stage
constexpr int kStages = 2;        // ring of key tiles in shared memory

// shared rows are padded by 16 bytes: every ldmatrix is conflict-free
template <int HD>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (HD + 8) * kStages * 2 * kKeyTile;
}

// Block (s, g, z) of the bf16 kernel: slot s, kv head g and query vectors
// v = 0 .. nvec - 1 of a tile of rows, vector v being row r0 + v / rep of
// the chunk under query head g * rep + v % rep. The grid's z runs the row
// tiles from the last (longest causal walk) to the first.
struct RowTile {
  int s, g, rep, nvec, r0, C, nh;
  long long t0;
  long long hi;   // the last key any vector may see; -1: read nothing

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

template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 3)
ragged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ kp,
                          const __nv_bfloat16* __restrict__ vp,
                          const int* __restrict__ bt,
                          const int* __restrict__ t0s,
                          const int* __restrict__ lasts,
                          __nv_bfloat16* __restrict__ out, int C, int nh,
                          int kvh, int pg, int maxp, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int P = HD + 8;              // padded row pitch, elements
  constexpr int CH = HD / 8;             // 16-byte chunks in a row
  constexpr int KS = HD / 16;            // k-steps of Q K^T
  constexpr int NS = kKeyTile / 8;       // n-tiles of the scores
  constexpr int NO = HD / 8;             // n-tiles of the accumulator
  static_assert(kMmaThreads == 4 * 32 && kVecs == 4 * 16, "4 warps x 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sKV = reinterpret_cast<bf16*>(smem_raw);  // [kStages][K, V][64][P]

  const RowTile t(t0s, lasts, C, nh, kvh, pg, maxp);
  if (t.hi < 0) {                        // read nothing, write zeros
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
  const int n_tiles = static_cast<int>(t.hi / kKeyTile) + 1;
  const int* row_bt = bt + static_cast<long long>(t.s) * maxp;

  // gather key tile i into its stage: key j's row under kv head g, or
  // zeros without a read for a key past the frontier
  auto gather = [&](int i) {
    bf16* sk = sKV + (i % kStages) * 2 * kKeyTile * P;
    bf16* sv = sk + kKeyTile * P;
    for (int e = threadIdx.x; e < kKeyTile * CH; e += kMmaThreads) {
      const int kk = e / CH;
      const int c = (e % CH) * 8;
      const int j = i * kKeyTile + kk;   // hi < maxp * pg fits an int
      const bool ok = j <= t.hi;
      long long off = 0;
      if (ok)
        off = ((static_cast<long long>(row_bt[j / pg]) * pg + j % pg) * kvh +
               t.g) * HD + c;
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
    if (k0 <= warp_lim) {                // warp-uniform
      const bf16* sk = sKV + (i % kStages) * 2 * kKeyTile * P;
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
            ok[n][e] = k0 + n * 8 + fc + e <= lim[h];
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

// ------------------------------------------------------------- launch

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const int* bt;
  const int* t0;
  const int* last;
  void* out;
  int S, C, nh, kvh, pg, maxp;
  float scale;
  cudaStream_t stream;
};

template <int HD>
cudaError_t launch_f32(const Args& a) {
  if (a.nh > 65535) return cudaErrorInvalidValue;
  const dim3 grid(a.S, a.nh, (a.C + kRows - 1) / kRows);
  ragged_prefill_kernel<float, HD><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.kp),
      static_cast<const float*>(a.vp), a.bt, a.t0, a.last,
      static_cast<float*>(a.out), a.C, a.nh, a.kvh, a.pg, a.maxp, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const Args& a) {
  const int R = kVecs / (a.nh / a.kvh);      // chunk rows per block
  if (R < 1 || a.kvh > 65535) return cudaErrorInvalidValue;
  const int tiles = (a.C + R - 1) / R;
  if (tiles > 65535) return cudaErrorInvalidValue;
  constexpr size_t smem = mma_smem_bytes<HD>();
  const cudaError_t e = cudaFuncSetAttribute(
      ragged_prefill_mma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(a.S, a.kvh, tiles);
  ragged_prefill_mma_kernel<HD><<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.kp),
      static_cast<const __nv_bfloat16*>(a.vp), a.bt, a.t0, a.last,
      static_cast<__nv_bfloat16*>(a.out), a.C, a.nh, a.kvh, a.pg, a.maxp,
      a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const Args& a, int dtype) {
  if (dtype == 0) return launch_f32<HD>(a);
  if (dtype == 1) return launch_bf16<HD>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (at most 64 query heads per kv head).
// Returns a cudaError_t (0 = launched).
extern "C" int ragged_prefill_launch(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* block_tables,
                                     const void* t0, const void* last,
                                     void* out, int S, int C, int nh,
                                     int kvh, int hd, int pg, int maxp,
                                     int dtype, float sm_scale,
                                     void* stream) {
  if (S <= 0 || C <= 0) return cudaSuccess;
  if (kvh <= 0 || nh % kvh != 0 || pg <= 0 || maxp <= 0 ||
      static_cast<long long>(maxp) * pg > INT_MAX)
    return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages,
               static_cast<const int*>(block_tables),
               static_cast<const int*>(t0), static_cast<const int*>(last),
               out, S, C, nh, kvh, pg, maxp, sm_scale,
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
