// Flash attention forward and backward (K4a, K4b) for Hopper, sm_90a.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
// _flash_fwd_pallas (K4a) and _flash_bwd_pallas (K4b, its dq kernel and
// its dk + dv kernel). Same functions:
//
//   forward   s = q k^T * scale, masked to -1e30 where causal and
//             q_pos < k_pos (positions from 0 in both: the diagonal is
//             aligned top-left, as the Pallas kernels align it);
//             o = softmax(s) v in q's type, lse = m + log(max(l, 1e-30))
//             in f32; a row that sees no key writes o = 0
//   backward  delta = rowsum(do * o) - dlse (dlse optional), in f32;
//             p = exp(s - lse), ds = p * (do v^T - delta);
//             dq = ds k * scale, dk = ds^T q * scale, dv = p^T do
//
// Layouts (row-major, contiguous; BH = batch * heads): q, o, do, dq
// [BH, Sq, hd]; k, v, dk, dv [BH, Sk, hd]; lse, delta, dlse [BH, Sq] f32.
// f32 or bf16; hd 16, 64 or 128; any Sq and Sk (the tail tiles are
// masked).
//
// What bounds it on this card: operations. At llama_350m's training shape
// (B = 8, 16 heads, S = 1024, hd = 64, causal) the forward does 2 * B * H *
// S^2 * hd = 17.2 GFLOP against 67 MB of q, k, v and o: 0.017 ms at 989
// TFLOP/s bf16 against 0.020 ms at 3.35 TB/s, so bytes and operations are
// of one order there; at Llama-2-7B's (S = 4096, hd = 128) operations lead
// by four times.
//
// Design. The Pallas grid carries the softmax state (or dq, or dk and dv)
// across its sequential kv (or q) axis in VMEM scratch. Blocks here run in
// no order, so each block owns one output tile and walks the other axis
// itself, in order: no atomics, and the gradients are the same bit for
// bit from run to run.
//
// - forward and dq: one block per (tile of 64 query rows, b*h), walking
//   tiles of 32 keys up to the tile's causal frontier (key tiles wholly
//   above the diagonal are neither read nor computed);
// - dk + dv: one block per (tile of keys, b*h), walking tiles of 32 query
//   rows from the first that can see the block's first key;
// - delta: the dq kernel computes its rows' delta from do and o, uses it,
//   and writes it for the dk + dv kernel, which the caller launches after
//   it on the same stream.
//
// bf16 runs the products on mma.sync m16n8k16 tensor-core tiles with f32
// accumulators (4 warps of 16 rows; probabilities and ds rounded to bf16
// for their products, as the plain version's bf16 operands round its). f32
// runs SIMT so that f32 keeps f32 products: a thread keeps a few rows'
// state and a slice of their accumulators in registers and computes a
// 4-wide block of scores from shared memory.
//
// What it does not do yet: wgmma, TMA or cp.async pipelining (a tile's
// loads and products do not overlap), ldmatrix, GQA without repeated
// heads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "attention_common.cuh"

namespace {

using namespace pt_attn;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // 4 warps
constexpr int kRowTile = 64;    // query rows (forward, dq) or keys (dk+dv)
constexpr int kColTile = 32;    // keys (forward, dq) or query rows (dk+dv)

struct Dims {
  int Sq, Sk;
  float scale;
  bool causal;
};

// key kk may be seen by query row qr: both in range, and not above the
// diagonal when causal
__device__ __forceinline__ bool visible(const Dims& d, int qr, int kk) {
  return qr < d.Sq && kk < d.Sk && (!d.causal || kk <= qr);
}

// ------------------------------------------------------- bf16: staging
//
// Rows of a [rows, HD] bf16 tensor into shared memory, row-major with a
// padded stride (HD + 8: the fragment loads of neighbouring rows fall in
// other banks), or transposed ([HD][N + 8]). Rows past `total` are zeros.

template <int HD>
__device__ __forceinline__ void stage_rows(bf16* __restrict__ dst,
                                           const bf16* __restrict__ src,
                                           int row0, int n, int total) {
  constexpr int CH = HD / 8;
  constexpr int LD = HD + 8;
  for (int i = threadIdx.x; i < n * CH; i += kThreads) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < total)
      x = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * HD + c));
    *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
  }
}

template <int HD, int N>
__device__ __forceinline__ void stage_cols(bf16* __restrict__ dst,
                                           const bf16* __restrict__ src,
                                           int row0, int total) {
  constexpr int CH = HD / 8;
  constexpr int LD = N + 8;
  // consecutive threads take consecutive rows of one chunk: no bank
  // conflicts on the transposed stores
  for (int i = threadIdx.x; i < N * CH; i += kThreads) {
    const int r = i % N;
    const int c = (i / N) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < total)
      x = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * HD + c));
    const bf16* xv = reinterpret_cast<const bf16*>(&x);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[(c + e) * LD + r] = xv[e];
  }
}

// A fragment of k-step k of a warp's 16 rows, from a row-major tile of
// stride LD (rows r0 .. r0 + 15)
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s,
                                       int r0, int k) {
  const int fr = (threadIdx.x & 31) >> 2;
  const int fc = (threadIdx.x & 3) * 2;
  const bf16* p = s + (r0 + fr) * LD + k * 16 + fc;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// acc[n] (NT n-tiles of 8 columns) += A B^T over KS k-steps: A the warp's
// 16 rows of a row-major tile sa (stride LDA, from row ra), B's rows the
// columns of the product (row-major tile sb, stride LDB)
template <int KS, int NT, int LDA, int LDB>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* sa,
                                        int ra, const bf16* sb) {
  const int fr = (threadIdx.x & 31) >> 2;
  const int fc = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    uint32_t a[4];
    frag_a<LDA>(a, sa, ra, k);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* b = sb + (n * 8 + fr) * LDB + k * 16 + fc;
      mma_bf16(acc[n], a, ld32(b), ld32(b + 8));
    }
  }
}

// acc[n] (NO n-tiles over HD) += P B: P the warp's 16 x (2 * KJ * 8)
// fragment values in C layout (p[2j], p[2j + 1] form k-step j), B a
// transposed tile sbt ([HD][LDB], the k index contiguous)
template <int KJ, int NO, int LDB>
__device__ __forceinline__ void mma_pb(float (&acc)[NO][4],
                                       const float (&p)[2 * KJ][4],
                                       const bf16* sbt) {
  const int fr = (threadIdx.x & 31) >> 2;
  const int fc = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const uint32_t a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                           pack_bf16(p[2 * j][2], p[2 * j][3]),
                           pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                           pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const bf16* b = sbt + (n * 8 + fr) * LDB + j * 16 + fc;
      mma_bf16(acc[n], a, ld32(b), ld32(b + 8));
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
}

// rows fr and fr + 8 of the warp's 16 (from row0) of a [*, HD] output,
// times mul, rows at or past `total` skipped
template <int NO>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const float (&acc)[NO][4],
                                           int row0, int total,
                                           const float (&mul)[2]) {
  const int fr = (threadIdx.x & 31) >> 2;
  const int fc = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + fr + 8 * h;
    if (r >= total) continue;
    bf16* op = out + static_cast<long long>(r) * (NO * 8);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(op + n * 8 + fc) =
          pack_bf16(acc[n][2 * h] * mul[h], acc[n][2 * h + 1] * mul[h]);
  }
}

// ---------------------------------------------------- bf16: forward

template <int HD>
constexpr size_t fwd_mma_smem() {
  return sizeof(bf16) * ((kRowTile + kColTile) * (HD + 8) +
                         HD * (kColTile + 8));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, Dims dm) {
  constexpr int LD = HD + 8, LDT = kColTile + 8;
  constexpr int KS = HD / 16, NS = kColTile / 8, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [kRowTile][LD]
  bf16* sK = sQ + kRowTile * LD;                  // [kColTile][LD]
  bf16* sVt = sK + kColTile * LD;                 // [HD][LDT]

  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kRowTile;
  const bf16* qb = q + bh * dm.Sq * HD;
  const bf16* kb = k + bh * dm.Sk * HD;
  const bf16* vb = v + bh * dm.Sk * HD;
  const int warp = threadIdx.x >> 5;
  const int fr = (threadIdx.x & 31) >> 2;
  const int fc = (threadIdx.x & 3) * 2;
  const int wr = warp * 16;                       // the warp's first row

  stage_rows<HD>(sQ, qb, q0, kRowTile, dm.Sq);
  __syncthreads();
  uint32_t qa[KS][4];   // the warp's Q fragments, for the whole walk
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) frag_a<LD>(qa[kk], sQ, wr, kk);

  int qr[2];
  float m[2], l[2], acc[NO][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qr[h] = q0 + wr + fr + 8 * h;
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  zero(acc);
  const int q_hi = min(q0 + kRowTile, dm.Sq) - 1;
  const int n_keys = dm.causal ? min(dm.Sk, q_hi + 1) : dm.Sk;

  for (int k0 = 0; k0 < n_keys; k0 += kColTile) {
    stage_rows<HD>(sK, kb, k0, kColTile, dm.Sk);
    stage_cols<HD, kColTile>(sVt, vb, k0, dm.Sk);
    __syncthreads();
    float sc[NS][4];
    zero(sc);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const bf16* b = sK + (n * 8 + fr) * LD + kk * 16 + fc;
        mma_bf16(sc[n], qa[kk], ld32(b), ld32(b + 8));
      }
    }
    // online softmax of fragment rows fr (h = 0) and fr + 8 (h = 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = visible(dm, qr[h], k0 + n * 8 + fc + e);
          const float x = ok ? sc[n][2 * h + e] * dm.scale : kNegInf;
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
          const bool ok = visible(dm, qr[h], k0 + n * 8 + fc + e);
          const float p = ok ? expf(sc[n][2 * h + e] - m_new) : 0.f;
          sc[n][2 * h + e] = p;
          psum += p;
        }
      }
      l[h] = l[h] * corr + quad_sum(psum);
      m[h] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * h] *= corr;
        acc[n][2 * h + 1] *= corr;
      }
    }
    mma_pb<kColTile / 16, NO, LDT>(acc, sc, sVt);
    __syncthreads();   // the next tile rewrites sK and sVt
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    inv[h] = l[h] == 0.f ? 0.f : 1.f / l[h];
    if (fc == 0 && qr[h] < dm.Sq)
      lse[bh * dm.Sq + qr[h]] = m[h] + logf(fmaxf(l[h], 1e-30f));
  }
  store_rows<NO>(o + bh * dm.Sq * HD, acc, q0 + wr, dm.Sq, inv);
}

// ------------------------------------------------- bf16: dq (+ delta)

// delta of rows row0 .. row0 + n - 1 (rows past Sq get 0): rowsum(do * o)
// - dlse, each warp taking rows warp, warp + 4, ...; written to s_delta
// and, for rows in range, to delta
template <typename T, int HD>
__device__ __forceinline__ void row_delta(const T* __restrict__ dob,
                                          const T* __restrict__ ob,
                                          const float* __restrict__ dlse,
                                          float* __restrict__ delta,
                                          float* s_delta, int row0, int n,
                                          int Sq) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < n; r += kThreads / 32) {
    const int row = row0 + r;
    float s = 0.f;
    if (row < Sq) {
      const long long at = static_cast<long long>(row) * HD;
      for (int c = lane; c < HD; c += 32)
        s += to_f32(dob[at + c]) * to_f32(ob[at + c]);
    }
    s = warp_sum(s);
    if (row < Sq && dlse != nullptr) s -= dlse[row];
    if (lane == 0) {
      s_delta[r] = row < Sq ? s : 0.f;
      if (row < Sq) delta[row] = s;
    }
  }
}

template <int HD>
constexpr size_t dq_mma_smem() {
  return sizeof(bf16) * (2 * (kRowTile + kColTile) * (HD + 8) +
                         HD * (kColTile + 8)) +
         sizeof(float) * 2 * kRowTile;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ o,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ dlse, float* __restrict__ delta,
              bf16* __restrict__ dq, Dims dm) {
  constexpr int LD = HD + 8, LDT = kColTile + 8;
  constexpr int KS = HD / 16, NS = kColTile / 8, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [kRowTile][LD]
  bf16* sdO = sQ + kRowTile * LD;                 // [kRowTile][LD]
  bf16* sK = sdO + kRowTile * LD;                 // [kColTile][LD]
  bf16* sV = sK + kColTile * LD;                  // [kColTile][LD]
  bf16* sKt = sV + kColTile * LD;                 // [HD][LDT]
  float* s_lse = reinterpret_cast<float*>(sKt + HD * LDT);
  float* s_delta = s_lse + kRowTile;

  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kRowTile;
  const long long qoff = bh * dm.Sq * HD, koff = bh * dm.Sk * HD;
  const int warp = threadIdx.x >> 5;
  const int fr = (threadIdx.x & 31) >> 2;
  const int fc = (threadIdx.x & 3) * 2;
  const int wr = warp * 16;

  stage_rows<HD>(sQ, q + qoff, q0, kRowTile, dm.Sq);
  stage_rows<HD>(sdO, dout + qoff, q0, kRowTile, dm.Sq);
  for (int r = threadIdx.x; r < kRowTile; r += kThreads)
    s_lse[r] = q0 + r < dm.Sq ? lse[bh * dm.Sq + q0 + r] : 0.f;
  row_delta<bf16, HD>(dout + qoff, o + qoff,
                      dlse == nullptr ? nullptr : dlse + bh * dm.Sq,
                      delta + bh * dm.Sq, s_delta, q0, kRowTile, dm.Sq);
  __syncthreads();

  int qr[2];
  float rl[2], rd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qr[h] = q0 + wr + fr + 8 * h;
    rl[h] = s_lse[wr + fr + 8 * h];
    rd[h] = s_delta[wr + fr + 8 * h];
  }
  float acc[NO][4];
  zero(acc);
  const int q_hi = min(q0 + kRowTile, dm.Sq) - 1;
  const int n_keys = dm.causal ? min(dm.Sk, q_hi + 1) : dm.Sk;

  for (int k0 = 0; k0 < n_keys; k0 += kColTile) {
    stage_rows<HD>(sK, k + koff, k0, kColTile, dm.Sk);
    stage_rows<HD>(sV, v + koff, k0, kColTile, dm.Sk);
    stage_cols<HD, kColTile>(sKt, k + koff, k0, dm.Sk);
    __syncthreads();
    float sc[NS][4], dp[NS][4];
    zero(sc);
    zero(dp);
    mma_abt<KS, NS, LD, LD>(sc, sQ, wr, sK);    // q k^T
    mma_abt<KS, NS, LD, LD>(dp, sdO, wr, sV);   // do v^T
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const bool ok = visible(dm, qr[h], k0 + n * 8 + fc + (e & 1));
        const float p = ok ? expf(sc[n][e] * dm.scale - rl[h]) : 0.f;
        sc[n][e] = p * (dp[n][e] - rd[h]);      // ds
      }
    }
    mma_pb<kColTile / 16, NO, LDT>(acc, sc, sKt);   // ds k
    __syncthreads();
  }
  const float mul[2] = {dm.scale, dm.scale};
  store_rows<NO>(dq + qoff, acc, q0 + wr, dm.Sq, mul);
}

// ---------------------------------------------------- bf16: dk + dv

template <int HD>
constexpr size_t dkv_mma_smem() {
  return sizeof(bf16) * (2 * (kRowTile + kColTile) * (HD + 8) +
                         2 * HD * (kColTile + 8)) +
         sizeof(float) * 2 * kColTile;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, Dims dm) {
  constexpr int LD = HD + 8, LDT = kColTile + 8;
  constexpr int KS = HD / 16, NS = kColTile / 8, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // [kRowTile][LD]
  bf16* sV = sK + kRowTile * LD;                  // [kRowTile][LD]
  bf16* sQ = sV + kRowTile * LD;                  // [kColTile][LD]
  bf16* sdO = sQ + kColTile * LD;                 // [kColTile][LD]
  bf16* sQt = sdO + kColTile * LD;                // [HD][LDT]
  bf16* sdOt = sQt + HD * LDT;                    // [HD][LDT]
  float* s_lse = reinterpret_cast<float*>(sdOt + HD * LDT);
  float* s_delta = s_lse + kColTile;

  const long long bh = blockIdx.y;
  const int kb0 = blockIdx.x * kRowTile;
  const long long qoff = bh * dm.Sq * HD, koff = bh * dm.Sk * HD;
  const int warp = threadIdx.x >> 5;
  const int fr = (threadIdx.x & 31) >> 2;
  const int fc = (threadIdx.x & 3) * 2;
  const int wr = warp * 16;

  stage_rows<HD>(sK, k + koff, kb0, kRowTile, dm.Sk);
  stage_rows<HD>(sV, v + koff, kb0, kRowTile, dm.Sk);
  int kr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) kr[h] = kb0 + wr + fr + 8 * h;
  float dka[NO][4], dva[NO][4];
  zero(dka);
  zero(dva);
  // the first query row that can see key kb0 is kb0 itself
  const int q_lo = dm.causal ? (kb0 / kColTile) * kColTile : 0;

  for (int q0 = q_lo; q0 < dm.Sq; q0 += kColTile) {
    stage_rows<HD>(sQ, q + qoff, q0, kColTile, dm.Sq);
    stage_rows<HD>(sdO, dout + qoff, q0, kColTile, dm.Sq);
    stage_cols<HD, kColTile>(sQt, q + qoff, q0, dm.Sq);
    stage_cols<HD, kColTile>(sdOt, dout + qoff, q0, dm.Sq);
    for (int r = threadIdx.x; r < kColTile; r += kThreads) {
      const bool in = q0 + r < dm.Sq;
      s_lse[r] = in ? lse[bh * dm.Sq + q0 + r] : 0.f;
      s_delta[r] = in ? delta[bh * dm.Sq + q0 + r] : 0.f;
    }
    __syncthreads();
    // the transposed frame: rows are keys, columns query rows
    float st[NS][4], dpt[NS][4];
    zero(st);
    zero(dpt);
    mma_abt<KS, NS, LD, LD>(st, sK, wr, sQ);     // k q^T
    mma_abt<KS, NS, LD, LD>(dpt, sV, wr, sdO);   // v do^T
    float dst[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + fc + (e & 1);     // query row q0 + c
        const bool ok = visible(dm, q0 + c, kr[e >> 1]);
        const float p = ok ? expf(st[n][e] * dm.scale - s_lse[c]) : 0.f;
        st[n][e] = p;
        dst[n][e] = p * (dpt[n][e] - s_delta[c]);
      }
    }
    mma_pb<kColTile / 16, NO, LDT>(dva, st, sdOt);   // p^T do
    mma_pb<kColTile / 16, NO, LDT>(dka, dst, sQt);   // ds^T q
    __syncthreads();   // the next tile rewrites sQ .. s_delta
  }
  const float one[2] = {1.f, 1.f};
  const float mul[2] = {dm.scale, dm.scale};
  store_rows<NO>(dk + koff, dka, kb0 + wr, dm.Sk, mul);
  store_rows<NO>(dv + koff, dva, kb0 + wr, dm.Sk, one);
}

// -------------------------------------------------------- f32: SIMT
//
// Rows of a tile are split among 16 groups of kGroup = 8 consecutive
// lanes; a group holds VPT rows (rows g * VPT .. g * VPT + VPT - 1), lane
// t of it the columns t, t + 8, t + 16, t + 24 of a 32-wide score tile and
// the accumulator dims t, t + 8, ... . Tiles live in shared memory as f32
// rows of stride HD + 1 (no bank conflicts down a column).

constexpr int kGroup = 8;
constexpr int kCpt = kColTile / kGroup;   // score columns per thread

template <int HD>
__device__ __forceinline__ void stage_f32(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int row0, int n, int total) {
  constexpr int CH = HD / 4;
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < n * CH; i += kThreads) {
    const int r = i / CH;
    const int c = (i % CH) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < total)
      load16(src + static_cast<long long>(row0 + r) * HD + c, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[r * LD + c + e] = x[e];
  }
}

// out[i][j] = row (g * VPT + i) of sa . row (t + 8 j) of sb
template <int HD, int VPT>
__device__ __forceinline__ void simt_abt(float (&out)[VPT][kCpt],
                                         const float* sa, const float* sb) {
  constexpr int LD = HD + 1;
  const int g = threadIdx.x / kGroup, t = threadIdx.x % kGroup;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
#pragma unroll
    for (int j = 0; j < kCpt; ++j) out[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[VPT], b[kCpt];
#pragma unroll
    for (int i = 0; i < VPT; ++i) a[i] = sa[(g * VPT + i) * LD + d];
#pragma unroll
    for (int j = 0; j < kCpt; ++j) b[j] = sb[(t + kGroup * j) * LD + d];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
#pragma unroll
      for (int j = 0; j < kCpt; ++j) out[i][j] += a[i] * b[j];
    }
  }
}

// acc[i][c] += sum over the tile's 32 columns j of sp[g * VPT + i][j] *
// sb[j][t + 8 c]; sp has stride kColTile + 1
template <int HD, int VPT>
__device__ __forceinline__ void simt_pb(float (&acc)[VPT][HD / kGroup],
                                        const float* sp, const float* sb) {
  constexpr int LD = HD + 1;
  const int g = threadIdx.x / kGroup, t = threadIdx.x % kGroup;
#pragma unroll 4
  for (int j = 0; j < kColTile; ++j) {
    float p[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) p[i] = sp[(g * VPT + i) * (kColTile + 1) + j];
#pragma unroll
    for (int c = 0; c < HD / kGroup; ++c) {
      const float b = sb[j * LD + t + kGroup * c];
#pragma unroll
      for (int i = 0; i < VPT; ++i) acc[i][c] += p[i] * b;
    }
  }
}

template <int HD, int VPT>
__device__ __forceinline__ void simt_store(float* __restrict__ out,
                                           const float (&acc)[VPT][HD / kGroup],
                                           int row0, int total,
                                           const float (&mul)[VPT]) {
  const int g = threadIdx.x / kGroup, t = threadIdx.x % kGroup;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int r = row0 + g * VPT + i;
    if (r >= total) continue;
    float* op = out + static_cast<long long>(r) * HD;
#pragma unroll
    for (int c = 0; c < HD / kGroup; ++c) op[t + kGroup * c] = acc[i][c] * mul[i];
  }
}

constexpr int kVptQ = kRowTile * kGroup / kThreads;   // 4 query rows
constexpr int kVptK = 2;                              // 2 keys: 32 a block
constexpr int kKeyTileF32 = kVptK * kThreads / kGroup;

template <int HD>
constexpr size_t fwd_simt_smem() {
  return sizeof(float) * ((kRowTile + 2 * kColTile) * (HD + 1) +
                          kRowTile * (kColTile + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                float* __restrict__ lse, Dims dm) {
  constexpr int VPT = kVptQ, DPT = HD / kGroup;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);   // [kRowTile][HD + 1]
  float* sK = sQ + kRowTile * (HD + 1);             // [kColTile][HD + 1]
  float* sV = sK + kColTile * (HD + 1);             // [kColTile][HD + 1]
  float* sP = sV + kColTile * (HD + 1);             // [kRowTile][kColTile + 1]

  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kRowTile;
  const float* kb = k + bh * dm.Sk * HD;
  const float* vb = v + bh * dm.Sk * HD;
  const int g = threadIdx.x / kGroup, t = threadIdx.x % kGroup;

  stage_f32<HD>(sQ, q + bh * dm.Sq * HD, q0, kRowTile, dm.Sq);
  int qr[VPT];
  float m[VPT], l[VPT], acc[VPT][DPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    qr[i] = q0 + g * VPT + i;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }
  const int q_hi = min(q0 + kRowTile, dm.Sq) - 1;
  const int n_keys = dm.causal ? min(dm.Sk, q_hi + 1) : dm.Sk;

  for (int k0 = 0; k0 < n_keys; k0 += kColTile) {
    stage_f32<HD>(sK, kb, k0, kColTile, dm.Sk);
    stage_f32<HD>(sV, vb, k0, kColTile, dm.Sk);
    __syncthreads();
    float sc[VPT][kCpt];
    simt_abt<HD, VPT>(sc, sQ, sK);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      bool ok[kCpt];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCpt; ++j) {
        ok[j] = visible(dm, qr[i], k0 + t + kGroup * j);
        sc[i][j] = ok[j] ? sc[i][j] * dm.scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = lanes_max<kGroup>(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCpt; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        psum += p;
        sP[(g * VPT + i) * (kColTile + 1) + t + kGroup * j] = p;
      }
      l[i] = l[i] * corr + lanes_sum<kGroup>(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
    }
    __syncwarp();   // a group's lanes share one warp
    simt_pb<HD, VPT>(acc, sP, sV);
    __syncthreads();   // the next tile rewrites sK, sV and sP
  }

  float inv[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    inv[i] = l[i] == 0.f ? 0.f : 1.f / l[i];
    if (t == 0 && qr[i] < dm.Sq)
      lse[bh * dm.Sq + qr[i]] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
  simt_store<HD, VPT>(o + bh * dm.Sq * HD, acc, q0, dm.Sq, inv);
}

template <int HD>
constexpr size_t dq_simt_smem() {
  return sizeof(float) * (2 * (kRowTile + kColTile) * (HD + 1) +
                          kRowTile * (kColTile + 1) + 2 * kRowTile);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ o,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ dlse, float* __restrict__ delta,
               float* __restrict__ dq, Dims dm) {
  constexpr int VPT = kVptQ, DPT = HD / kGroup;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);   // [kRowTile][HD + 1]
  float* sdO = sQ + kRowTile * (HD + 1);            // [kRowTile][HD + 1]
  float* sK = sdO + kRowTile * (HD + 1);            // [kColTile][HD + 1]
  float* sV = sK + kColTile * (HD + 1);             // [kColTile][HD + 1]
  float* sS = sV + kColTile * (HD + 1);             // [kRowTile][kColTile + 1]
  float* s_lse = sS + kRowTile * (kColTile + 1);
  float* s_delta = s_lse + kRowTile;

  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kRowTile;
  const long long qoff = bh * dm.Sq * HD, koff = bh * dm.Sk * HD;
  const int g = threadIdx.x / kGroup, t = threadIdx.x % kGroup;

  stage_f32<HD>(sQ, q + qoff, q0, kRowTile, dm.Sq);
  stage_f32<HD>(sdO, dout + qoff, q0, kRowTile, dm.Sq);
  for (int r = threadIdx.x; r < kRowTile; r += kThreads)
    s_lse[r] = q0 + r < dm.Sq ? lse[bh * dm.Sq + q0 + r] : 0.f;
  row_delta<float, HD>(dout + qoff, o + qoff,
                       dlse == nullptr ? nullptr : dlse + bh * dm.Sq,
                       delta + bh * dm.Sq, s_delta, q0, kRowTile, dm.Sq);
  __syncthreads();

  int qr[VPT];
  float acc[VPT][DPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    qr[i] = q0 + g * VPT + i;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }
  const int q_hi = min(q0 + kRowTile, dm.Sq) - 1;
  const int n_keys = dm.causal ? min(dm.Sk, q_hi + 1) : dm.Sk;

  for (int k0 = 0; k0 < n_keys; k0 += kColTile) {
    stage_f32<HD>(sK, k + koff, k0, kColTile, dm.Sk);
    stage_f32<HD>(sV, v + koff, k0, kColTile, dm.Sk);
    __syncthreads();
    float sc[VPT][kCpt], dp[VPT][kCpt];
    simt_abt<HD, VPT>(sc, sQ, sK);    // q k^T
    simt_abt<HD, VPT>(dp, sdO, sV);   // do v^T
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int r = g * VPT + i;
#pragma unroll
      for (int j = 0; j < kCpt; ++j) {
        const bool ok = visible(dm, qr[i], k0 + t + kGroup * j);
        const float p = ok ? expf(sc[i][j] * dm.scale - s_lse[r]) : 0.f;
        sS[r * (kColTile + 1) + t + kGroup * j] = p * (dp[i][j] - s_delta[r]);
      }
    }
    __syncwarp();
    simt_pb<HD, VPT>(acc, sS, sK);    // ds k
    __syncthreads();
  }
  float mul[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) mul[i] = dm.scale;
  simt_store<HD, VPT>(dq + qoff, acc, q0, dm.Sq, mul);
}

template <int HD>
constexpr size_t dkv_simt_smem() {
  return sizeof(float) * ((2 * kKeyTileF32 + 2 * kColTile) * (HD + 1) +
                          2 * kKeyTileF32 * (kColTile + 1) + 2 * kColTile);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dkv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, Dims dm) {
  constexpr int VPT = kVptK, DPT = HD / kGroup, KT = kKeyTileF32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);   // [KT][HD + 1]
  float* sV = sK + KT * (HD + 1);                   // [KT][HD + 1]
  float* sQ = sV + KT * (HD + 1);                   // [kColTile][HD + 1]
  float* sdO = sQ + kColTile * (HD + 1);            // [kColTile][HD + 1]
  float* sP = sdO + kColTile * (HD + 1);            // [KT][kColTile + 1]
  float* sS = sP + KT * (kColTile + 1);             // [KT][kColTile + 1]
  float* s_lse = sS + KT * (kColTile + 1);
  float* s_delta = s_lse + kColTile;

  const long long bh = blockIdx.y;
  const int kb0 = blockIdx.x * KT;
  const long long qoff = bh * dm.Sq * HD, koff = bh * dm.Sk * HD;
  const int g = threadIdx.x / kGroup, t = threadIdx.x % kGroup;

  stage_f32<HD>(sK, k + koff, kb0, KT, dm.Sk);
  stage_f32<HD>(sV, v + koff, kb0, KT, dm.Sk);
  int kr[VPT];
  float dka[VPT][DPT], dva[VPT][DPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    kr[i] = kb0 + g * VPT + i;
#pragma unroll
    for (int c = 0; c < DPT; ++c) dka[i][c] = dva[i][c] = 0.f;
  }
  const int q_lo = dm.causal ? (kb0 / kColTile) * kColTile : 0;

  for (int q0 = q_lo; q0 < dm.Sq; q0 += kColTile) {
    stage_f32<HD>(sQ, q + qoff, q0, kColTile, dm.Sq);
    stage_f32<HD>(sdO, dout + qoff, q0, kColTile, dm.Sq);
    for (int r = threadIdx.x; r < kColTile; r += kThreads) {
      const bool in = q0 + r < dm.Sq;
      s_lse[r] = in ? lse[bh * dm.Sq + q0 + r] : 0.f;
      s_delta[r] = in ? delta[bh * dm.Sq + q0 + r] : 0.f;
    }
    __syncthreads();
    float st[VPT][kCpt], dpt[VPT][kCpt];
    simt_abt<HD, VPT>(st, sK, sQ);    // k q^T
    simt_abt<HD, VPT>(dpt, sV, sdO);  // v do^T
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int r = g * VPT + i;
#pragma unroll
      for (int j = 0; j < kCpt; ++j) {
        const int c = t + kGroup * j;   // query row q0 + c
        const bool ok = visible(dm, q0 + c, kr[i]);
        const float p = ok ? expf(st[i][j] * dm.scale - s_lse[c]) : 0.f;
        sP[r * (kColTile + 1) + c] = p;
        sS[r * (kColTile + 1) + c] = p * (dpt[i][j] - s_delta[c]);
      }
    }
    __syncwarp();
    simt_pb<HD, VPT>(dva, sP, sdO);   // p^T do
    simt_pb<HD, VPT>(dka, sS, sQ);    // ds^T q
    __syncthreads();
  }
  float one[VPT], mul[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    one[i] = 1.f;
    mul[i] = dm.scale;
  }
  simt_store<HD, VPT>(dk + koff, dka, kb0, dm.Sk, mul);
  simt_store<HD, VPT>(dv + koff, dva, kb0, dm.Sk, one);
}

// ------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

#define PT_LAUNCH(kernel, grid, smem, stream, ...)                 \
  do {                                                             \
    const cudaError_t e_ = allow_smem(kernel, smem);               \
    if (e_ != cudaSuccess) return e_;                              \
    kernel<<<grid, kThreads, smem, stream>>>(__VA_ARGS__);         \
    return cudaGetLastError();                                     \
  } while (0)

inline dim3 grid_of(int n, int tile, int BH) {
  return dim3((n + tile - 1) / tile, BH);
}

template <int HD>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, int BH, Dims dm, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    PT_LAUNCH(fwd_mma_kernel<HD>, grid_of(dm.Sq, kRowTile, BH),
              fwd_mma_smem<HD>(), st, static_cast<const bf16*>(q),
              static_cast<const bf16*>(k), static_cast<const bf16*>(v),
              static_cast<bf16*>(o), lse, dm);
  }
  PT_LAUNCH(fwd_simt_kernel<HD>, grid_of(dm.Sq, kRowTile, BH),
            fwd_simt_smem<HD>(), st, static_cast<const float*>(q),
            static_cast<const float*>(k), static_cast<const float*>(v),
            static_cast<float*>(o), lse, dm);
}

template <int HD>
cudaError_t dq(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, const float* dlse,
               float* delta, void* dqp, int BH, Dims dm, int dtype,
               cudaStream_t st) {
  if (dtype == 1) {
    PT_LAUNCH(dq_mma_kernel<HD>, grid_of(dm.Sq, kRowTile, BH),
              dq_mma_smem<HD>(), st, static_cast<const bf16*>(q),
              static_cast<const bf16*>(k), static_cast<const bf16*>(v),
              static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
              lse, dlse, delta, static_cast<bf16*>(dqp), dm);
  }
  PT_LAUNCH(dq_simt_kernel<HD>, grid_of(dm.Sq, kRowTile, BH),
            dq_simt_smem<HD>(), st, static_cast<const float*>(q),
            static_cast<const float*>(k), static_cast<const float*>(v),
            static_cast<const float*>(o), static_cast<const float*>(dout),
            lse, dlse, delta, static_cast<float*>(dqp), dm);
}

template <int HD>
cudaError_t dkv(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dkp, void* dvp, int BH, Dims dm, int dtype,
                cudaStream_t st) {
  if (dtype == 1) {
    PT_LAUNCH(dkv_mma_kernel<HD>, grid_of(dm.Sk, kRowTile, BH),
              dkv_mma_smem<HD>(), st, static_cast<const bf16*>(q),
              static_cast<const bf16*>(k), static_cast<const bf16*>(v),
              static_cast<const bf16*>(dout), lse, delta,
              static_cast<bf16*>(dkp), static_cast<bf16*>(dvp), dm);
  }
  PT_LAUNCH(dkv_simt_kernel<HD>, grid_of(dm.Sk, kKeyTileF32, BH),
            dkv_simt_smem<HD>(), st, static_cast<const float*>(q),
            static_cast<const float*>(k), static_cast<const float*>(v),
            static_cast<const float*>(dout), lse, delta,
            static_cast<float*>(dkp), static_cast<float*>(dvp), dm);
}

bool bad_dims(int BH, int Sq, int Sk, int dtype) {
  return BH <= 0 || BH > 65535 || Sq <= 0 || Sk <= 0 ||
         (dtype != 0 && dtype != 1) ||
         static_cast<long long>(Sq) + kRowTile > INT_MAX ||
         static_cast<long long>(Sk) + kRowTile > INT_MAX;
}

}  // namespace

#define PT_BY_HD(hd, call, ...)          \
  switch (hd) {                          \
    case 16:                             \
      return call<16>(__VA_ARGS__);      \
    case 64:                             \
      return call<64>(__VA_ARGS__);      \
    case 128:                            \
      return call<128>(__VA_ARGS__);     \
    default:                             \
      return cudaErrorInvalidValue;      \
  }

// dtype: 0 = float32, 1 = bfloat16; causal 0 or 1. Each returns a
// cudaError_t (0 = launched).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int BH, int Sq, int Sk,
                                int hd, int causal, int dtype, float scale,
                                void* stream) {
  if (bad_dims(BH, Sq, Sk, dtype)) return cudaErrorInvalidValue;
  const Dims dm{Sq, Sk, scale, causal != 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  PT_BY_HD(hd, fwd, q, k, v, o, l, BH, dm, dtype, st);
}

// delta: f32 [BH, Sq] written here (rowsum(do * o) - dlse) and read by
// flash_bwd_dkv_launch, which must follow on the same stream; dlse may be
// null.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   const void* dlse, void* delta, void* dqp,
                                   int BH, int Sq, int Sk, int hd,
                                   int causal, int dtype, float scale,
                                   void* stream) {
  if (bad_dims(BH, Sq, Sk, dtype)) return cudaErrorInvalidValue;
  const Dims dm{Sq, Sk, scale, causal != 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PT_BY_HD(hd, dq, q, k, v, o, dout, static_cast<const float*>(lse),
           static_cast<const float*>(dlse), static_cast<float*>(delta), dqp,
           BH, dm, dtype, st);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dkp, void* dvp, int BH, int Sq,
                                    int Sk, int hd, int causal, int dtype,
                                    float scale, void* stream) {
  if (bad_dims(BH, Sq, Sk, dtype)) return cudaErrorInvalidValue;
  const Dims dm{Sq, Sk, scale, causal != 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PT_BY_HD(hd, dkv, q, k, v, dout, static_cast<const float*>(lse),
           static_cast<const float*>(delta), dkp, dvp, BH, dm, dtype, st);
}
