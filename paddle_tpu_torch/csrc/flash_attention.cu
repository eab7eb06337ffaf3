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
// f32 or bf16; hd 16, 32, 64, 96 or 128 (32 and 96: nn's common
// MultiHeadAttention widths, 256 / 8 and 768 / 8); any Sq and Sk (the tail
// tiles are masked).
//
// What bounds it on this card. At llama_350m's training shape (B = 8, 16
// heads, S = 1024, hd = 64, causal) the forward does 2 * B * H * S^2 * hd
// = 17.2 GFLOP against 67 MB of q, k, v and o: 0.017 ms at 989 TFLOP/s
// bf16 against 0.020 ms at 3.35 TB/s; the backward does 2.5 times the
// operations (0.043 ms) against 134 MB (0.040 ms). Bytes and operations
// are of one order, and at Llama-2-7B's shape (S = 4096, hd = 128)
// operations lead by four times. So the kernels must keep the tensor
// cores busy while the next tile streams in: what costs time is a tile's
// load latency left exposed, instructions spent moving data between
// shared memory and registers, and work on masked scores.
//
// bf16: tensor cores fed by asynchronous copies (the design of K2,
// ragged_prefill.cu).
// - Tiles of 64 rows on both axes, 4 warps of 16 rows. Forward and dq: one
//   block per (64 query rows, b*h), walking 64-key tiles up to the row
//   tile's causal frontier (tiles wholly above it are neither read nor
//   computed); blocks of the last row tiles, the longest walks, start
//   first, so the grid's tail is short walks. dk + dv: one block per (64
//   keys, b*h), walking query tiles from the first that can see its
//   first key; blockIdx.x ascending already starts the longest walks
//   first.
// - Loads: a two-stage ring of 16-byte cp.async copies (4-byte ones for
//   the lse and delta rows). Tile i + 1's K and V (or Q, dO, lse and
//   delta) are in flight while tile i's products run, behind one barrier
//   a tile. Rows past Sq or Sk are zero-filled by src-size-0 copies and
//   never addressed.
// - Fragments: the block's own rows (Q; Q and dO; K and V) are copied
//   once, and each warp's A fragments loaded by ldmatrix.x4 and held in
//   registers for the whole walk; dk + dv at hd 128, whose two 16 x 128
//   f32 accumulators a warp leave no room for them, reload them from
//   shared memory each tile. Every B operand comes by ldmatrix from the
//   tile as it lies: .x4 where the tile's rows are the product's columns
//   (K in q k^T, V in do v^T, Q in k q^T, dO in v do^T), .x4.trans where
//   they are its k index (V in p v, K in ds k, dO in p^T do, Q in ds^T
//   q). No tile is transposed by hand, and each of Q, K, V and dO is
//   read from device memory once per walk. Rows in shared memory are
//   padded by 16 bytes: every ldmatrix is free of bank conflicts.
// - Scores leave mma.sync in the C layout, which is the A layout of the
//   next product (p v, ds k; in dk + dv's transposed frame p^T do and
//   ds^T q), rounded to bf16 as the plain version's bf16 operands round.
// - Softmax in base 2: scores times scale * log2(e) and exp2f (one
//   instruction); lse is written in natural log, (m2 + log2 l) * ln 2,
//   and the backward forms p = exp2(s * scale * log2 e - lse * log2 e).
// - The causal mask and the Sq/Sk bounds are tested only on a warp's
//   tiles that cross the diagonal or the tail; a warp skips a tile none
//   of its rows can see.
// - Outputs go through a drained slot of shared memory (each warp its
//   own 16 rows) to 16-byte stores.
// - No atomics: each block owns its output tile and walks the other axis
//   in order, so the gradients are the same bit for bit from run to run.
//   The price is the dq kernel's own recomputation of the scores and of
//   do v^T (7 products a tile pair where an atomic dq would do 5).
// - delta: the dq kernel computes its rows' delta from do and o, uses it,
//   and writes it for the dk + dv kernel, which the caller launches after
//   it on the same stream.
//
// f32 runs SIMT so that f32 keeps f32 products (no TF32): a thread keeps
// a few rows' state and a slice of their accumulators in registers and
// computes a 4-wide block of scores from shared memory, over 32-wide
// tiles staged by plain loads.
//
// What holds it back, and what it does not do yet. Each warp reads the
// whole K and V tile (or Q and dO) from shared memory for its 16 rows:
// per 64 x 64 tile pair the four warps' ldmatrix loads move 64 KB at
// hd 64 against the 16 KB copied in, which at 128 bytes of shared memory
// a cycle an SM takes about as long as their 256 mma.sync (an estimate
// from the shapes; no profiler on the card's machine counts it). wgmma
// (a warpgroup's m64 tile is the block's 64 rows, B read once from
// shared memory for all of them) is the next step; then TMA, a third
// stage, GQA without repeated heads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "attention_common.cuh"

namespace {

using namespace pt_attn;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // 4 warps
constexpr int kRowTile = 64;    // f32: query rows (forward, dq)
constexpr int kColTile = 32;    // f32: keys (forward, dq), query rows (dk+dv)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Dims {
  int Sq, Sk;
  float scale;
  bool causal;
};

// key kk is in range and, when causal, not above query row qr's diagonal
// (the bf16 kernels never store rows past Sq, so they test only this)
__device__ __forceinline__ bool sees(const Dims& d, int qr, int kk) {
  return kk < d.Sk && (!d.causal || kk <= qr);
}

// ... and query row qr is in range too (the f32 kernels)
__device__ __forceinline__ bool visible(const Dims& d, int qr, int kk) {
  return qr < d.Sq && sees(d, qr, kk);
}

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

// ------------------------------------------------- bf16: shared helpers

constexpr int kTile = 64;   // the block's own rows, 16 a warp, and the
                            // walked tile: 64 on both axes

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
}

// rows row0 .. row0 + n - 1 of a [*, HD] tensor into shared memory
// (pitch HD + 8) by 16-byte cp.async; rows at or past total are
// zero-filled and never addressed
template <int HD>
__device__ __forceinline__ void copy_rows(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int row0, int n, int total) {
  constexpr int CH = HD / 8, P = HD + 8;
  for (int e = threadIdx.x; e < n * CH; e += kThreads) {
    const int r = e / CH, c = (e % CH) * 8;
    const bool ok = row0 + r < total;
    cp_async16(dst + r * P + c,
               src + (ok ? static_cast<long long>(row0 + r) * HD + c : 0),
               ok);
  }
}

// the A fragment of k-step k of rows r0 .. r0 + 15 of a shared tile
// (pitch P): ldmatrix.x4, matrix i from lanes 8i .. 8i + 7 (rows + 8 for
// odd i, columns + 8 for i >= 2)
template <int P>
__device__ __forceinline__ void ldm_a(uint32_t (&a)[4], const bf16* s,
                                      int r0, int k) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, s + (r0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * P +
                     k * 16 + (lane >> 4) * 8);
}

// acc[n] (NT n-tiles of 8 columns) += A B^T over KS k-steps: afrag(a, k)
// gives the warp's A fragment of k-step k; B^T is a shared tile sb
// (pitch P) whose rows are the product's columns, its k index their
// elements: one ldmatrix.x4 gives the B fragments of two n-tiles
template <int KS, int NT, int P, typename AFrag>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], AFrag afrag,
                                        const bf16* sb) {
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    uint32_t a[4];
    afrag(a, k);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, sb + (np * 16 + (mi >> 1) * 8 + mr) * P + k * 16 +
                         (mi & 1) * 8);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[n] (NO n-tiles over HD) += X B: X the warp's 16 x 16 KJ values in
// the C layout (x[2j], x[2j + 1] are the n-tiles of k-step j), rounded to
// bf16 into A fragments; B a shared tile (pitch P) as it lies, its rows
// the k index: ldmatrix.x4.trans gives the B fragments of two n-tiles
template <int KJ, int NO, int P>
__device__ __forceinline__ void mma_xb(float (&acc)[NO][4],
                                       const float (&x)[2 * KJ][4],
                                       const bf16* sb) {
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const uint32_t a[4] = {pack_bf16(x[2 * j][0], x[2 * j][1]),
                           pack_bf16(x[2 * j][2], x[2 * j][3]),
                           pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]),
                           pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3])};
#pragma unroll
    for (int np = 0; np < NO / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sb + (j * 16 + (mi & 1) * 8 + mr) * P + np * 16 +
                               (mi >> 1) * 8);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// The warp's accumulator rows (fragment rows fr and fr + 8) times mul[h],
// rounded to bf16, into its 16 rows s of a slot no other warp touches
// (pitch HD + 8), then out in 16-byte stores as rows row0 .. row0 + 15
// of out [*, HD]; rows at or past total are skipped
template <int HD>
__device__ __forceinline__ void store_tile(bf16* __restrict__ out,
                                           const float (&acc)[HD / 8][4],
                                           bf16* s, int row0, int total,
                                           const float (&mul)[2]) {
  constexpr int CH = HD / 8, P = HD + 8;
  const int lane = threadIdx.x & 31;
  const int fr = lane >> 2, fc = (lane & 3) * 2;
  __syncwarp();   // the warp's last reads of s (ldmatrix) are done
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(s + (fr + 8 * h) * P + n * 8 + fc) =
          pack_bf16(acc[n][2 * h] * mul[h], acc[n][2 * h + 1] * mul[h]);
  }
  __syncwarp();
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH, c = (e % CH) * 8;
    if (row0 + r < total)
      *reinterpret_cast<uint4*>(out + static_cast<long long>(row0 + r) * HD +
                                c) =
          *reinterpret_cast<const uint4*>(s + r * P + c);
  }
}

// ---------------------------------------------------- bf16: forward

// One key tile's online-softmax step (base 2) for the warp's fragment
// rows qr[0] (fr) and qr[1] (fr + 8): the raw scores sc become
// probabilities exp2(s * scale2 - m) in place, and m, l and acc are
// rescaled. MASK tests each key against Sk and the causal diagonal and
// sets an unseen scaled score to -inf, whose exp2 is 0 (m stays finite:
// it starts at -1e30); without MASK every key is seen.
template <bool MASK, int NS, int NO>
__device__ __forceinline__ void softmax_step(float (&sc)[NS][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&acc)[NO][4],
                                             const int (&qr)[2], int k0,
                                             const Dims& dm, float scale2) {
  const int fc = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = sc[n][2 * h + e] * scale2;
        if (MASK && !sees(dm, qr[h], k0 + n * 8 + fc + e)) x = -INFINITY;
        sc[n][2 * h + e] = x;
        mx = fmaxf(mx, x);
      }
    }
    const float m_new = fmaxf(m[h], quad_max(mx));
    const float corr = exp2f(m[h] - m_new);
    float psum = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2f(sc[n][2 * h + e] - m_new);
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
}

// the ring of the forward and dq: two stages of two 64-row tiles (K and V)
template <int HD>
constexpr size_t ring_bytes() {
  return sizeof(bf16) * 2 * 2 * kTile * (HD + 8);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, Dims dm) {
  constexpr int P = HD + 8, KS = HD / 16, NS = kTile / 8, NO = HD / 8;
  constexpr int T = kTile * P;   // elements of one tile in shared memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);   // [2][K, V][kTile][P]

  const long long bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const bf16* kb = k + bh * dm.Sk * HD;
  const bf16* vb = v + bh * dm.Sk * HD;
  const int fr = (threadIdx.x & 31) >> 2;
  const int fc = (threadIdx.x & 3) * 2;
  const int wr = (threadIdx.x >> 5) * 16;   // the warp's first row
  const int q_hi = min(q0 + kTile, dm.Sq) - 1;
  const int n_keys = dm.causal ? min(dm.Sk, q_hi + 1) : dm.Sk;
  const int n_tiles = (n_keys + kTile - 1) / kTile;
  auto stage = [&](int i) { return ring + (i & 1) * 2 * T; };
  auto load = [&](int i) {
    copy_rows<HD>(stage(i), kb, i * kTile, kTile, dm.Sk);
    copy_rows<HD>(stage(i) + T, vb, i * kTile, kTile, dm.Sk);
  };

  // Q into stage 1's K slot (free until tile 1 is loaded), tile 0 into
  // stage 0; each warp's Q fragments are then held for the whole walk
  copy_rows<HD>(stage(1), q + bh * dm.Sq * HD, q0, kTile, dm.Sq);
  load(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldm_a<P>(qa[kk], stage(1), wr, kk);
  auto q_frag = [&](uint32_t (&a)[4], int kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
  };

  const float scale2 = dm.scale * kLog2e;
  int qr[2];
  float m[2], l[2], acc[NO][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qr[h] = q0 + wr + fr + 8 * h;
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  zero(acc);
  const int row_lo = q0 + wr;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();
    // tile i has landed for every thread, and every warp is done with
    // tile i - 1 (and with Q): its stage takes tile i + 1
    __syncthreads();
    if (i + 1 < n_tiles) load(i + 1);
    cp_async_commit();
    const int k0 = i * kTile;
    if (dm.causal && k0 > row_lo + 15) continue;   // warp-uniform
    const bf16* sk = stage(i);
    float sc[NS][4];
    zero(sc);
    mma_abt<KS, NS, P>(sc, q_frag, sk);               // q k^T
    if ((dm.causal && k0 + kTile - 1 > row_lo) || k0 + kTile > dm.Sk)
      softmax_step<true>(sc, m, l, acc, qr, k0, dm, scale2);
    else
      softmax_step<false>(sc, m, l, acc, qr, k0, dm, scale2);
    mma_xb<kTile / 16, NO, P>(acc, sc, sk + T);       // p v
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    inv[h] = l[h] == 0.f ? 0.f : 1.f / l[h];
    if (fc == 0 && qr[h] < dm.Sq)
      lse[bh * dm.Sq + qr[h]] = (m[h] + log2f(fmaxf(l[h], 1e-30f))) * kLn2;
  }
  // stage n_tiles % 2 was last read before the last barrier
  store_tile<HD>(o + bh * dm.Sq * HD, acc, stage(n_tiles) + wr * P, row_lo,
                 dm.Sq, inv);
}

// ------------------------------------------------- bf16: dq (+ delta)

template <int HD>
constexpr size_t dq_mma_smem() {
  return ring_bytes<HD>() + sizeof(float) * kTile;
}

// ds of one key tile in place of the raw scores sc: p = exp2(s * scale2 -
// lse2) (lse2 = lse * log2 e of rows qr[h]), ds = p * (dp - delta)
template <bool MASK, int NS>
__device__ __forceinline__ void ds_step(float (&sc)[NS][4],
                                        const float (&dp)[NS][4],
                                        const float (&rl)[2],
                                        const float (&rd)[2],
                                        const int (&qr)[2], int k0,
                                        const Dims& dm, float scale2) {
  const int fc = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float p = exp2f(fmaf(sc[n][e], scale2, -rl[h]));
      if (MASK && !sees(dm, qr[h], k0 + n * 8 + fc + (e & 1))) p = 0.f;
      sc[n][e] = p * (dp[n][e] - rd[h]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ o,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ dlse, float* __restrict__ delta,
              bf16* __restrict__ dq, Dims dm) {
  constexpr int P = HD + 8, KS = HD / 16, NS = kTile / 8, NO = HD / 8;
  constexpr int T = kTile * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);   // [2][K, V][kTile][P]
  float* s_delta = reinterpret_cast<float*>(ring + 4 * T);

  const long long bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const long long qoff = bh * dm.Sq * HD, koff = bh * dm.Sk * HD;
  const int fr = (threadIdx.x & 31) >> 2;
  const int wr = (threadIdx.x >> 5) * 16;
  const int q_hi = min(q0 + kTile, dm.Sq) - 1;
  const int n_keys = dm.causal ? min(dm.Sk, q_hi + 1) : dm.Sk;
  const int n_tiles = (n_keys + kTile - 1) / kTile;
  auto stage = [&](int i) { return ring + (i & 1) * 2 * T; };
  auto load = [&](int i) {
    copy_rows<HD>(stage(i), k + koff, i * kTile, kTile, dm.Sk);
    copy_rows<HD>(stage(i) + T, v + koff, i * kTile, kTile, dm.Sk);
  };

  // Q and dO into stage 1 (free until tile 1 is loaded), tile 0 into
  // stage 0; delta and lse while they fly
  copy_rows<HD>(stage(1), q + qoff, q0, kTile, dm.Sq);
  copy_rows<HD>(stage(1) + T, dout + qoff, q0, kTile, dm.Sq);
  load(0);
  cp_async_commit();
  row_delta<bf16, HD>(dout + qoff, o + qoff,
                      dlse == nullptr ? nullptr : dlse + bh * dm.Sq,
                      delta + bh * dm.Sq, s_delta, q0, kTile, dm.Sq);
  int qr[2];
  float rl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qr[h] = q0 + wr + fr + 8 * h;
    rl[h] = qr[h] < dm.Sq ? lse[bh * dm.Sq + qr[h]] * kLog2e : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[KS][4], da[KS][4];   // Q and dO fragments, held
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldm_a<P>(qa[kk], stage(1), wr, kk);
    ldm_a<P>(da[kk], stage(1) + T, wr, kk);
  }
  auto q_frag = [&](uint32_t (&a)[4], int kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
  };
  auto do_frag = [&](uint32_t (&a)[4], int kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = da[kk][e];
  };
  const float rd[2] = {s_delta[wr + fr], s_delta[wr + fr + 8]};

  const float scale2 = dm.scale * kLog2e;
  float acc[NO][4];
  zero(acc);
  const int row_lo = q0 + wr;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();   // as in the forward
    if (i + 1 < n_tiles) load(i + 1);
    cp_async_commit();
    const int k0 = i * kTile;
    if (dm.causal && k0 > row_lo + 15) continue;   // warp-uniform
    const bf16* sk = stage(i);
    float sc[NS][4], dp[NS][4];
    zero(sc);
    zero(dp);
    mma_abt<KS, NS, P>(sc, q_frag, sk);        // q k^T
    mma_abt<KS, NS, P>(dp, do_frag, sk + T);   // do v^T
    if ((dm.causal && k0 + kTile - 1 > row_lo) || k0 + kTile > dm.Sk)
      ds_step<true>(sc, dp, rl, rd, qr, k0, dm, scale2);
    else
      ds_step<false>(sc, dp, rl, rd, qr, k0, dm, scale2);
    mma_xb<kTile / 16, NO, P>(acc, sc, sk);    // ds k
  }
  const float mul[2] = {dm.scale, dm.scale};
  store_tile<HD>(dq + qoff, acc, stage(n_tiles) + wr * P, row_lo, dm.Sq,
                 mul);
}

// ---------------------------------------------------- bf16: dk + dv

template <int HD>
constexpr size_t dkv_mma_smem() {
  return sizeof(bf16) * 6 * kTile * (HD + 8) + sizeof(float) * 4 * kTile;
}

// p and ds of one query tile in the transposed frame (rows keys kr[h],
// columns the tile's query rows q0 + c): st (raw k q^T) becomes p, dpt
// (v do^T) becomes ds; sl, sd the tile's lse and delta
template <bool MASK, int NS>
__device__ __forceinline__ void dkv_step(float (&st)[NS][4],
                                         float (&dpt)[NS][4],
                                         const float* sl, const float* sd,
                                         const int (&kr)[2], int q0,
                                         const Dims& dm, float scale2) {
  const int fc = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = n * 8 + fc + (e & 1);
      float p = exp2f(fmaf(st[n][e], scale2, -sl[c] * kLog2e));
      if (MASK && !(q0 + c < dm.Sq && sees(dm, q0 + c, kr[e >> 1])))
        p = 0.f;
      st[n][e] = p;
      dpt[n][e] = p * (dpt[n][e] - sd[c]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, Dims dm) {
  constexpr int P = HD + 8, KS = HD / 16, NS = kTile / 8, NO = HD / 8;
  constexpr int T = kTile * P;
  constexpr bool kHold = HD <= 64;   // K and V fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // [kTile][P]
  bf16* sV = sK + kTile * P;                      // [kTile][P]
  bf16* ring = sV + kTile * P;                    // [2][Q, dO][kTile][P]
  // [2][lse, delta][kTile]
  float* rows = reinterpret_cast<float*>(ring + 4 * T);

  const long long bh = blockIdx.y;
  const int kb0 = blockIdx.x * kTile;
  const long long qoff = bh * dm.Sq * HD, koff = bh * dm.Sk * HD;
  const int fr = (threadIdx.x & 31) >> 2;
  const int wr = (threadIdx.x >> 5) * 16;
  // the first query row that can see key kb0 is kb0 itself
  const int q_lo = dm.causal ? kb0 : 0;
  const int n_tiles = q_lo < dm.Sq ? (dm.Sq - q_lo + kTile - 1) / kTile : 0;
  auto stage = [&](int i) { return ring + (i & 1) * 2 * T; };
  auto stage_rows = [&](int i) { return rows + (i & 1) * 2 * kTile; };
  auto load = [&](int i) {
    const int q0 = q_lo + i * kTile;
    copy_rows<HD>(stage(i), q + qoff, q0, kTile, dm.Sq);
    copy_rows<HD>(stage(i) + T, dout + qoff, q0, kTile, dm.Sq);
    float* sr = stage_rows(i);
    for (int r = threadIdx.x; r < 2 * kTile; r += kThreads) {
      const int row = q0 + r % kTile;        // r < kTile: lse, else delta
      const bool ok = row < dm.Sq;
      const float* src = (r < kTile ? lse : delta) + bh * dm.Sq;
      cp_async4(sr + r, src + (ok ? row : 0), ok);
    }
  };

  copy_rows<HD>(sK, k + koff, kb0, kTile, dm.Sk);
  copy_rows<HD>(sV, v + koff, kb0, kTile, dm.Sk);
  if (n_tiles > 0) load(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t ka[KS][4], va[KS][4];
  if constexpr (kHold) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldm_a<P>(ka[kk], sK, wr, kk);
      ldm_a<P>(va[kk], sV, wr, kk);
    }
  }
  auto k_frag = [&](uint32_t (&a)[4], int kk) {
    if constexpr (kHold) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = ka[kk][e];
    } else {
      ldm_a<P>(a, sK, wr, kk);
    }
  };
  auto v_frag = [&](uint32_t (&a)[4], int kk) {
    if constexpr (kHold) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = va[kk][e];
    } else {
      ldm_a<P>(a, sV, wr, kk);
    }
  };

  const float scale2 = dm.scale * kLog2e;
  int kr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) kr[h] = kb0 + wr + fr + 8 * h;
  const int key_lo = kb0 + wr;   // the warp's first key
  float dka[NO][4], dva[NO][4];
  zero(dka);
  zero(dva);
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();   // as in the forward
    if (i + 1 < n_tiles) load(i + 1);
    cp_async_commit();
    const int q0 = q_lo + i * kTile;
    if (dm.causal && q0 + kTile - 1 < key_lo) continue;   // warp-uniform
    const bf16* sq = stage(i);
    const bf16* sdo = sq + T;
    const float* sl = stage_rows(i);
    float st[NS][4], dpt[NS][4];
    zero(st);
    zero(dpt);
    mma_abt<KS, NS, P>(st, k_frag, sq);     // k q^T
    mma_abt<KS, NS, P>(dpt, v_frag, sdo);   // v do^T
    if ((dm.causal && q0 < key_lo + 15) || q0 + kTile > dm.Sq)
      dkv_step<true>(st, dpt, sl, sl + kTile, kr, q0, dm, scale2);
    else
      dkv_step<false>(st, dpt, sl, sl + kTile, kr, q0, dm, scale2);
    mma_xb<kTile / 16, NO, P>(dva, st, sdo);   // p^T do
    mma_xb<kTile / 16, NO, P>(dka, dpt, sq);   // ds^T q
  }
  // each warp's rows of sK and sV are its own: they take its outputs
  const float mul[2] = {dm.scale, dm.scale};
  const float one[2] = {1.f, 1.f};
  store_tile<HD>(dk + koff, dka, sK + wr * P, key_lo, dm.Sk, mul);
  store_tile<HD>(dv + koff, dva, sV + wr * P, key_lo, dm.Sk, one);
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
    PT_LAUNCH(fwd_mma_kernel<HD>, grid_of(dm.Sq, kTile, BH),
              ring_bytes<HD>(), st, static_cast<const bf16*>(q),
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
    PT_LAUNCH(dq_mma_kernel<HD>, grid_of(dm.Sq, kTile, BH),
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
    PT_LAUNCH(dkv_mma_kernel<HD>, grid_of(dm.Sk, kTile, BH),
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
    case 32:                             \
      return call<32>(__VA_ARGS__);      \
    case 64:                             \
      return call<64>(__VA_ARGS__);      \
    case 96:                             \
      return call<96>(__VA_ARGS__);      \
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
