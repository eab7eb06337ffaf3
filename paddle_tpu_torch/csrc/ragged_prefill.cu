// Ragged prefill attention over the paged KV pool (K2) for Hopper,
// sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/ragged_prefill.py:
// _ragged_prefill_pallas -> pallas_call(_ragged_prefill_kernel). Same
// function: each slot carries one packed prompt chunk of C query rows
// starting at absolute position t0[s]; row c attends causally to key
// positions <= t0[s] + c through the slot's block table; a slot with
// last[s] < 0 (the scheduler's idle sentinel) is skipped and writes
// zeros; GQA in-kernel; online softmax in f32 with the -1e30 mask.
//
// Layouts (row-major, contiguous):
//   q            [S, C, nh, hd]       f32 or bf16
//   k/v pages    [P, pg, kvh, hd]     same type as q
//   block_tables [S, maxp]            int32 page ids
//   t0, last     [S]                  int32 (last = t0 + take - 1, or -1)
//   out          [S, C, nh, hd]       same type as q
//
// What bounds it on this card: at long prompts, operations. Each row
// takes ~4 * hd FLOPs per visible key, so a 512-row chunk over ~1k
// keys is well above the ridge point in bf16; at short prompts the
// K/V bytes of the visible pages dominate.
//
// This first design, and what it does not do:
// - one thread block per (slot, query head, tile of 32 query rows);
//   the tile's Q rows are staged in shared memory in f32;
// - the block walks the keys in tiles of 16 positions up to the tile's
//   causal frontier min(t0 + last row of the tile, last, maxp*pg - 1),
//   so pages past it (and every page of an idle slot) are never read,
//   and block_tables is never indexed past its width; each key tile's
//   K and V rows are gathered through the block table into shared
//   memory;
// - 4 threads per query row: each computes 4 of the tile's 16 scores
//   (SIMT dot products from shared memory), the row's max and sum are
//   reduced over the 4 with warp shuffles, and each thread keeps hd/4
//   output dims of the f32 accumulator in registers;
// - no tensor cores (no mma.sync, no wgmma), no TMA, no cp.async
//   pipelining, and K/V rows are re-read once per query head of a GQA
//   group. Making it fast is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

using namespace pt_attn;

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

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* bt, const int* t0, const int* last, void* out,
                   int S, int C, int nh, int kvh, int hd, int pg, int maxp,
                   float scale, cudaStream_t stream) {
  const dim3 grid(S, nh, (C + kRows - 1) / kRows);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(kp);
  const T* vv = static_cast<const T*>(vp);
  T* oo = static_cast<T*>(out);
  switch (hd) {
    case 16:
      ragged_prefill_kernel<T, 16><<<grid, kThreads, 0, stream>>>(
          qq, kk, vv, bt, t0, last, oo, C, nh, kvh, pg, maxp, scale);
      break;
    case 64:
      ragged_prefill_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
          qq, kk, vv, bt, t0, last, oo, C, nh, kvh, pg, maxp, scale);
      break;
    case 128:
      ragged_prefill_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
          qq, kk, vv, bt, t0, last, oo, C, nh, kvh, pg, maxp, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int ragged_prefill_launch(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* block_tables,
                                     const void* t0, const void* last,
                                     void* out, int S, int C, int nh,
                                     int kvh, int hd, int pg, int maxp,
                                     int dtype, float sm_scale,
                                     void* stream) {
  if (S <= 0 || C <= 0) return cudaSuccess;
  if (kvh <= 0 || nh % kvh != 0 || pg <= 0 || maxp <= 0 || nh > 65535)
    return cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_tables);
  const int* t0p = static_cast<const int*>(t0);
  const int* lp = static_cast<const int*>(last);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, bt, t0p, lp, out, S, C, nh,
                         kvh, hd, pg, maxp, sm_scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, bt, t0p, lp, out, S,
                                 C, nh, kvh, hd, pg, maxp, sm_scale, st);
  return cudaErrorInvalidValue;
}
