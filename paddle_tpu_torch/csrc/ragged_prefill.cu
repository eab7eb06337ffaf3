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
// bf16: tensor cores fed by asynchronous copies, in the row-tile body
// that K3's C >= 2 kernel shares (paged_prefill.cuh: one block of 4
// warps per 64 query vectors of a kv head's GQA group, 64-key tiles
// gathered by 16-byte cp.async into a two-stage ring, mma.sync with
// ldmatrix / ldmatrix.trans fragments, base-2 softmax, three blocks a
// SM). Here key i of the walk is position i, at the block table's column
// i / pg; the walk ends at min(t0 + the tile's last row, last,
// maxp * pg - 1), and block_tables is never indexed past it.
//
// f32: the SIMT kernel of the first port (f32 keeps f32 products; no
// TF32): one block per (slot, query head, 32 rows), 16-key tiles staged
// in shared memory as f32, 4 threads per row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "attention_common.cuh"
#include "paged_prefill.cuh"

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

// the row-tile body of paged_prefill.cuh over the slot's block table
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const RowTile t(t0s, lasts, C, nh, kvh, pg, maxp);
  const TableKeys keys{bt + static_cast<long long>(t.s) * maxp, pg, t.hi};
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
