// Paged decode attention (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py:
// _paged_attention_pallas -> pallas_call(_paged_attn_kernel). Same
// function: one query row per slot attends over that slot's K/V pages,
// found through its block table, masked by its length; GQA in-kernel
// (query head h reads kv head h / rep); online softmax in f32; a slot
// of length 0 writes zeros (the l == 0 guard of the TPU kernel).
//
// Layouts (row-major, contiguous):
//   q            [S, nh, hd]          f32 or bf16
//   k/v pages    [P, pg, kvh, hd]     same type as q
//   block_tables [S, maxp]            int32 page ids
//   lengths      [S]                  int32 valid tokens per slot
//   out          [S, nh, hd]          same type as q
//
// What bounds it on this card: memory. A decode step reads each valid
// K and V row once, about sum_s min(len_s, maxp*pg) * kvh * hd * 2 *
// sizeof(T) bytes, against ~4 * nh * hd FLOPs per token: two orders of
// magnitude below the H100's ridge point.
//
// bf16: the split-K body of paged_decode.cuh (one block per slot, kv
// head and split of pages_per_split table columns; 64-key tiles gathered
// by 16-byte cp.async into a two-stage ring; mma.sync with ldmatrix /
// ldmatrix.trans; the splits merged in index order by a second kernel,
// launched here too). Here split z holds columns z * pages_per_split ..,
// and the keys visible to a slot are 0 .. min(len, maxp * pg) - 1: a
// parked length past the table (max_cache_len + 1) is clamped, and no
// column at or past the frontier is read.
//
// f32: the SIMT kernel of the first port (f32 keeps f32 products): one
// block per (slot, kv head) carrying its rep query heads; 8 warps take
// the slot's tokens round-robin, each lane holding hd / 32 dims
// (decode_attend in attention_common.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#include "attention_common.cuh"
#include "paged_decode.cuh"

namespace {

using namespace pt_attn;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int nh, int kvh, int pg, int maxp, float scale) {
  const int s = blockIdx.x;
  const int g = blockIdx.y;
  const int rep = nh / kvh;
  // tokens to visit: the slot's length, clamped to the table's span
  const long long span = static_cast<long long>(maxp) * pg;
  long long len = lengths[s];
  if (len < 0) len = 0;
  const int n_tok = static_cast<int>(len < span ? len : span);
  const int* row_bt = bt + static_cast<long long>(s) * maxp;
  const long long at = (static_cast<long long>(s) * nh + g * rep) * HD;
  decode_attend<T, HD, kWarps>(
      q + at, kp, vp, out + at, rep, kvh, g, n_tok,
      [=](int j) {
        return static_cast<long long>(row_bt[j / pg]) * pg + j % pg;
      },
      scale);
}

template <int HD>
__global__ void __launch_bounds__(kSplitThreads, 3)
paged_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ kp,
                          const __nv_bfloat16* __restrict__ vp,
                          const int* __restrict__ bt,
                          const int* __restrict__ lengths,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ ws, int nh, int kvh, int pg,
                          int maxp, int pps, int splits, float scale) {
  __shared__ SplitPages pages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s = blockIdx.x;
  const int g = blockIdx.y;
  const int z = blockIdx.z;
  const int rep = nh / kvh;
  // visible keys: the slot's length, clamped to the table's span
  const long long span = static_cast<long long>(maxp) * pg;
  long long len = lengths[s];
  if (len < 0) len = 0;
  if (len > span) len = span;
  const int col0 = z * pps;              // the split's first column
  const long long keys = static_cast<long long>(pps) * pg;  // a split's
  long long n = len - static_cast<long long>(col0) * pg;
  if (n < 0) n = 0;
  if (n > keys) n = keys;
  const int* row_bt = bt + static_cast<long long>(s) * maxp + col0;
  for (int e = threadIdx.x; e * static_cast<long long>(pg) < n;
       e += kSplitThreads) {
    pages.id[e] = row_bt[e];
    pages.base[e] = (col0 + e) * pg;
  }
  __syncthreads();
  const long long v0 = static_cast<long long>(s) * nh + g * rep;
  const bool direct = splits == 1;
  split_decode<HD>(q + v0 * HD, kp, vp, rep, kvh, g, pg, pages,
                   static_cast<int>(n), len - 1, scale,
                   direct ? out + v0 * HD : nullptr,
                   direct ? nullptr : ws + (v0 * splits + z) * (HD + 2),
                   static_cast<long long>(splits) * (HD + 2), smem_raw);
}

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const int* bt;
  const int* lengths;
  void* out;
  float* ws;
  int S, nh, kvh, pg, maxp, pps, splits;
  float scale;
  cudaStream_t stream;
};

template <int HD>
cudaError_t launch_f32(const Args& a) {
  const dim3 grid(a.S, a.kvh);
  paged_decode_kernel<float, HD><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.kp),
      static_cast<const float*>(a.vp), a.bt, a.lengths,
      static_cast<float*>(a.out), a.nh, a.kvh, a.pg, a.maxp, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const Args& a) {
  if (a.pps < 1 || a.pps > kMaxSplitPages || a.splits < 1 ||
      a.splits > 65535 ||
      static_cast<long long>(a.pps) * a.splits < a.maxp ||
      (a.splits > 1 && a.ws == nullptr))
    return cudaErrorInvalidValue;
  constexpr size_t smem = split_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      paged_decode_split_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  using bf16 = __nv_bfloat16;
  bf16* out = static_cast<bf16*>(a.out);
  const dim3 grid(a.S, a.kvh, a.splits);
  paged_decode_split_kernel<HD><<<grid, kSplitThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.kp),
      static_cast<const bf16*>(a.vp), a.bt, a.lengths, out, a.ws, a.nh,
      a.kvh, a.pg, a.maxp, a.pps, a.splits, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  split_merge_kernel<HD><<<a.S * a.nh, HD < 32 ? 32 : HD, 0, a.stream>>>(
      a.ws, out, a.splits);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const Args& a, int dtype) {
  if (dtype == 0) return launch_f32<HD>(a);
  if (dtype == 1) return launch_bf16<HD>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bf16 takes the split plan
// (pages_per_split columns a split, `splits` splits covering maxp) and,
// with more than one split, a float32 workspace of S * nh * splits *
// (hd + 2) elements; f32 ignores them. Returns a cudaError_t (0 =
// launched).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_tables,
                                      const void* lengths, void* out,
                                      void* workspace, int S, int nh,
                                      int kvh, int hd, int pg, int maxp,
                                      int pages_per_split, int splits,
                                      int dtype, float sm_scale,
                                      void* stream) {
  if (S <= 0) return cudaSuccess;
  if (kvh <= 0 || nh % kvh != 0 || nh / kvh > pt_attn::kMaxRep || pg <= 0 ||
      maxp <= 0 || kvh > 65535 || static_cast<long long>(maxp) * pg > INT_MAX)
    return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages,
               static_cast<const int*>(block_tables),
               static_cast<const int*>(lengths), out,
               static_cast<float*>(workspace), S, nh, kvh, pg, maxp,
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
