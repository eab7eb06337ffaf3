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
// This first design, and what it does not do:
// - one thread block per (slot, kv head) carrying that kv head's rep
//   query heads, so each K/V row is read from device memory once for
//   the whole GQA group;
// - the block's 8 warps take the slot's tokens round-robin; in a warp
//   each lane holds hd/32 dims of q, the K row and the accumulator, the
//   dot product is a warp shuffle reduction, and the online softmax
//   state (m, l, acc) of every query head lives in registers; at the
//   end the warps' partial states are merged through shared memory
//   (decode_attend in attention_common.cuh, which K3's C == 1 kernel
//   runs too; here key j lies at block_tables[s][j / pg]);
// - the page loop stops at min(ceil(len / pg), maxp): the loop bound is
//   the early exit, and a length past the table (parked slots carry
//   max_cache_len + 1) is clamped so block_tables is never read out of
//   range;
// - SIMT dot products, plain loads, no cp.async, no TMA, no wgmma, no
//   split over pages across blocks. Making it fast is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

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

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* bt, const int* lengths, void* out, int S,
                   int nh, int kvh, int hd, int pg, int maxp, float scale,
                   cudaStream_t stream) {
  const dim3 grid(S, kvh);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(kp);
  const T* vv = static_cast<const T*>(vp);
  T* oo = static_cast<T*>(out);
  switch (hd) {
    case 16:
      paged_decode_kernel<T, 16><<<grid, kThreads, 0, stream>>>(
          qq, kk, vv, bt, lengths, oo, nh, kvh, pg, maxp, scale);
      break;
    case 64:
      paged_decode_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
          qq, kk, vv, bt, lengths, oo, nh, kvh, pg, maxp, scale);
      break;
    case 128:
      paged_decode_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
          qq, kk, vv, bt, lengths, oo, nh, kvh, pg, maxp, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_tables,
                                      const void* lengths, void* out, int S,
                                      int nh, int kvh, int hd, int pg,
                                      int maxp, int dtype, float sm_scale,
                                      void* stream) {
  if (S <= 0) return cudaSuccess;
  if (kvh <= 0 || nh % kvh != 0 || nh / kvh > pt_attn::kMaxRep || pg <= 0 ||
      maxp <= 0)
    return cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, bt, ln, out, S, nh, kvh, hd,
                         pg, maxp, sm_scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, bt, ln, out, S, nh,
                                 kvh, hd, pg, maxp, sm_scale, st);
  return cudaErrorInvalidValue;
}
