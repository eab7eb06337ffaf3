// RMSNorm forward and backward (K5a, K5b) for Hopper, sm_90a.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/rms_norm.py:
// _pallas_fwd (K5a) and _pallas_bwd (K5b). Same functions, f32 math:
//
//   forward   out = x * rsqrt(mean(x^2) + eps) * w        per row, x's type
//   backward  xhat = x * rstd, gw = g * w
//             dx = rstd * (gw - xhat * mean(gw * xhat))   per row, x's type
//             dw = sum over every row of g * xhat         in f32, w's type
//
// Layouts (row-major, contiguous): x, g, out, dx [rows, d]; w, dw [d];
// f32 or bf16, w of x's type; d a multiple of 8.
//
// What bounds it on this card: bytes. Each element costs a handful of
// operations against 2 (bf16) or 4 (f32) bytes read or written, two orders
// of magnitude below the ridge point. At llama_350m's shape (8192 rows of
// 1024, bf16) the forward moves 33.6 MB, 0.010 ms at 3.35 TB/s.
//
// Forward (K5a). One block per row: each thread holds NCH 16-byte chunks
// of the row in registers, so x is read once; the sum of squares is a
// block reduction.
//
// Backward (K5b), a streaming kernel that fills the card. The Pallas
// kernel carries dw across its sequential grid in VMEM scratch; blocks
// here run in no order. So:
// - a row goes to W warps (W = 1 up to 2 KB of x a row: 1024 bf16, 512
//   f32; more warps, a power of two up to 8, above that), each lane
//   holding at most 4 of the row's 16-byte chunks (8 at the widest rows),
//   the same columns on every row. A row's two sums (x^2 and g w x) are
//   warp shuffles, with one shared-memory step between the row's W warps
//   (a named barrier);
// - each warp stages its rows through a ring of kStages = 3 rows' cp.async
//   buffers in shared memory: the next two rows' x and g are in flight
//   (8 loads of 16 bytes a lane a row) while the current row computes. A
//   lane reads back only the chunks it copied, so the staging needs no
//   barrier;
// - the grid is the occupancy query's blocks a SM times the SM count (or
//   fewer when rows are few), blocks of 8 warps, and row group q of
//   nq walks rows q, q + nq, ... (a static plan: ops/kernels/rms_norm.py,
//   bwd_plan, models it);
// - dw, in a fixed order, no float atomics: each lane keeps its columns'
//   dw in f32 registers over its group's rows; a block adds its groups'
//   partials in group order through shared memory into one f32 row of a
//   [nb, d] buffer; rms_dw_reduce_kernel then spreads columns over blocks
//   of 32 and the nb rows over 32 warps (warp k adds rows k, k + 32, ...),
//   and adds the 32 warp sums in order. It is a programmatic dependent
//   launch, so its launch overlaps the row kernel's tail. dw is the same
//   bit for bit from launch to launch.
// (In the backward xhat's mean is taken as rstd * sum(g w x) / d: the same
// sum as the reference's mean(g w xhat), multiplied out once.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

using pt_attn::load16;
using pt_attn::store;
using pt_attn::warp_sum;

constexpr int kMaxThreads = 256;

__device__ __forceinline__ void store16(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* x) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// Sum of v over the block, the same value (same order) in every thread.
// blockDim.x is a multiple of 32.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[kMaxThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += part[w];
  __syncthreads();   // part is reused by the next call
  return s;
}

// this thread's c-th chunk of a row: index in 16-byte chunks, or -1
__device__ __forceinline__ int chunk(int c, int nch) {
  const int ch = threadIdx.x + c * static_cast<int>(blockDim.x);
  return ch < nch ? ch : -1;
}

template <typename T, int NCH>
__global__ void __launch_bounds__(kMaxThreads)
rms_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int nch = d / VEC;
  const long long row = static_cast<long long>(blockIdx.x) * d;
  float xv[NCH][VEC];
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int ch = chunk(c, nch);
    if (ch >= 0) {
      load16(x + row + ch * VEC, xv[c]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) xv[c][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss += xv[c][e] * xv[c][e];
  }
  const float rstd = rsqrtf(block_sum(ss) / d + eps);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int ch = chunk(c, nch);
    if (ch < 0) continue;
    float wv[VEC], y[VEC];
    load16(w + ch * VEC, wv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) y[e] = xv[c][e] * rstd * wv[e];
    store16(out + row + ch * VEC, y);
  }
}

// ------------------------------------------------------------ backward

namespace bwd {

constexpr int kWarps = 8;                 // a block's warps
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;                // rows of a warp in its ring
constexpr int kReduceWarps = 32;          // the dw reduction's warps

// 16 bytes of T as floats
template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  if constexpr (sizeof(T) == 4) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
}

// shared memory of a block: per warp a [kStages][x, g][NV][32 lanes] ring
// of 16-byte chunks, then the row groups' two sums [2 parities][warps][2]
template <int NV>
constexpr int kRingBytes = kStages * 2 * NV * 512;      // one warp's
template <int NV>
constexpr int kSmemBytes = kWarps * kRingBytes<NV> + 2 * kWarps * 2 * 4;

// rows of d elements, W warps a row (kWarps / W rows a block at once),
// NV chunks of 16 bytes a lane; dw_part [gridDim.x, d] f32
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, NV >= 8 ? 1 : 2)
rms_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ g, T* __restrict__ dx,
               float* __restrict__ dw_part, int rows, int d, int W,
               float eps) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = kWarps / W;
  const int grp = warp / W, wr = warp % W;     // row group, warp in it
  const int nch = d / VEC;
  unsigned char* ring = smem + warp * kRingBytes<NV> + lane * 16;
  float* sums = reinterpret_cast<float*>(smem + kWarps * kRingBytes<NV>);

  // this lane's chunks of a row: wr * 32 + lane + c * 32 W, c < NV
  int ch[NV];
  uint4 wv[NV];
  float dwa[NV][VEC];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    ch[c] = wr * 32 + lane + c * 32 * W;
    wv[c] = make_uint4(0u, 0u, 0u, 0u);
    if (ch[c] < nch) wv[c] = __ldg(reinterpret_cast<const uint4*>(w) + ch[c]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) dwa[c][e] = 0.f;
  }
  // stage s, tensor q (0 = x, 1 = g), chunk c of this lane
  auto slot = [&](int s, int q, int c) {
    return ring + ((s * 2 + q) * NV + c) * 512;
  };
  auto issue = [&](int r, int s) {
    const long long base = static_cast<long long>(r) * nch;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      if (ch[c] < nch) {
        pt_attn::cp_async16(slot(s, 0, c),
                            reinterpret_cast<const uint4*>(x) + base + ch[c],
                            true);
        pt_attn::cp_async16(slot(s, 1, c),
                            reinterpret_cast<const uint4*>(g) + base + ch[c],
                            true);
      }
    }
  };

  // the reduction may launch now: it waits for this grid's end itself
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int stride = gridDim.x * groups;
  const int first = blockIdx.x * groups + grp;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (first + i * stride < rows) issue(first + i * stride, i);
    pt_attn::cp_async_commit();
  }
  for (int r = first, it = 0; r < rows; r += stride, ++it) {
    // the row kStages - 1 ahead goes into the stage read last time
    const int ahead = r + (kStages - 1) * stride;
    if (ahead < rows) issue(ahead, (it + kStages - 1) % kStages);
    pt_attn::cp_async_commit();
    pt_attn::cp_async_wait<kStages - 1>();   // this row's chunks landed
    const int s = it % kStages;
    float ss = 0.f, gwx = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      if (ch[c] >= nch) continue;
      float xv[VEC], gv[VEC], wf[VEC];
      unpack<T>(*reinterpret_cast<const uint4*>(slot(s, 0, c)), xv);
      unpack<T>(*reinterpret_cast<const uint4*>(slot(s, 1, c)), gv);
      unpack<T>(wv[c], wf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ss += xv[e] * xv[e];
        gwx += gv[e] * wf[e] * xv[e];
      }
    }
    ss = warp_sum(ss);
    gwx = warp_sum(gwx);
    if (W > 1) {   // the row's W warps add their sums in warp order
      float* mine = sums + ((it & 1) * kWarps + warp) * 2;
      if (lane == 0) {
        mine[0] = ss;
        mine[1] = gwx;
      }
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(32 * W)
                   : "memory");
      const float* row_sums = sums + ((it & 1) * kWarps + grp * W) * 2;
      ss = gwx = 0.f;
      for (int i = 0; i < W; ++i) {
        ss += row_sums[2 * i];
        gwx += row_sums[2 * i + 1];
      }
    }
    const float rstd = rsqrtf(ss / d + eps);
    const float mean_gx = gwx * rstd / d;     // mean(g w xhat)
    const long long row = static_cast<long long>(r) * d;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      if (ch[c] >= nch) continue;
      float xv[VEC], gv[VEC], wf[VEC], y[VEC];
      unpack<T>(*reinterpret_cast<const uint4*>(slot(s, 0, c)), xv);
      unpack<T>(*reinterpret_cast<const uint4*>(slot(s, 1, c)), gv);
      unpack<T>(wv[c], wf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = xv[e] * rstd;
        y[e] = rstd * (gv[e] * wf[e] - xh * mean_gx);
        dwa[c][e] += gv[e] * xh;
      }
      store16(dx + row + ch[c] * VEC, y);
    }
  }
  pt_attn::cp_async_wait<0>();
  __syncthreads();   // every warp is done with its ring: it takes dw

  // the groups' dw rows, then their sum in group order
  float* red = reinterpret_cast<float*>(smem);          // [groups][d]
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    if (ch[c] >= nch) continue;
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      store16(red + grp * d + ch[c] * VEC + e, dwa[c] + e);
  }
  __syncthreads();
  float* part = dw_part + static_cast<long long>(blockIdx.x) * d;
  for (int j = 4 * threadIdx.x; j < d; j += 4 * kThreads) {
    float4 a = *reinterpret_cast<const float4*>(red + j);
    for (int q = 1; q < groups; ++q) {
      const float4 b = *reinterpret_cast<const float4*>(red + q * d + j);
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    *reinterpret_cast<float4*>(part + j) = a;
  }
}

// dw[j] = sum over b of part[b][j]: a block of 32 columns, warp k adds
// rows k, k + kReduceWarps, ... in order, then the warp sums are added
// in warp order. Launched as the row kernel's programmatic dependent: it
// may start before that grid ends, and waits for it (and its writes)
// before it reads a partial.
template <typename T>
__global__ void __launch_bounds__(32 * kReduceWarps)
rms_dw_reduce_kernel(const float* __restrict__ part, int nb, int d,
                     T* __restrict__ dw) {
  __shared__ float acc[kReduceWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float s = 0.f;
  if (j < d) {
#pragma unroll 4
    for (int b = warp; b < nb; b += kReduceWarps)
      s += part[static_cast<long long>(b) * d + j];
  }
  acc[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < d) {
    float t = acc[0][lane];
    for (int k = 1; k < kReduceWarps; ++k) t += acc[k][lane];
    store(dw + j, t);
  }
}

template <typename T, int NV>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(rms_bwd_kernel<T, NV>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes<NV>);
}

template <typename T, int NV>
cudaError_t occupancy(int* blocks_per_sm) {
  const cudaError_t e = set_smem<T, NV>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, rms_bwd_kernel<T, NV>, kThreads, kSmemBytes<NV>);
}

template <typename T, int NV>
cudaError_t run(const void* x, const void* w, const void* g, void* dx,
                void* dw, float* part, int rows, int d, int nb, int W,
                float eps, cudaStream_t st) {
  cudaError_t e = set_smem<T, NV>();
  if (e != cudaSuccess) return e;
  constexpr int smem = kSmemBytes<NV>;
  rms_bwd_kernel<T, NV><<<nb, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<T*>(dx), part, rows, d, W, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((d + 31) / 32);
  cfg.blockDim = dim3(32 * kReduceWarps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, rms_dw_reduce_kernel<T>,
                         static_cast<const float*>(part), nb, d,
                         static_cast<T*>(dw));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the instantiation for NV chunks a lane (1, 2, 4 or 8)
template <typename T, typename F>
cudaError_t by_nv(int nv, F&& f) {
  switch (nv) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* g, void* dx,
                   void* dw, float* part, int rows, int d, int nb, int W,
                   int nv, float eps, cudaStream_t st) {
  return by_nv<T>(nv, [&](auto k) {
    return run<T, decltype(k)::value>(x, w, g, dx, dw, part, rows, d, nb, W,
                                      eps, st);
  });
}

}  // namespace bwd

// threads per block and 16-byte chunks per thread for a row of d elements
template <typename T>
bool shape(int d, int* threads, int* nch_per_thread) {
  constexpr int VEC = 16 / sizeof(T);
  const int nch = d / VEC;
  int t = ((nch + 31) / 32) * 32;
  if (t > kMaxThreads) t = kMaxThreads;
  const int per = (nch + t - 1) / t;
  *threads = t;
  *nch_per_thread = per <= 1 ? 1 : per <= 2 ? 2 : per <= 4 ? 4 : per <= 8 ? 8
                                                                          : 0;
  return *nch_per_thread != 0;
}

template <typename T>
cudaError_t fwd(const void* x, const void* w, void* out, int rows, int d,
                float eps, cudaStream_t st) {
  int threads, per;
  if (!shape<T>(d, &threads, &per)) return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  switch (per) {
    case 1:
      rms_fwd_kernel<T, 1><<<rows, threads, 0, st>>>(xp, wp, op, d, eps);
      break;
    case 2:
      rms_fwd_kernel<T, 2><<<rows, threads, 0, st>>>(xp, wp, op, d, eps);
      break;
    case 4:
      rms_fwd_kernel<T, 4><<<rows, threads, 0, st>>>(xp, wp, op, d, eps);
      break;
    default:
      rms_fwd_kernel<T, 8><<<rows, threads, 0, st>>>(xp, wp, op, d, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int rms_norm_fwd_launch(const void* x, const void* w, void* out,
                                   int rows, int d, int dtype, float eps,
                                   void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (d <= 0 || d % 8 != 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, w, out, rows, d, eps, st);
  if (dtype == 1) return fwd<__nv_bfloat16>(x, w, out, rows, d, eps, st);
  return cudaErrorInvalidValue;
}

// dw_part: f32 scratch of nb * d elements, 1 <= nb; W warps a row (1, 2,
// 4 or 8), nv 16-byte chunks a lane (1, 2, 4 or 8), W * nv * 32 chunks
// covering a row (ops/kernels/rms_norm.py, bwd_plan, picks them).
extern "C" int rms_norm_bwd_launch(const void* x, const void* w,
                                   const void* g, void* dx, void* dw,
                                   void* dw_part, int rows, int d, int nb,
                                   int warps_per_row, int chunks_per_lane,
                                   int dtype, float eps, void* stream) {
  if (rows <= 0) return cudaSuccess;
  const int W = warps_per_row, nv = chunks_per_lane;
  const int vec = dtype == 0 ? 4 : 8;
  if (d <= 0 || d % 8 != 0 || nb <= 0 || (W != 1 && W != 2 && W != 4 &&
                                           W != 8) ||
      W * nv * 32 * vec < d)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(dw_part);
  if (dtype == 0)
    return bwd::launch<float>(x, w, g, dx, dw, part, rows, d, nb, W, nv, eps,
                              st);
  if (dtype == 1)
    return bwd::launch<__nv_bfloat16>(x, w, g, dx, dw, part, rows, d, nb, W,
                                      nv, eps, st);
  return cudaErrorInvalidValue;
}

// *blocks_per_sm: resident blocks of the backward's row kernel a SM for
// dtype (0 = float32, 1 = bfloat16) and nv chunks a lane, from the
// occupancy query. Returns a cudaError_t.
extern "C" int rms_norm_bwd_blocks_per_sm(int dtype, int chunks_per_lane,
                                          int* blocks_per_sm) {
  if (dtype == 0)
    return bwd::by_nv<float>(chunks_per_lane, [&](auto k) {
      return bwd::occupancy<float, decltype(k)::value>(blocks_per_sm);
    });
  if (dtype == 1)
    return bwd::by_nv<__nv_bfloat16>(chunks_per_lane, [&](auto k) {
      return bwd::occupancy<__nv_bfloat16, decltype(k)::value>(
          blocks_per_sm);
    });
  return cudaErrorInvalidValue;
}
