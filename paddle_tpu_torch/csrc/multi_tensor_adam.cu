// Multi-tensor Adam / AdamW step for Hopper, sm_90a: the optimizer's
// fused step over every live parameter of a model.
//
// Replaces paddle_tpu/optimizer/optimizer.py:62 (_get_fused_step): there
// the JAX package jits one XLA program that clips the gradients by their
// global norm and applies Adam._update_leaf (optimizer.py:298-316) to
// every live parameter, its counterpart of the reference framework's
// fused_adam_kernel.cu. It is an XLA fusion, not a pallas_call; the port
// runs it as up to three kernels over a table of chunks:
//
//   (a) sumsq_kernel: one block a chunk of one gradient; the block's sum
//       of squares (gradients widened to f32) written as one f32 partial;
//   (b) scale_kernel: one block sums the partials in a fixed order and
//       writes clip_norm / max(sqrt(sum), clip_norm) and the norm to
//       device memory, so the clip needs no host sync and two runs give
//       the same bits;
//   (c) update_kernel: one block a chunk; each element as
//       Adam._update_leaf computes it, in this order:
//         g = f32(grad); with the clip g = f32(T(g * scale)) (the clipped
//         gradient is rounded back to its own type first, as clip.py:63
//         does); Adam's L2 decay g += wd * p; m = b1 m + (1 - b1) g;
//         v = b2 v + (1 - b2) g g; mhat = m / bc1; vhat = v / bc2;
//         upd = mhat / (sqrt(vhat) + eps); AdamW's decay upd += wd * p;
//         p = p - lr upd, kept in the f32 master where there is one and
//         rounded to the parameter's type.
//       p is the f32 master when the parameter has one (multi_precision
//       and a bf16 / f16 parameter), else the parameter widened to f32.
//       Every operation is written with __fmul_rn / __fadd_rn / __fsub_rn
//       / __fdiv_rn / __fsqrt_rn: nvcc contracts nothing into a fused
//       multiply-add, and the divisions are true f32 divisions (torch on
//       the card multiplies by a reciprocal when it divides by a Python
//       number), so the kernel is the plain version run on the CPU bit
//       for bit.
//
// Tensors of f32, bf16 and f16 parameters mix in one launch: the
// metadata table (one row of kMetaWords 64-bit words a tensor: parameter,
// m, v and master pointers, element count, type, weight decay's f32 bits,
// whether the tensor decays) is built once per live set on the host and
// kept on the card; moments and masters are f32. Gradient pointers change
// every step, so they ride each launch as a kernel argument (GradPtrs,
// kMaxTensors of them; more tensors take more launch groups). The chunk
// table lists (tensor of the group, chunk of the tensor) pairs, kChunk
// elements a chunk: a block's chunk is one tensor's, so its type and
// pointers are uniform across the block.
//
// What bounds it on this card: bytes. About 15 f32 operations an element
// against 22 bytes (bf16 parameter, no master: g, p, m, v read; p, m, v
// written), 28 (bf16 with an f32 master: g, master, m, v read; p, master,
// m, v written) or 28 (f32): far below the ridge point. A thread moves 8
// elements an iteration: 16-byte loads and stores of every array when all
// of a tensor's pointers are 16-byte aligned (chunk offsets are multiples
// of kChunk), one element at a time otherwise and for the ragged tail of
// a tensor.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                 // elements a thread an iteration
constexpr int kChunk = 16384;           // elements a block
constexpr int kMaxTensors = 256;        // gradients a launch group
constexpr int kScaleThreads = 1024;
constexpr int kMetaWords = 8;
enum : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

struct GradPtrs {
  const void* g[kMaxTensors];
};

struct Hyper {
  float lr, beta1, omb1, beta2, omb2, eps, bc1, bc2;
  int decoupled;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}
// v rounded to T and widened back (the identity for f32)
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, __half) {
  return __half2float(__float2half_rn(v));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// kVec consecutive elements at p (16-byte aligned) as floats, and back
__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
template <typename H>
__device__ __forceinline__ void load8(const H* p, float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const H* h = reinterpret_cast<const H*>(&u);
#pragma unroll
  for (int j = 0; j < kVec; ++j) x[j] = to_f32(h[j]);
}
__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
template <typename H>
__device__ __forceinline__ void store8(H* p, const float (&x)[kVec]) {
  uint4 u;
  H* h = reinterpret_cast<H*>(&u);
#pragma unroll
  for (int j = 0; j < kVec; ++j) store(h + j, x[j]);
  *reinterpret_cast<uint4*>(p) = u;
}

// the block's sum of v over kThreads threads in a fixed order: lanes by
// a butterfly, then the warps' sums added in warp order by thread 0
template <int Threads>
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_part[Threads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    s = warp_part[0];
    for (int w = 1; w < Threads / 32; ++w) s = __fadd_rn(s, warp_part[w]);
  }
  return s;
}

// the chunk a block owns: its tensor's metadata row and element range
struct Chunk {
  const long long* row;
  int tensor;
  long long off;
  int len;
};

__device__ __forceinline__ Chunk chunk_of(const long long* __restrict__ meta,
                                          const int2* __restrict__ chunks) {
  const int2 c = chunks[blockIdx.x];
  Chunk k;
  k.tensor = c.x;
  k.row = meta + static_cast<long long>(c.x) * kMetaWords;
  k.off = static_cast<long long>(c.y) * kChunk;
  const long long rest = k.row[4] - k.off;
  k.len = static_cast<int>(rest < kChunk ? rest : kChunk);
  return k;
}

template <typename T>
__device__ __forceinline__ float sumsq_chunk(const T* __restrict__ g,
                                             int len) {
  float acc = 0.f;
  int start = 0;
  if (aligned16(g)) {
    const int nv = len / kVec;
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      float x[kVec];
      load8(g + static_cast<long long>(i) * kVec, x);
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc = __fmaf_rn(x[j], x[j], acc);
    }
    start = nv * kVec;
  }
  for (int i = start + threadIdx.x; i < len; i += kThreads) {
    const float x = to_f32(g[i]);
    acc = __fmaf_rn(x, x, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    sumsq_kernel(const long long* __restrict__ meta,
                 const int2* __restrict__ chunks, GradPtrs gp,
                 float* __restrict__ partials) {
  const Chunk k = chunk_of(meta, chunks);
  const void* g = gp.g[k.tensor];
  float acc;
  switch (static_cast<int>(k.row[5])) {
    case kBF16:
      acc = sumsq_chunk(static_cast<const __nv_bfloat16*>(g) + k.off, k.len);
      break;
    case kF16:
      acc = sumsq_chunk(static_cast<const __half*>(g) + k.off, k.len);
      break;
    default:
      acc = sumsq_chunk(static_cast<const float*>(g) + k.off, k.len);
  }
  acc = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kScaleThreads)
    scale_kernel(const float* __restrict__ partials, int n, float clip_norm,
                 float* __restrict__ out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kScaleThreads)
    acc = __fadd_rn(acc, partials[i]);
  acc = block_sum<kScaleThreads>(acc);
  if (threadIdx.x == 0) {
    const float gn = __fsqrt_rn(acc);
    // max(gn, clip_norm) as the reference's jnp.maximum: a NaN norm stays
    // NaN (fmaxf would drop it)
    const float den = gn != gn ? gn : fmaxf(gn, clip_norm);
    out[0] = __fdiv_rn(clip_norm, den);
    out[1] = gn;
  }
}

// one element of Adam._update_leaf; p32 in, new p32 out
template <typename T>
__device__ __forceinline__ void adam_elem(float g, float& p32, float& m,
                                          float& v, float scale, bool clip,
                                          float wd, bool decay,
                                          const Hyper& h) {
  if (clip) g = round_to(__fmul_rn(g, scale), T());
  if (decay && !h.decoupled) g = __fadd_rn(g, __fmul_rn(wd, p32));
  m = __fadd_rn(__fmul_rn(h.beta1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.beta2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  const float mhat = __fdiv_rn(m, h.bc1);
  const float vhat = __fdiv_rn(v, h.bc2);
  float upd = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps));
  if (decay && h.decoupled) upd = __fadd_rn(upd, __fmul_rn(wd, p32));
  p32 = __fsub_rn(p32, __fmul_rn(h.lr, upd));
}

template <typename T>
__device__ __forceinline__ void update_chunk(
    const T* __restrict__ g, T* __restrict__ p, float* __restrict__ m,
    float* __restrict__ v, float* __restrict__ master, int len, float scale,
    bool clip, float wd, bool decay, const Hyper& h) {
  int start = 0;
  if (aligned16(g) && aligned16(p) && aligned16(m) && aligned16(v)
      && (master == nullptr || aligned16(master))) {
    const int nv = len / kVec;
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      const long long e = static_cast<long long>(i) * kVec;
      float gx[kVec], px[kVec], mx[kVec], vx[kVec];
      load8(g + e, gx);
      if (master != nullptr) load8(master + e, px);
      else load8(p + e, px);
      load8(m + e, mx);
      load8(v + e, vx);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        adam_elem<T>(gx[j], px[j], mx[j], vx[j], scale, clip, wd, decay, h);
      store8(m + e, mx);
      store8(v + e, vx);
      if (master != nullptr) store8(master + e, px);
      store8(p + e, px);
    }
    start = nv * kVec;
  }
  for (int i = start + threadIdx.x; i < len; i += kThreads) {
    float p32 = master != nullptr ? master[i] : to_f32(p[i]);
    float mi = m[i], vi = v[i];
    adam_elem<T>(to_f32(g[i]), p32, mi, vi, scale, clip, wd, decay, h);
    m[i] = mi;
    v[i] = vi;
    if (master != nullptr) master[i] = p32;
    store(p + i, p32);
  }
}

__global__ void __launch_bounds__(kThreads)
    update_kernel(const long long* __restrict__ meta,
                  const int2* __restrict__ chunks, GradPtrs gp,
                  const float* __restrict__ clip_scale, Hyper h) {
  const Chunk k = chunk_of(meta, chunks);
  const bool clip = clip_scale != nullptr;
  const float scale = clip ? *clip_scale : 1.f;
  const float wd = __int_as_float(static_cast<int>(k.row[6]));
  const bool decay = k.row[7] != 0;
  float* m = reinterpret_cast<float*>(k.row[1]) + k.off;
  float* v = reinterpret_cast<float*>(k.row[2]) + k.off;
  float* master = k.row[3] != 0
      ? reinterpret_cast<float*>(k.row[3]) + k.off : nullptr;
  const void* g = gp.g[k.tensor];
  void* p = reinterpret_cast<void*>(k.row[0]);
  switch (static_cast<int>(k.row[5])) {
    case kBF16:
      update_chunk(static_cast<const __nv_bfloat16*>(g) + k.off,
                   static_cast<__nv_bfloat16*>(p) + k.off, m, v, master,
                   k.len, scale, clip, wd, decay, h);
      break;
    case kF16:
      update_chunk(static_cast<const __half*>(g) + k.off,
                   static_cast<__half*>(p) + k.off, m, v, master, k.len,
                   scale, clip, wd, decay, h);
      break;
    default:
      update_chunk(static_cast<const float*>(g) + k.off,
                   static_cast<float*>(p) + k.off, m, v, master, k.len,
                   scale, clip, wd, decay, h);
  }
}

bool fill(GradPtrs& gp, const unsigned long long* gptrs, int n_tensors) {
  if (n_tensors <= 0 || n_tensors > kMaxTensors || gptrs == nullptr)
    return false;
  for (int i = 0; i < n_tensors; ++i)
    gp.g[i] = reinterpret_cast<const void*>(gptrs[i]);
  for (int i = n_tensors; i < kMaxTensors; ++i) gp.g[i] = nullptr;
  return true;
}

}  // namespace

// (a) one f32 partial sum of squares a chunk into partials[0, n_chunks)
extern "C" int mta_sumsq_launch(const long long* meta, const int* chunks,
                                const unsigned long long* gptrs,
                                int n_tensors, int n_chunks, float* partials,
                                void* stream) {
  GradPtrs gp;
  if (!fill(gp, gptrs, n_tensors) || n_chunks < 0)
    return cudaErrorInvalidValue;
  if (n_chunks == 0) return cudaSuccess;
  if (meta == nullptr || chunks == nullptr || partials == nullptr)
    return cudaErrorInvalidValue;
  sumsq_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      meta, reinterpret_cast<const int2*>(chunks), gp, partials);
  return cudaGetLastError();
}

// (b) out[0] = clip_norm / max(sqrt(sum of partials), clip_norm), out[1]
// the norm
extern "C" int mta_scale_launch(const float* partials, int n,
                                float clip_norm, float* out, void* stream) {
  if (n < 0 || partials == nullptr || out == nullptr)
    return cudaErrorInvalidValue;
  scale_kernel<<<1, kScaleThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, n, clip_norm, out);
  return cudaGetLastError();
}

// (c) the update of every chunk, the clip scale read from clip_scale
// (nullptr: no clip)
extern "C" int mta_update_launch(const long long* meta, const int* chunks,
                                 const unsigned long long* gptrs,
                                 int n_tensors, int n_chunks,
                                 const float* clip_scale, float lr,
                                 float beta1, float omb1, float beta2,
                                 float omb2, float eps, float bc1, float bc2,
                                 int decoupled, void* stream) {
  GradPtrs gp;
  if (!fill(gp, gptrs, n_tensors) || n_chunks < 0)
    return cudaErrorInvalidValue;
  if (n_chunks == 0) return cudaSuccess;
  if (meta == nullptr || chunks == nullptr) return cudaErrorInvalidValue;
  const Hyper h{lr, beta1, omb1, beta2, omb2, eps, bc1, bc2, decoupled};
  update_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      meta, reinterpret_cast<const int2*>(chunks), gp, clip_scale, h);
  return cudaGetLastError();
}
