// jax.random's element-wise draws and dropout on one stream, for Hopper,
// sm_90a (R2).
//
// Replaces what the JAX package draws through jax.random inside its
// functional ops, jnp compositions with no pallas_call:
//   - the Gumbel noise -log(-log(uniform(minval, 1))) in f32
//     (paddle_tpu/nn/functional.py:161-172, gumbel_softmax's noise;
//     jax.random.gumbel);
//   - bernoulli's keep mask, uniform < p (alpha_dropout, :241-254);
//   - the draws of the random ops and the initializers
//     (paddle_tpu/ops/random_ops.py, paddle_tpu/nn/initializer.py:58-165):
//     the raw 32-bit bits (randint, the permutations' sort keys),
//     jax.random.uniform(minval, maxval), normal (sqrt(2) *
//     erf_inv(uniform(nextafter(-1, 0), 1)), XLA's f32 erf_inv
//     polynomial) and truncated_normal (the uniform over (erf(lo / sqrt
//     2), erf(hi / sqrt 2)), erf_inv, clipped), in f32 and in bf16 by
//     jax's 16-bit rule (8 random bits, the scale and the shift each
//     rounded to bf16, erf_inv in f32 rounded to bf16);
//   - dropout (:208-228, and scaled_dot_product_attention's dropout of
//     the attention output, :929-930): keep = uniform(mask shape) <
//     1 - p, then where(keep, v / (1 - p), 0) ("upscale_in_train") or
//     where(keep, v, 0), in v's type; and its gradient, the vjp of the
//     same expression: where(keep, g, 0) / (1 - p), or where(keep, g, 0).
//
// Counters are flat indices: element i of a draw of n elements hashes
// (hi(i), lo(i)) (threefry.cuh); below 2^32 elements the high word is 0
// and the 32-bit routes fold it away. Dropout's mask has its own shape —
// the value's, with 1 on every axis not in ``axis`` — and element i of
// the value takes the keep flag of its mask element.
//
// What bounds it on this card: the hash. Each mask element costs one
// Threefry-2x32 (20 rounds of add, rotate and xor and 6 key injections):
// at least 41 instructions only the integer ALU runs, 27 adds either the
// ALU or IMAD takes, and the keep test (threefry.cuh). Over the ALU's 64
// lanes an SM that bounds the full-mask bf16 forward at 8 x 1024 x 16 x
// 64 at ~0.021 ms, twice its 4 bytes an element. The compiled loop issues
// more (chip_smoke.py's rng phase counts the SASS an element: ~65 ALU,
// ~38 IMAD / VIADD, ~26 FP32 and ~26 other, the true division's checks
// and slow-path call among them) and runs at ~0.037 ms, near that
// count's issue time. The Gumbel draw adds 64 FP64 instructions (two f64
// logs) an element on the 64 FP64 lanes. The design spends nothing else
// an element:
//   - 16-byte bodies: a dropout item takes 8 consecutive mask elements
//     (one byte of the saved mask), a keep-mask item 16 flags, a Gumbel
//     item 4 values; the loads and stores are 16 bytes a thread on the
//     vector route, one element on the scalar route (unaligned pointers,
//     runs that do not hold whole 16-byte pieces);
//   - 32-bit indices and counters below 2^32 elements; the wide route
//     keeps 64-bit ones past that;
//   - the keep test on the bits ((bits >> 9) < thresh), no float;
//   - a broadcast mask hashes each mask element once per walk group, not
//     once per value element: the wrapper collapses the value's axes into
//     kept and broadcast runs, an item hashes its 8 mask elements and
//     walks the value elements that share them along the broadcast runs
//     (every groups-th step, so a warp's steps stay adjacent), dividing
//     by the runs' extents with magic numbers computed on the host
//     (__umulhi) on the 32-bit routes;
//   - the forward can write the keep flags as bits (1 bit a mask element,
//     1/16 of a bf16 value's bytes), and the backward reads them instead
//     of hashing again (the reference's vjp keeps ``keep`` as a residual):
//     ~21 integer ALU instructions an element instead of ~65, half the
//     time of a backward that hashes again, and the forward moves by
//     under 1% for the bits it stores.
// The division is a true f32 division (__fdiv_rn), rounded once to bf16
// or f16, as XLA on the CPU computes v / (1 - p) in the reference.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;
constexpr int kMaxRuns = 8;
constexpr int kChunk = 8;           // mask elements a dropout item hashes
enum : int { kF32 = 0, kBF16 = 1, kF16 = 2 };
// the draws (ops/kernels/threefry_fill.py: MODES) and their output types
enum : int {
  kKeep = 0, kGumbel = 1, kBits = 2, kUniform = 3, kNormal = 4,
  kTruncated = 5
};
enum : int { kOutF32 = 0, kOutBF16 = 1 };
enum : int { kScale = 0, kMask = 1, kScaleGrad = 2 };
enum : int { kVector = 0, kScalar = 1, kWide = 2 };

// a run of the collapsed value shape: its extent (in units: elements, or
// 8-element pieces for the innermost broadcast run of the vector route),
// the value stride of one step, and the magic pair dividing by the extent
struct Run {
  unsigned long long len, vstride;
  uint32_t magic, shift;
};

// the dropout launch's plan (ops/kernels/threefry_fill.py: dropout_plan)
struct Plan {
  int nk, nb;                     // kept and broadcast runs, innermost first
  int group_fast;                 // item = chunk * groups + group, else
                                  // group * chunks + chunk
  int inner_kept;                 // the innermost run is kept
  unsigned long long m;           // mask elements
  unsigned long long chunks;      // ceil(m / 8)
  unsigned long long groups;      // walk groups a chunk's steps split into
  unsigned long long steps;       // positions along the broadcast runs
  unsigned long long walk;        // a chunk's walk steps: steps, or 8 x
                                  // steps when each mask element walks alone
  uint32_t gmagic, gshift;        // divide an item by groups or by chunks
  uint32_t smagic, sshift;        // divide a walk step by steps
  Run k[kMaxRuns], b[kMaxRuns];
};

// n / d: on 32-bit indices (n < 2^32) by the round-up magic multiplier
// (Granlund-Montgomery: shift = ceil(log2 d), magic = 2^32 (2^shift - d)
// / d + 1), the 33-bit sum taken in 64 bits; on 64-bit ones by division
__device__ __forceinline__ uint32_t divide(uint32_t n, unsigned long long,
                                          uint32_t magic, uint32_t shift) {
  const uint32_t t = __umulhi(n, magic);
  return static_cast<uint32_t>(
      (static_cast<unsigned long long>(t) + n) >> shift);
}
__device__ __forceinline__ unsigned long long divide(
    unsigned long long n, unsigned long long d, uint32_t, uint32_t) {
  return n / d;
}

// value offset of the mask element mi (its flat index in the mask)
template <typename Idx>
__device__ __forceinline__ Idx kept_offset(Idx mi, const Plan& p) {
  Idx off = 0;
#pragma unroll
  for (int r = 0; r < kMaxRuns; ++r) {
    if (r >= p.nk) break;
    const Run& run = p.k[r];
    Idx idx = mi;
    if (r + 1 < p.nk) {
      const Idx q = divide(mi, run.len, run.magic, run.shift);
      idx = mi - q * static_cast<Idx>(run.len);
      mi = q;
    }
    off += idx * static_cast<Idx>(run.vstride);
  }
  return off;
}

// value offset of walk step j along the broadcast runs
template <typename Idx>
__device__ __forceinline__ Idx bcast_offset(Idx j, const Plan& p) {
  Idx off = 0;
#pragma unroll
  for (int r = 0; r < kMaxRuns; ++r) {
    if (r >= p.nb) break;
    const Run& run = p.b[r];
    Idx idx = j;
    if (r + 1 < p.nb) {
      const Idx q = divide(j, run.len, run.magic, run.shift);
      idx = j - q * static_cast<Idx>(run.len);
      j = q;
    }
    off += idx * static_cast<Idx>(run.vstride);
  }
  return off;
}

// an element's raw bits and its f32 value, both ways
template <typename T> struct Elem;
template <> struct Elem<float> {
  using Raw = uint32_t;
  static __device__ __forceinline__ float f32(Raw r) {
    return __uint_as_float(r);
  }
  static __device__ __forceinline__ Raw raw(float v) {
    return __float_as_uint(v);
  }
};
template <> struct Elem<__nv_bfloat16> {
  using Raw = unsigned short;
  static __device__ __forceinline__ float f32(Raw r) {
    return __bfloat162float(__ushort_as_bfloat16(r));
  }
  static __device__ __forceinline__ Raw raw(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <> struct Elem<__half> {
  using Raw = unsigned short;
  static __device__ __forceinline__ float f32(Raw r) {
    return __half2float(__ushort_as_half(r));
  }
  static __device__ __forceinline__ Raw raw(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

__device__ __forceinline__ float apply(float v, bool keep, int mode,
                                       float c) {
  if (mode == kScale) return keep ? __fdiv_rn(v, c) : 0.0f;
  if (mode == kMask) return keep ? v : 0.0f;
  return __fdiv_rn(keep ? v : 0.0f, c);           // kScaleGrad
}

// kN consecutive elements (8 on the vector route: one 16-byte word, two
// in f32; 1 on the scalar route), loaded, then masked and stored: element
// e kept by bit e of keep
template <typename T, int kN>
struct Piece {
  using Raw = typename Elem<T>::Raw;
  static constexpr int kWords = kN * static_cast<int>(sizeof(Raw)) / 16;
  alignas(16) Raw v[kN];

  __device__ __forceinline__ void load(const Raw* x) {
    if constexpr (kWords == 0) {
      v[0] = *x;
    } else {
#pragma unroll
      for (int w = 0; w < kWords; ++w)
        reinterpret_cast<uint4*>(v)[w] = reinterpret_cast<const uint4*>(x)[w];
    }
  }

  __device__ __forceinline__ void store(Raw* out, uint32_t keep, int mode,
                                        float c) {
#pragma unroll
    for (int e = 0; e < kN; ++e)
      v[e] = Elem<T>::raw(apply(Elem<T>::f32(v[e]), (keep >> e) & 1u, mode,
                                c));
    if constexpr (kWords == 0) {
      *out = v[0];
    } else {
#pragma unroll
      for (int w = 0; w < kWords; ++w)
        reinterpret_cast<uint4*>(out)[w] =
            reinterpret_cast<const uint4*>(v)[w];
    }
  }
};

constexpr int kDepth = 4;           // walk steps a thread has in flight

// Dropout over the plan: each item is (a chunk of 8 mask elements, a walk
// group). It hashes the chunk (or reads its byte of saved bits), writes
// the byte when asked (group 0 only), then walks steps g, g + groups, ...
// kDepth at a time, their loads issued before their stores. On the
// vector route with the innermost run kept, a step is one of the
// broadcast runs' positions and the chunk's 8 elements are 8 consecutive
// values there (one piece); otherwise step w is (mask element e = w /
// steps of the chunk, position w % steps), one piece of e's values: 8 of
// the innermost broadcast run (vector) or one (scalar).
template <typename T, typename Idx, bool kVec, bool kFromBits>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(uint32_t k0, uint32_t k1, const void* __restrict__ xv,
               void* __restrict__ outv, const uint8_t* __restrict__ bits_in,
               uint8_t* __restrict__ bits_out, const Plan p, int mode,
               float c, uint32_t thresh) {
  using Raw = typename Elem<T>::Raw;
  const Raw* __restrict__ x = static_cast<const Raw*>(xv);
  Raw* __restrict__ out = static_cast<Raw*>(outv);
  const Idx chunks = static_cast<Idx>(p.chunks);
  const Idx groups = static_cast<Idx>(p.groups);
  const Idx steps = static_cast<Idx>(p.steps);
  const Idx walk = static_cast<Idx>(p.walk);
  const Idx m = static_cast<Idx>(p.m);
  const Idx items = chunks * groups;
  const Idx stride = static_cast<Idx>(gridDim.x) * kThreads;
  for (Idx t = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x;
       t < items; t += stride) {
    Idx ch, g;
    if (p.group_fast) {
      ch = divide(t, p.groups, p.gmagic, p.gshift);
      g = t - ch * groups;
    } else {
      g = divide(t, p.chunks, p.gmagic, p.gshift);
      ch = t - g * chunks;
    }
    const Idx m0 = ch * kChunk;
    const int live = m - m0 < static_cast<Idx>(kChunk)
                         ? static_cast<int>(m - m0) : kChunk;
    uint32_t keep;
    if (kFromBits) {
      keep = bits_in[ch];
    } else {
      keep = 0;
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        keep |= static_cast<uint32_t>(tf::keep_bits(
                    tf::bits_at(k0, k1, m0 + static_cast<Idx>(e)), thresh))
                << e;
      keep &= (1u << live) - 1u;
    }
    if (bits_out != nullptr && g == 0)
      bits_out[ch] = static_cast<uint8_t>(keep);
    if (kVec && p.inner_kept) {         // whole chunks: live == 8
      const Idx voff = kept_offset(m0, p);
      for (Idx j0 = g; j0 < walk; j0 += kDepth * groups) {
        Piece<T, kChunk> in[kDepth];
        Idx off[kDepth];
#pragma unroll
        for (int d = 0; d < kDepth; ++d) {
          const Idx j = j0 + static_cast<Idx>(d) * groups;
          if (j < walk) {
            off[d] = voff + bcast_offset(j, p);
            in[d].load(x + off[d]);
          }
        }
#pragma unroll
        for (int d = 0; d < kDepth; ++d)
          if (j0 + static_cast<Idx>(d) * groups < walk)
            in[d].store(out + off[d], keep, mode, c);
      }
    } else {
      for (Idx w0 = g; w0 < walk; w0 += kDepth * groups) {
        Piece<T, kVec ? kChunk : 1> in[kDepth];
        Idx off[kDepth];
        uint32_t flag[kDepth];
#pragma unroll
        for (int d = 0; d < kDepth; ++d) {
          const Idx w = w0 + static_cast<Idx>(d) * groups;
          flag[d] = 2;                   // no step
          if (w < walk) {
            const Idx e = divide(w, p.steps, p.smagic, p.sshift);
            if (e < static_cast<Idx>(live)) {
              off[d] = kept_offset(m0 + e, p) + bcast_offset(w - e * steps, p);
              flag[d] = (keep >> e) & 1u;
              in[d].load(x + off[d]);
            }
          }
        }
#pragma unroll
        for (int d = 0; d < kDepth; ++d)
          if (flag[d] != 2)
            in[d].store(out + off[d], flag[d] ? 0xFFu : 0u, mode, c);
      }
    }
  }
}

// Dropout over a full mask: the direct walk, item ch the 8 values (and
// mask elements) from 8 * ch, one 16-byte body (two in f32) and one byte
// of saved bits; the last, partial item runs one element at a time.
template <typename T, typename Idx, bool kFromBits>
__global__ void __launch_bounds__(kThreads)
dropout_full_kernel(uint32_t k0, uint32_t k1, const void* __restrict__ xv,
                    void* __restrict__ outv,
                    const uint8_t* __restrict__ bits_in,
                    uint8_t* __restrict__ bits_out, Idx n, int mode, float c,
                    uint32_t thresh) {
  using Raw = typename Elem<T>::Raw;
  const Raw* __restrict__ x = static_cast<const Raw*>(xv);
  Raw* __restrict__ out = static_cast<Raw*>(outv);
  const Idx items = (n + kChunk - 1) / kChunk;
  const Idx stride = static_cast<Idx>(gridDim.x) * kThreads;
  for (Idx ch = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x;
       ch < items; ch += stride) {
    const Idx i0 = ch * kChunk;
    const int live = n - i0 < static_cast<Idx>(kChunk)
                         ? static_cast<int>(n - i0) : kChunk;
    uint32_t keep;
    if (kFromBits) {
      keep = bits_in[ch];
    } else {
      keep = 0;
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        keep |= static_cast<uint32_t>(tf::keep_bits(
                    tf::bits_at(k0, k1, i0 + static_cast<Idx>(e)), thresh))
                << e;
      keep &= (1u << live) - 1u;
      if (bits_out != nullptr) bits_out[ch] = static_cast<uint8_t>(keep);
    }
    if (live == kChunk) {
      Piece<T, kChunk> in;
      in.load(x + i0);
      in.store(out + i0, keep, mode, c);
    } else {
      for (int e = 0; e < live; ++e) {
        Piece<T, 1> in;
        in.load(x + i0 + e);
        in.store(out + i0 + e, keep >> e, mode, c);
      }
    }
  }
}


// XLA's ErfInv32 (xla/hlo/builder/lib/math.cc), the constants as the
// host's f64 values rounded to f32 (ops/kernels/threefry_fill.py rounds
// the same doubles)
__device__ __forceinline__ float erf_inv_f32(float x) {
  const float lt[9] = {
      static_cast<float>(2.81022636e-08), static_cast<float>(3.43273939e-07),
      static_cast<float>(-3.5233877e-06), static_cast<float>(-4.39150654e-06),
      static_cast<float>(0.00021858087), static_cast<float>(-0.00125372503),
      static_cast<float>(-0.00417768164), static_cast<float>(0.246640727),
      static_cast<float>(1.50140941)};
  const float gt[9] = {
      static_cast<float>(-0.000200214257), static_cast<float>(0.000100950558),
      static_cast<float>(0.00134934322), static_cast<float>(-0.00367342844),
      static_cast<float>(0.00573950773), static_cast<float>(-0.0076224613),
      static_cast<float>(0.00943887047), static_cast<float>(1.00167406),
      static_cast<float>(2.83297682)};
  // w = -log1p(-x * x), the log1p in f64 rounded once (prng.log1p_rn)
  float w = -__double2float_rn(
      log1p(-static_cast<double>(__fmul_rn(x, x))));
  const bool small = w < 5.0f;
  w = small ? __fsub_rn(w, 2.5f)
            : __fsub_rn(__double2float_rn(__dsqrt_rn(
                            static_cast<double>(w))), 3.0f);
  float p = small ? lt[0] : gt[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, w, small ? lt[i] : gt[i]);
  return fabsf(x) == 1.0f ? __fmul_rn(x, 3.40282346638528859812e+38f)
                          : __fmul_rn(p, x);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The draw's parameters, computed on the host in the output's type
// (threefry_fill.py: _fill_params): the uniform's minval (a Gumbel
// draw's too) and scale (maxval - minval), the clip bounds of a
// truncated normal, sqrt(2), and the keep test's threshold.
struct FillParams {
  float lo, scale, clip_lo, clip_hi, sqrt2;
  uint32_t thresh;
};

// jax.random.uniform(minval, maxval) of one 32-bit draw, as an f32
// holding the output type's value: f32, max(lo, fma(u, scale, lo)); bf16
// (jax's 16-bit rule), u from the draw's low byte shifted right by one
// (7 mantissa bits, exact), then the product and the sum each rounded
// to bf16
template <int kOut>
__device__ __forceinline__ float uniform_of(uint32_t b, const FillParams& q) {
  if (kOut == kOutF32)
    return fmaxf(q.lo, __fmaf_rn(tf::unit_f32(b), q.scale, q.lo));
  const float u = __fsub_rn(
      __uint_as_float((((b & 0xFFu) >> 1) | 0x3F80u) << 16), 1.0f);
  return fmaxf(q.lo, round_bf16(__fadd_rn(round_bf16(__fmul_rn(u, q.scale)),
                                          q.lo)));
}

template <int kOut>
__device__ __forceinline__ float sqrt2_erf_inv(float u, const FillParams& q) {
  if (kOut == kOutF32) return __fmul_rn(q.sqrt2, erf_inv_f32(u));
  return round_bf16(__fmul_rn(q.sqrt2, round_bf16(erf_inv_f32(u))));
}

template <int kMode, int kOut>
__device__ __forceinline__ float draw_of(uint32_t b, const FillParams& q) {
  const float u = uniform_of<kOut>(b, q);
  if (kMode == kUniform) return u;
  const float n = sqrt2_erf_inv<kOut>(u, q);
  if (kMode == kNormal) return n;
  return fminf(fmaxf(n, q.clip_lo), q.clip_hi);
}

// The draw's element: kKeep a uint8 flag, a bf16 draw 16 bits, else 32
template <int kMode, int kOut>
struct Out {
  using Raw = uint32_t;
};
template <>
struct Out<kKeep, kOutF32> {
  using Raw = uint8_t;
};
template <int kMode>
struct Out<kMode, kOutBF16> {
  using Raw = unsigned short;
};

// element i of a draw from its 32-bit draw b: kKeep keep_bits(b,
// thresh), kGumbel the f32 noise -log(-log(uniform(lo, 1))), kBits b,
// else draw_of's value in the output type
template <int kMode, int kOut>
__device__ __forceinline__ typename Out<kMode, kOut>::Raw value_of(
    uint32_t b, const FillParams& q) {
  if constexpr (kMode == kKeep) {
    return tf::keep_bits(b, q.thresh) ? 1 : 0;
  } else if constexpr (kMode == kGumbel) {
    return __float_as_uint(tf::gumbel_f32(b, q.lo));
  } else if constexpr (kMode == kBits) {
    return b;
  } else if constexpr (kOut == kOutF32) {
    return __float_as_uint(draw_of<kMode, kOut>(b, q));
  } else {
    return static_cast<unsigned short>(
        __float_as_uint(draw_of<kMode, kOut>(b, q)) >> 16);
  }
}

// A draw of n elements of kMode: an item is one 16-byte store (16 keep
// flags, 8 bf16 values or 4 of 32 bits), packed into words in element
// order; the last, partial item stores one element at a time.
template <int kMode, int kOut, typename Idx>
__global__ void __launch_bounds__(kThreads)
fill_kernel(uint32_t k0, uint32_t k1, void* __restrict__ out, Idx n,
            const FillParams q) {
  using Raw = typename Out<kMode, kOut>::Raw;
  constexpr int kPerWord = 4 / static_cast<int>(sizeof(Raw));
  constexpr int kPer = 4 * kPerWord;
  const Idx items = (n + kPer - 1) / kPer;
  const Idx stride = static_cast<Idx>(gridDim.x) * kThreads;
  for (Idx t = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x;
       t < items; t += stride) {
    const Idx i0 = t * kPer;
    if (i0 + kPer <= n) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = 0;
#pragma unroll
        for (int e = 0; e < kPerWord; ++e)
          w[j] |= static_cast<uint32_t>(value_of<kMode, kOut>(
                      tf::bits_at(k0, k1,
                                  i0 + static_cast<Idx>(kPerWord * j + e)),
                      q))
                  << (8 * sizeof(Raw) * e);
      }
      reinterpret_cast<uint4*>(out)[t] = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (Idx i = i0; i < n; ++i)
        static_cast<Raw*>(out)[i] =
            value_of<kMode, kOut>(tf::bits_at(k0, k1, i), q);
    }
  }
}

int blocks_for(unsigned long long items) {
  const unsigned long long b = (items + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

template <int kMode, int kOut>
int fill_as(uint32_t k0, uint32_t k1, void* out, unsigned long long n,
            const FillParams& q, cudaStream_t st) {
  constexpr int kPer = 16 / static_cast<int>(
                               sizeof(typename Out<kMode, kOut>::Raw));
  const int blocks = blocks_for((n + kPer - 1) / kPer);
  if (n < (1ull << 32)) {
    fill_kernel<kMode, kOut, uint32_t><<<blocks, kThreads, 0, st>>>(
        k0, k1, out, static_cast<uint32_t>(n), q);
  } else {
    fill_kernel<kMode, kOut, unsigned long long>
        <<<blocks, kThreads, 0, st>>>(k0, k1, out, n, q);
  }
  return cudaGetLastError();
}

template <int kOut>
int fill_value(int mode, uint32_t k0, uint32_t k1, void* out,
               unsigned long long n, const FillParams& q, cudaStream_t st) {
  switch (mode) {
    case kUniform: return fill_as<kUniform, kOut>(k0, k1, out, n, q, st);
    case kNormal: return fill_as<kNormal, kOut>(k0, k1, out, n, q, st);
    default: return fill_as<kTruncated, kOut>(k0, k1, out, n, q, st);
  }
}

template <typename T, bool kFromBits>
void dropout_as(int route, uint32_t k0, uint32_t k1, const void* x,
                void* out, const uint8_t* bits_in, uint8_t* bits_out,
                const Plan& p, int mode, float c, uint32_t thresh,
                cudaStream_t st) {
  const int blocks = blocks_for(p.chunks * p.groups);
  if (route == kVector && p.nb == 0) {        // a full mask: direct walk
    dropout_full_kernel<T, uint32_t, kFromBits><<<blocks, kThreads, 0, st>>>(
        k0, k1, x, out, bits_in, bits_out, static_cast<uint32_t>(p.m), mode,
        c, thresh);
  } else if (route == kVector) {
    dropout_kernel<T, uint32_t, true, kFromBits><<<blocks, kThreads, 0, st>>>(
        k0, k1, x, out, bits_in, bits_out, p, mode, c, thresh);
  } else if (route == kScalar) {
    dropout_kernel<T, uint32_t, false, kFromBits>
        <<<blocks, kThreads, 0, st>>>(k0, k1, x, out, bits_in, bits_out, p,
                                      mode, c, thresh);
  } else {
    dropout_kernel<T, unsigned long long, false, kFromBits>
        <<<blocks, kThreads, 0, st>>>(k0, k1, x, out, bits_in, bits_out, p,
                                      mode, c, thresh);
  }
}

template <typename T>
void dropout_dispatch(int route, uint32_t k0, uint32_t k1, const void* x,
                      void* out, const uint8_t* bits_in, uint8_t* bits_out,
                      const Plan& p, int mode, float c, uint32_t thresh,
                      cudaStream_t st) {
  if (bits_in != nullptr) {
    dropout_as<T, true>(route, k0, k1, x, out, bits_in, nullptr, p, mode, c,
                        thresh, st);
  } else {
    dropout_as<T, false>(route, k0, k1, x, out, nullptr, bits_out, p, mode,
                         c, thresh, st);
  }
}

}  // namespace

// out[i] for i < n of a draw under (k0, k1) by mode: 0 the uint8 keep
// flag uniform < p, given as thresh = ceil(f32(p) * 2^23) clamped to [0,
// 2^23]; 1 the f32 Gumbel noise -log(-log(uniform(lo, 1))); 2 the uint32
// bits; 3 uniform, 4 normal, 5 truncated normal, in out_dtype 0 f32 or 1
// bf16 (modes 0-2 take 0), with the parameters lo (the uniform's minval),
// scale (maxval - minval), clip_lo, clip_hi and sqrt2, each a value of
// out_dtype (threefry_fill.py: _fill_params). out is 16-byte aligned.
extern "C" int tf_fill_launch(uint32_t k0, uint32_t k1, int mode,
                              int out_dtype, void* out, long long n,
                              float lo, float scale, float clip_lo,
                              float clip_hi, float sqrt2, uint32_t thresh,
                              void* stream) {
  if (n < 0 || mode < kKeep || mode > kTruncated || out_dtype < kOutF32 ||
      out_dtype > kOutBF16 || (mode < kUniform && out_dtype != kOutF32) ||
      thresh > (1u << 23))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (out == nullptr || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned long long un = static_cast<unsigned long long>(n);
  const FillParams q{lo, scale, clip_lo, clip_hi, sqrt2, thresh};
  switch (mode) {
    case kKeep: return fill_as<kKeep, kOutF32>(k0, k1, out, un, q, st);
    case kGumbel: return fill_as<kGumbel, kOutF32>(k0, k1, out, un, q, st);
    case kBits: return fill_as<kBits, kOutF32>(k0, k1, out, un, q, st);
    default:
      return out_dtype == kOutF32
                 ? fill_value<kOutF32>(mode, k0, k1, out, un, q, st)
                 : fill_value<kOutBF16>(mode, k0, k1, out, un, q, st);
  }
}

// Dropout of x (dtype 0 f32, 1 bf16, 2 f16) into out on route 0 vector, 1
// scalar, 2 wide, over the plan packed as int64 words (dropout_plan in
// ops/kernels/threefry_fill.py): nk, nb, group_fast, inner_kept, m,
// chunks, groups, steps, walk, gmagic, gshift, smagic, sshift, then (len,
// vstride, magic, shift)
// for each kept run and each broadcast run, innermost first. mode 0
// where(keep, x / c, 0) (the forward: no bits_in), 1 where(keep, x, 0),
// 2 where(keep, x, 0) / c (the vjp: bits_in given). keep is
// keep_bits(bits of the mask element, thresh), or, when bits_in is given,
// bit (i % 8) of bits_in[i / 8] for mask element i; bits_out (may be
// null) receives the drawn bits, ceil(m / 8) bytes.
extern "C" int tf_dropout_launch(uint32_t k0, uint32_t k1, int dtype,
                                 const void* x, void* out,
                                 const void* bits_in, void* bits_out,
                                 int route, const long long* words,
                                 int mode, float c, uint32_t thresh,
                                 void* stream) {
  if (mode < kScale || mode > kScaleGrad || route < kVector ||
      route > kWide || thresh > (1u << 23) || words == nullptr ||
      (mode == kScale && bits_in != nullptr) ||
      (mode == kScaleGrad && bits_in == nullptr))
    return cudaErrorInvalidValue;
  Plan p{};
  p.nk = static_cast<int>(words[0]);
  p.nb = static_cast<int>(words[1]);
  p.group_fast = static_cast<int>(words[2]);
  p.inner_kept = static_cast<int>(words[3]);
  p.m = static_cast<unsigned long long>(words[4]);
  p.chunks = static_cast<unsigned long long>(words[5]);
  p.groups = static_cast<unsigned long long>(words[6]);
  p.steps = static_cast<unsigned long long>(words[7]);
  p.walk = static_cast<unsigned long long>(words[8]);
  p.gmagic = static_cast<uint32_t>(words[9]);
  p.gshift = static_cast<uint32_t>(words[10]);
  p.smagic = static_cast<uint32_t>(words[11]);
  p.sshift = static_cast<uint32_t>(words[12]);
  if (p.nk < 1 || p.nk > kMaxRuns || p.nb < 0 || p.nb > kMaxRuns ||
      p.groups < 1 || p.steps < 1 || p.groups > p.walk ||
      (p.walk != p.steps && p.walk != kChunk * p.steps) ||
      p.chunks != (p.m + kChunk - 1) / kChunk)
    return cudaErrorInvalidValue;
  const long long* w = words + 13;
  for (int r = 0; r < p.nk + p.nb; ++r, w += 4) {
    Run& run = r < p.nk ? p.k[r] : p.b[r - p.nk];
    if (w[0] < 1) return cudaErrorInvalidValue;
    run = Run{static_cast<unsigned long long>(w[0]),
              static_cast<unsigned long long>(w[1]),
              static_cast<uint32_t>(w[2]), static_cast<uint32_t>(w[3])};
  }
  if (p.m == 0) return cudaSuccess;
  if (x == nullptr || out == nullptr) return cudaErrorInvalidValue;
  if (route != kWide && (p.chunks * p.groups >= (1ull << 32) ||
                         (kDepth + 1) * p.walk >= (1ull << 32)))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* bi = static_cast<const uint8_t*>(bits_in);
  uint8_t* bo = static_cast<uint8_t*>(bits_out);
  switch (dtype) {
    case kF32:
      dropout_dispatch<float>(route, k0, k1, x, out, bi, bo, p, mode, c,
                              thresh, st);
      break;
    case kBF16:
      dropout_dispatch<__nv_bfloat16>(route, k0, k1, x, out, bi, bo, p, mode,
                                      c, thresh, st);
      break;
    case kF16:
      dropout_dispatch<__half>(route, k0, k1, x, out, bi, bo, p, mode, c,
                               thresh, st);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
