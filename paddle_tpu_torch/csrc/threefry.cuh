// Threefry-2x32 and the bits-to-float steps of jax.random, for the port's
// random kernels (sample_rows.cu, threefry_fill.cu).
//
// The JAX package draws from jax.random at jax 0.9.0 with
// jax_threefry_partitionable=True: every draw is the Threefry-2x32 hash of
// a key over a counter, never a stateful generator. These helpers are
// jax/_src/prng.py's _threefry2x32_lowering and jax/_src/random.py's
// _uniform / _gumbel, word for word, and match the port's plain versions
// (paddle_tpu_torch/core/prng.py):
//
//   threefry2x32(k, x): 5 blocks of 4 rounds (x0 += x1; x1 = rotl(x1, r)
//     ^ x0) with rotations 13 15 26 6 / 17 29 16 24, the key injected
//     after each block from (k0, k1, k0 ^ k1 ^ 0x1BD11BDA) plus the block
//     number;
//   bits of element i of a draw: b.x ^ b.y of the hash over (hi(i), lo(i));
//   split / fold_in: the hash over (0, i);
//   unit float: (bits >> 9 | 1.0f's bits) - 1, exact in [0, 1);
//   uniform(lo, 1): max(lo, fma(u, 1 - lo, lo)) — XLA fuses the scale
//     and shift into one multiply-add, so this does too, on purpose;
//   gumbel: -log(-log(uniform(tiny, 1))) with each log taken in f64 and
//     rounded to f32 (logf misses by up to an ulp; the plain version takes
//     the same f64 log, so the card's noise is bitwise its own).
//
// Every float operation is an __*_rn intrinsic: nvcc contracts nothing
// else, and the library is built without --use_fast_math.
//
// What the hash costs on Hopper: one bits_at on a 32-bit counter needs at
// least 68 integer instructions, 41 that only the integer ALU runs (20
// funnel-shift rotates, 21 xors) and 27 adds that the ALU (IADD3) or the
// FMA pipe (IMAD) can take (chip_smoke.py's NEED). The compiled hash is
// ~49 ALU instructions and ~25 IMAD / VIADD (sm_90a SASS, counted by
// chip_smoke.py's rng phase). An SM runs 64 ALU lanes a clock, so a whole
// card does ~400 hashes a ns at best. gumbel_f32's two f64 logs add 64
// FP64 instructions on the 64 FP64 lanes. The kernels built on these are
// bound by those pipes and by issue slots, not by their bytes.
#pragma once

#include <cstdint>

namespace tf {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr float kTinyF32 = 1.17549435082228750797e-38f;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void rounds4(uint32_t& x0, uint32_t& x1, int r0,
                                        int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

// Threefry-2x32 of the counter (x0, x1) under the key (k0, k1)
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0; x1 += k1;
  rounds4(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  rounds4(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  rounds4(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  rounds4(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  rounds4(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// the 32 random bits of element i (its flat index) of a draw under key k
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1,
                                            unsigned long long i) {
  const uint2 b = threefry2x32(k0, k1, static_cast<uint32_t>(i >> 32),
                               static_cast<uint32_t>(i));
  return b.x ^ b.y;
}

// the same for i < 2^32: the counter's high word is 0, so its first key
// add folds into the schedule (one add fewer an element)
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1,
                                            uint32_t i) {
  const uint2 b = threefry2x32(k0, k1, 0u, i);
  return b.x ^ b.y;
}

// bernoulli's keep flag unit_f32(bits) < p on the bits alone: unit_f32
// is m * 2^-23 for m = bits >> 9, so it is below f32 p exactly when m <
// ceil(p * 2^23) = thresh (computed on the host, clamped to [0, 2^23])
__device__ __forceinline__ bool keep_bits(uint32_t bits, uint32_t thresh) {
  return (bits >> 9) < thresh;
}

// f32 in [0, 1) from 32 random bits: exact
__device__ __forceinline__ float unit_f32(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// jax.random.uniform(minval=lo, maxval=1) from 32 random bits: the scale
// 1 - lo in f32, as jax takes maxval - minval in the draw's type
__device__ __forceinline__ float uniform_f32(uint32_t bits, float lo) {
  return fmaxf(lo, __fmaf_rn(unit_f32(bits), __fsub_rn(1.0f, lo), lo));
}

// log rounded once to f32: taken in f64
__device__ __forceinline__ float log_rn(float x) {
  return __double2float_rn(log(static_cast<double>(x)));
}

// -log(-log(u)) of jax.random.uniform(minval=lo, maxval=1):
// jax.random.gumbel (mode "low") at lo = tiny (1 - tiny rounds to 1),
// gumbel_softmax's noise at lo = 1e-10
__device__ __forceinline__ float gumbel_f32(uint32_t bits, float lo) {
  return -log_rn(-log_rn(uniform_f32(bits, lo)));
}

}  // namespace tf
