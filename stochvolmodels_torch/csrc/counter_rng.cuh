// Device helpers shared by the Monte-Carlo kernels: the counter-hash random
// stream of the TPU kernels' interpret mode and its sign-bit Box-Muller.
//
// Counterpart of `_hash_u32`, `_counter_bits`, `_uniform_from_bits`,
// `_poly_log`, `_poly_cospi` and `_box_muller(poly_bm=True)` of
// stochvolmodels_tpu/ops/pallas_mc.py.  The plain PyTorch versions of the
// same functions are in stochvolmodels_torch/ops/cuda_mc.py.
//
// Path p of a launch draws what the TPU kernel draws for program
// `seed + (p >> 15)` at in-block index `p & 32767` (one (256 x 128)-path
// block per TPU program), whatever the CUDA launch geometry.  Step `step`
// draws from streams 0 and 1 (the normals), and the Hawkes kernel also from
// streams 2-5, with the step index as its salt.  Every kernel draws these
// bits through per-block keys (`stream_key`, `bits_from_key`, `KeyRing`).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace svt {

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u);
  return fmaxf(f - 1.0f, 1.1754944e-38f);  // keep log(u) finite
}

// ln(u) for u in (0, 1): exponent extraction and a degree-6 polynomial in the
// mantissa; `c` holds the 7 coefficients, highest degree first
__device__ __forceinline__ float poly_log(float u, const float* c) {
  const int bits = __float_as_int(u);
  const int e = (bits >> 23) - 127;
  const float f = __int_as_float((bits & 0x007FFFFF) | 0x3F800000) - 1.0f;
  float p = c[0];
#pragma unroll
  for (int k = 1; k < 7; ++k) p = p * f + c[k];
  return static_cast<float>(e) * 0.6931471805599453f + f * p;
}

// cos(pi u) for u in [0, 1) via the odd sin minimax on [-pi/2, pi/2)
__device__ __forceinline__ float poly_cospi(float u) {
  const float x = (2.0f * u - 1.0f) * 1.5707963267948966f;
  const float x2 = x * x;
  const float s = x * (1.0f + x2 * (-0.16666658f + x2 * (0.008332824f + x2 * (
      -0.00019810997f + x2 * 2.7525562e-06f))));
  return -s;
}

// The stream of the TPU kernels' interpret mode is
//   hash(idx ^ hash(seed_term + step * 0x7FEB352D + stream * 0x846CA68B)),
// seed_term = (seed + program) * 0x9E3779B9.  The key of (step, stream), the
// inner hash, depends only on the TPU program (p >> 15), so a CUDA block
// whose paths lie in one program computes each key once, keeps it in shared
// memory, and every thread then hashes only its own index.

constexpr int kProgramPaths = 1 << 15;  // paths per TPU program

// (seed + program) * 0x9E3779B9: the seed term of TPU program `program`
__device__ __forceinline__ uint32_t program_seed_term(uint32_t seed, uint32_t program) {
  return (seed + program) * 0x9E3779B9u;
}

// the key of stream `stream` at step `step`; the path's bits are
// bits_from_key(idx, stream_key(seed_term, step, stream))
__device__ __forceinline__ uint32_t stream_key(uint32_t seed_term, int step, uint32_t stream) {
  return hash_u32(seed_term + static_cast<uint32_t>(step) * 0x7FEB352Du + stream * 0x846CA68Bu);
}

__device__ __forceinline__ uint32_t bits_from_key(uint32_t idx, uint32_t key) {
  return hash_u32(idx ^ key);
}

// the two standard normals of a step, r cos and the sign-bit r sin, from the
// keys of streams 0 and 1
__device__ __forceinline__ void normal_pair_from_keys(uint32_t idx, uint32_t key0, uint32_t key1,
                                                      const float* log_c, float& z0, float& z1) {
  const uint32_t b1 = bits_from_key(idx, key0);
  const uint32_t b2 = bits_from_key(idx, key1);
  const float r = sqrtf(fmaxf(-2.0f * poly_log(uniform_from_bits(b1), log_c), 0.0f));
  const float c = poly_cospi(uniform_from_bits(b2));
  const float sign = (b2 & 1u) == 0u ? 1.0f : -1.0f;
  const float s = sign * sqrtf(fmaxf(1.0f - c * c, 0.0f));
  z0 = r * c;
  z1 = r * s;
}

// A ring of per-step keys in shared memory for a block of kThreads threads
// that lies in one TPU program: row `step % (2 kChunk)` holds the keys of
// streams 0..kSlots-1 at `step`, kChunk = kThreads / kSlots.  At every step
// that is a multiple of kChunk the block fills the next kChunk rows, one key
// per thread, and meets at one barrier.  The two halves of the ring
// alternate, so a half is refilled only after every thread has passed the
// barrier that follows its last read of it.  Every thread of the block must
// call this at the same steps.
template <int kThreads, int kSlots>
struct KeyRing {
  static constexpr int kChunk = kThreads / kSlots;
  static constexpr int kWords = 2 * kChunk * kSlots;
  static_assert(kChunk * kSlots == kThreads && (kChunk & (kChunk - 1)) == 0,
                "kSlots must divide the block into a power-of-two number of steps");

  __device__ __forceinline__ static void fill(uint32_t* ring, uint32_t seed_term, int step0) {
    const int step = step0 + static_cast<int>(threadIdx.x) / kSlots;
    const uint32_t stream = threadIdx.x % kSlots;
    ring[(step & (2 * kChunk - 1)) * kSlots + stream] = stream_key(seed_term, step, stream);
    __syncthreads();
  }

  // the keys of `step`; fill(ring, seed_term, step & -kChunk) ran before
  __device__ __forceinline__ static const uint32_t* row(const uint32_t* ring, int step) {
    return ring + (step & (2 * kChunk - 1)) * kSlots;
  }
};

// 1/x by the hardware's approximation, rcp.approx.ftz (one MUFU instruction,
// ~2^-23 relative error), as the TPU kernels take pl.reciprocal(approx=True);
// the division stands in for it in a build for the CPU
__device__ __forceinline__ float rcp_approx(float x) {
#ifdef __CUDA_ARCH__
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
#else
  return 1.0f / x;
#endif
}

// max(x, lo) that keeps a NaN x, as jnp.maximum and torch.clamp do
__device__ __forceinline__ float max_keep_nan(float x, float lo) {
  return (x >= lo || isnan(x)) ? x : lo;
}

}  // namespace svt
