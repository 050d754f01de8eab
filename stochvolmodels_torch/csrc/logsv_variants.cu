// LogSV Euler-step variants: the variant study of the LogSV path loop, one
// thread per path.
//
// Replaces the TPU kernel `_kernel` of scripts/bench_pallas_variants.py (with
// `_normals`, `_poly_exp_small` and `_run`).  Each variant changes one piece
// of the production step (csrc/logsv_mc.cu) so that its time says what that
// piece costs: library vs polynomial transcendentals, no exp, no normals, no
// random bits, fewer state registers.  The fixed parameters (theta 1.04,
// kappa1 3.18, kappa2 3.06, beta 0.15, volvol 1.85), the start (lns0 =
// log 0.84, sigma0 = 0.84, qvar0 = 0) and the output x + sigma + qvar are the
// TPU kernel's; they arrive from the host already rounded to float32.
//
//   full-fast           library ln and cos(pi u) Box-Muller, sign-bit sine
//   full-sincos         classic Box-Muller: library ln, cos and sin of 2 pi u
//   no-normals          sqrt(6) (u1 + u2 - 1), sqrt(6) (u2 - u1): not normal
//   no-exp              full-fast normals, sigma = |1 + ln sigma| (no exp)
//   alu-floor           u - 1/2 draws and |1 + ln sigma|: no transcendental
//   poly-bm             the production step: polynomial ln and cos(pi u)
//   poly-bm2            poly-bm with the second normal by an even cos minimax
//   poly-exp            full-fast normals, sigma *= degree-6 exp(d ln sigma)
//   poly-all            poly-bm normals and the polynomial exp
//   sigma-carry         poly-bm with sigma *= exp(d ln sigma), no ln sigma
//   no-qvar             poly-bm without the integrated variance
//   sigma-carry-noqvar  both: the state is (x, sigma)
//   one-prng            one 32-bit draw split into two 16-bit uniforms
//   no-prng             deterministic draws z0 = 1e-6 x + 0.01, z1 = z0 / 2
//
// Two pieces of the TPU kernel have no counterpart on the card:
//   * its hardware PRNG becomes the counter-hash stream of counter_rng.cuh,
//     the stream logsv_mc draws: streams 0 and 1 at salt = step index, and
//     stream 0 alone for one-prng;
//   * pl.reciprocal(approx=True) becomes the exact 1.0f / sigma of logsv_mc.
// Two pieces differ from the TPU kernel on purpose:
//   * the polynomial-ln radius is sqrt(max(-2 ln u, 0)), as the production
//     Box-Muller takes it: the TPU kernel leaves out the max, and the
//     polynomial ln is positive (up to 7.7e-7) on 7 of the 2^23 uniforms, so
//     about one draw in 1.2 million would make a NaN path;
//   * the loop runs all nb_steps steps, UNROLL at a time and the remainder one
//     at a time; the TPU kernel's fori_loop runs nb_steps // unroll * unroll
//     (the same at the study's 360 steps and unroll 2).
//
// What bounds it on an H100: per step and path up to four 32-bit integer
// hashes, the Box-Muller transcendentals and one division, all in registers;
// the memory traffic is 8 bytes per path (x0 in, the sum out) for hundreds
// of steps, so every variant is bound by its operations, not by bandwidth.
// `template <int VARIANT, int UNROLL>` gives each variant its own code, which
// holds only that variant's work, and the step loop inside the thread keeps
// the state in registers.
//
// Built by stochvolmodels_torch/ops/_build.py with nvcc for sm_90a and
// -fmad=false into a shared library with the plain C entry point
// `logsv_variants_launch`: every operation rounds once, in the order written,
// as in the plain version (stochvolmodels_torch/ops/mc_variants.py), which
// calls the same CUDA expf, logf, cosf, sinf, sqrtf and IEEE division.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "counter_rng.cuh"

namespace {

// the order of VARIANTS in stochvolmodels_torch/ops/mc_variants.py
enum Variant : int {
  FULL_FAST = 0,
  FULL_SINCOS,
  NO_NORMALS,
  NO_EXP,
  ALU_FLOOR,
  POLY_BM,
  POLY_BM2,
  POLY_EXP,
  POLY_ALL,
  SIGMA_CARRY,
  NO_QVAR,
  SIGMA_CARRY_NOQVAR,
  ONE_PRNG,
  NO_PRNG,
  NB_VARIANTS
};

struct VariantArgs {
  float dt;        // f32(dt)
  float sdt;       // f32(sqrt(dt)) with the sqrt taken in f64
  float theta;
  float kappa1;
  float kappa2;
  float beta;
  float volvol;
  float k1theta;   // f32(kappa1 * theta)
  float half_vt2;  // f32(0.5 * f32(beta^2 + volvol^2))
  float lns0;      // f32(log(0.84)), taken in f64
  float sigma0;    // f32(0.84)
  float log_c[7];  // ln(1+f)/f polynomial, highest degree first
};
static_assert(sizeof(VariantArgs) == 18 * sizeof(float), "VariantArgs layout");

constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr float HALF_PI_F = 1.57079632679489661923f;
constexpr float SQRT6_F = 2.44948974278317809820f;
constexpr float TWO_M16 = 1.52587890625e-05f;  // 2^-16

__host__ __device__ constexpr bool has_lns(int v) {
  return v != SIGMA_CARRY && v != SIGMA_CARRY_NOQVAR;
}
__host__ __device__ constexpr bool has_qvar(int v) {
  return v != NO_QVAR && v != SIGMA_CARRY_NOQVAR;
}
__host__ __device__ constexpr bool production_normals(int v) {
  return v == POLY_BM || v == POLY_ALL || v == SIGMA_CARRY || v == NO_QVAR ||
         v == SIGMA_CARRY_NOQVAR;
}

// exp(x) for |x| <~ 1: degree-6 Taylor-like polynomial (`_poly_exp_small`)
__device__ __forceinline__ float poly_exp_small(float x) {
  return 1.0f + x * (1.0f + x * (0.5f + x * (0.16666667f + x * (
      0.041666666f + x * (0.008333452f + x * 0.0013908f)))));
}

// the two draws of step `step` (`_normals` and the draws of `_kernel`)
template <int V>
__device__ __forceinline__ void draws(const svt::PathCounter& pc, int step, const float* log_c,
                                      float x, float& z0, float& z1) {
  if constexpr (production_normals(V)) {
    svt::normal_pair(pc, step, log_c, z0, z1);
  } else if constexpr (V == NO_PRNG) {
    z0 = x * 1e-6f + 0.01f;
    z1 = z0 * 0.5f;
  } else if constexpr (V == ONE_PRNG) {
    const uint32_t b = svt::stream_bits(pc, step, 0);
    const float u1 = (static_cast<float>(static_cast<int>(b >> 16)) + 0.5f) * TWO_M16;
    const float u2 = (static_cast<float>(static_cast<int>(b & 0xFFFFu)) + 0.5f) * TWO_M16;
    const float r = sqrtf(-2.0f * logf(u1));
    const float c = cosf(PI_F * u2);
    const float sign = (b & 0x10000u) == 0u ? 1.0f : -1.0f;
    z0 = r * c;
    z1 = sign * r * sqrtf(fmaxf(1.0f - c * c, 0.0f));
  } else {
    const uint32_t b1 = svt::stream_bits(pc, step, 0);
    const uint32_t b2 = svt::stream_bits(pc, step, 1);
    const float u1 = svt::uniform_from_bits(b1);
    const float u2 = svt::uniform_from_bits(b2);
    const float sign = (b2 & 1u) == 0u ? 1.0f : -1.0f;
    if constexpr (V == ALU_FLOOR) {
      z0 = u1 - 0.5f;
      z1 = u2 - 0.5f;
    } else if constexpr (V == NO_NORMALS) {
      z0 = SQRT6_F * (u1 + u2 - 1.0f);
      z1 = SQRT6_F * (u2 - u1);
    } else if constexpr (V == POLY_BM2) {
      const float r = sqrtf(fmaxf(-2.0f * svt::poly_log(u1, log_c), 0.0f));
      const float t = (2.0f * u2 - 1.0f) * HALF_PI_F;
      const float t2 = t * t;
      const float sp = t * (1.0f + t2 * (-0.16666658f + t2 * (0.008332824f + t2 * (
          -0.00019810997f + t2 * 2.7525562e-06f))));
      const float cp = 0.99999999f + t2 * (-0.49999997f + t2 * (0.041666418f + t2 * (
          -0.0013888397f + t2 * 0.0000247609f)));
      z0 = r * (-sp);
      z1 = r * (sign * cp);
    } else {  // FULL_FAST, FULL_SINCOS, NO_EXP, POLY_EXP: library ln
      const float r = sqrtf(-2.0f * logf(u1));
      if constexpr (V == FULL_SINCOS) {
        const float t = TWO_PI_F * u2;
        z0 = r * cosf(t);
        z1 = r * sinf(t);
      } else {
        const float c = cosf(PI_F * u2);
        z0 = r * c;
        z1 = r * (sign * sqrtf(fmaxf(1.0f - c * c, 0.0f)));
      }
    }
  }
}

// one Euler step of the (x, ln sigma, sigma, qvar) state, as `_kernel.body`
template <int V>
__device__ __forceinline__ void euler_step(const svt::PathCounter& pc, int step,
                                           const VariantArgs& a, const float* log_c,
                                           float& x, float& lns, float& sigma, float& qvar) {
  float z0, z1;
  draws<V>(pc, step, log_c, x, z0, z1);
  const float w0 = z0 * a.sdt;
  const float w1 = z1 * a.sdt;
  const float sig2dt = sigma * sigma * a.dt;
  x = x - 0.5f * sig2dt + sigma * w0;
  const float dln = ((a.k1theta * (1.0f / sigma) - a.kappa1) + a.kappa2 * (a.theta - sigma)
                     - a.half_vt2) * a.dt + a.beta * w0 + a.volvol * w1;
  if constexpr (has_lns(V)) lns = lns + dln;
  float sigma_new;
  if constexpr (V == NO_EXP || V == ALU_FLOOR || V == NO_PRNG) {
    sigma_new = fabsf(1.0f + lns);
  } else if constexpr (V == POLY_EXP || V == POLY_ALL) {
    sigma_new = sigma * poly_exp_small(dln);
  } else if constexpr (!has_lns(V)) {
    sigma_new = sigma * expf(dln);
  } else {
    sigma_new = expf(lns);
  }
  if constexpr (has_qvar(V)) qvar = qvar + 0.5f * (sig2dt + sigma_new * sigma_new * a.dt);
  sigma = sigma_new;
}

template <int V, int UNROLL>
__global__ void logsv_variant_kernel(const float* __restrict__ x0, float* __restrict__ out,
                                     long long nb_path, uint32_t seed, int nb_steps,
                                     VariantArgs a) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= nb_path) return;
  const svt::PathCounter pc = svt::path_counter(seed, p);
  float log_c[7];  // fully unrolled: lives in registers
#pragma unroll
  for (int k = 0; k < 7; ++k) log_c[k] = a.log_c[k];

  float x = x0[p];
  float lns = a.lns0;
  float sigma = a.sigma0;
  float qvar = 0.0f;
  int step = 0;
  for (; step + UNROLL <= nb_steps; step += UNROLL) {
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) euler_step<V>(pc, step + k, a, log_c, x, lns, sigma, qvar);
  }
  for (; step < nb_steps; ++step) euler_step<V>(pc, step, a, log_c, x, lns, sigma, qvar);
  out[p] = x + sigma + qvar;
}

template <int UNROLL>
int launch_unrolled(int variant, unsigned int blocks, int threads, cudaStream_t stream,
                    const float* x0, float* out, long long nb_path, uint32_t seed,
                    int nb_steps, const VariantArgs& a) {
#define SVT_VARIANT_CASE(V)                                                        \
  case V:                                                                          \
    logsv_variant_kernel<V, UNROLL><<<blocks, threads, 0, stream>>>(x0, out, nb_path, \
                                                                    seed, nb_steps, a); \
    break;
  switch (variant) {
    SVT_VARIANT_CASE(FULL_FAST)
    SVT_VARIANT_CASE(FULL_SINCOS)
    SVT_VARIANT_CASE(NO_NORMALS)
    SVT_VARIANT_CASE(NO_EXP)
    SVT_VARIANT_CASE(ALU_FLOOR)
    SVT_VARIANT_CASE(POLY_BM)
    SVT_VARIANT_CASE(POLY_BM2)
    SVT_VARIANT_CASE(POLY_EXP)
    SVT_VARIANT_CASE(POLY_ALL)
    SVT_VARIANT_CASE(SIGMA_CARRY)
    SVT_VARIANT_CASE(NO_QVAR)
    SVT_VARIANT_CASE(SIGMA_CARRY_NOQVAR)
    SVT_VARIANT_CASE(ONE_PRNG)
    SVT_VARIANT_CASE(NO_PRNG)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SVT_VARIANT_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches variant `variant` (0 .. 13, the order of the enum above) with
// `threads` threads per block (a multiple of 32 up to 1024) and a step loop
// unrolled `unroll` times (2, the TPU study's unroll), on `stream`; `host_args` points to 18
// floats laid out as VariantArgs.  Returns the cudaError_t of the launch (0 on
// success), cudaErrorInvalidValue for a variant, unroll or block size it
// does not take.
extern "C" int logsv_variants_launch(const float* x0, float* out, long long nb_path,
                                     uint32_t seed, int nb_steps, int variant, int unroll,
                                     int threads, const float* host_args, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || nb_steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  VariantArgs a;
  std::memcpy(&a, host_args, sizeof(a));
  const long long blocks = (nb_path + threads - 1) / threads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b = static_cast<unsigned int>(blocks);
  switch (unroll) {
    case 2: return launch_unrolled<2>(variant, b, threads, s, x0, out, nb_path, seed, nb_steps, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
