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
// The step every variant changes is the one logsv_mc runs (its design, as
// redesigned for this card), at the study's backbone eta = 1 and spot
// measure, so that poly-bm is logsv_mc's step:
//   * the TPU kernel's hardware PRNG becomes the counter-hash stream of
//     counter_rng.cuh at salt = step index, and its keys come from a ring in
//     shared memory (KeyRing: streams 0 and 1, 128 steps x 2 keys; one-prng
//     stream 0 alone, 256 steps x 1 key; no-prng none), one barrier per
//     refill, so each thread hashes only its own index;
//   * 1/sigma in the drift is the hardware's approximate reciprocal
//     (svt::rcp_approx), the counterpart of the TPU kernel's
//     pl.reciprocal(sigma, approx=True);
//   * the Euler update is written in multiply-adds (__fmaf_rn) with
//     kappa1 theta and kappa1 + vartheta^2 / 2 hoisted; the draws and the
//     polynomials stay uncontracted, so the random stream is bit for bit the
//     TPU stream;
//   * sigma'^2 dt of a step's qvar update is the next step's sigma^2 dt, the
//     same operations in the same order (the variants without qvar compute
//     it all the same: x needs it);
//   * the step loop runs kStepsPerPass steps a pass with one refill test,
//     the odd last step after the last pass, and reads the keys of a pass in
//     one shared-memory load (16 bytes for two streams, 8 for one).
// Two pieces differ from the TPU kernel on purpose:
//   * the polynomial-ln radius is sqrt(max(-2 ln u, 0)), as the production
//     Box-Muller takes it: the TPU kernel leaves out the max, and the
//     polynomial ln is positive (up to 7.7e-7) on 7 of the 2^23 uniforms, so
//     about one draw in 1.2 million would make a NaN path;
//   * no-exp takes 1/sigma by IEEE division: its sigma = |1 + ln sigma| comes
//     near 0 on many paths, where the drift k1 theta / sigma multiplies a
//     last-bit difference of ln sigma by k1 theta dt / sigma^2, so the
//     approximate reciprocal's last bits would reach 1e-2 of the output
//     within 91 steps, and no plain version could hold it to 1e-4.  The
//     plain version rounds no-exp's multiply-adds once, as the kernel does.
//
// What bounds it on an H100: instruction issue.  Per step and path the work
// is two key hashes, the Box-Muller transcendentals and the update, all in
// registers; the memory traffic is 8 bytes per path (x0 in, the sum out)
// for hundreds of steps.  `template <int VARIANT>` gives each variant its
// own code, which holds only that variant's work.
//
// Built by stochvolmodels_torch/ops/_build.py with nvcc for sm_90a and
// -fmad=false into a shared library with the plain C entry point
// `logsv_variants_launch`: the compiler contracts nothing, so the FMAs are
// the explicit ones above.  The kernel differs from its plain version
// (stochvolmodels_torch/ops/mc_variants.py, one rounding per operation and an
// exact 1/sigma) by the update's roundings, held to 1e-4 max(|plain|, 1).

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

constexpr int kThreads = 256;
static_assert(svt::kProgramPaths % kThreads == 0, "a block must lie in one TPU program");
// model steps in one pass of the step loop (scripts/sass_step_loops.py reads it)
constexpr int kStepsPerPass = 2;

constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr float HALF_PI_F = 1.57079632679489661923f;
constexpr float SQRT6_F = 2.44948974278317809820f;
constexpr float TWO_M16 = 1.52587890625e-05f;  // 2^-16

// the streams a variant draws a step: 0 and 1, 0 alone, or none
__host__ __device__ constexpr int key_slots(int v) {
  return v == NO_PRNG ? 0 : v == ONE_PRNG ? 1 : 2;
}
template <int V>
using Keys = svt::KeyRing<kThreads, key_slots(V) == 0 ? 1 : key_slots(V)>;
static_assert(svt::KeyRing<kThreads, 1>::kChunk % kStepsPerPass == 0 &&
                  svt::KeyRing<kThreads, 2>::kChunk % kStepsPerPass == 0,
              "a refill step must begin a pass");
static_assert(svt::KeyRing<kThreads, 1>::kWords == svt::KeyRing<kThreads, 2>::kWords,
              "one ring size for every variant");

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
__host__ __device__ constexpr bool abs_sigma(int v) {
  return v == NO_EXP || v == ALU_FLOOR || v == NO_PRNG;
}
__host__ __device__ constexpr bool poly_exp(int v) { return v == POLY_EXP || v == POLY_ALL; }

// exp(x) for |x| <~ 1: degree-6 Taylor-like polynomial (`_poly_exp_small`)
__device__ __forceinline__ float poly_exp_small(float x) {
  return 1.0f + x * (1.0f + x * (0.5f + x * (0.16666667f + x * (
      0.041666666f + x * (0.008333452f + x * 0.0013908f)))));
}

// the keys of one step: stream 0 and, for two-stream variants, stream 1
struct StepKeys {
  uint32_t k0, k1;
};

template <int V>
__device__ __forceinline__ StepKeys step_keys(const uint32_t* ring, int step) {
  if constexpr (key_slots(V) == 2) {
    const uint2 k = *reinterpret_cast<const uint2*>(Keys<V>::row(ring, step));
    return {k.x, k.y};
  } else if constexpr (key_slots(V) == 1) {
    return {*Keys<V>::row(ring, step), 0u};
  } else {
    return {0u, 0u};
  }
}

// the keys of the pass that begins at the even step `step`: its rows are
// adjacent and start on a multiple of 16 (two streams) or 8 bytes (one)
template <int V>
__device__ __forceinline__ void pass_keys(const uint32_t* ring, int step,
                                          StepKeys (&k)[kStepsPerPass]) {
  static_assert(kStepsPerPass == 2, "one load holds the keys of two steps");
  if constexpr (key_slots(V) == 2) {
    const uint4 q = *reinterpret_cast<const uint4*>(Keys<V>::row(ring, step));
    k[0] = {q.x, q.y};
    k[1] = {q.z, q.w};
  } else if constexpr (key_slots(V) == 1) {
    const uint2 q = *reinterpret_cast<const uint2*>(Keys<V>::row(ring, step));
    k[0] = {q.x, 0u};
    k[1] = {q.y, 0u};
  } else {
    k[0] = k[1] = {0u, 0u};
  }
}

// the two draws of a step (`_normals` and the draws of `_kernel`)
template <int V>
__device__ __forceinline__ void draws(uint32_t idx, StepKeys keys, const float* log_c, float x,
                                      float& z0, float& z1) {
  if constexpr (production_normals(V)) {
    svt::normal_pair_from_keys(idx, keys.k0, keys.k1, log_c, z0, z1);
  } else if constexpr (V == NO_PRNG) {
    z0 = x * 1e-6f + 0.01f;
    z1 = z0 * 0.5f;
  } else if constexpr (V == ONE_PRNG) {
    const uint32_t b = svt::bits_from_key(idx, keys.k0);
    const float u1 = (static_cast<float>(static_cast<int>(b >> 16)) + 0.5f) * TWO_M16;
    const float u2 = (static_cast<float>(static_cast<int>(b & 0xFFFFu)) + 0.5f) * TWO_M16;
    const float r = sqrtf(-2.0f * logf(u1));
    const float c = cosf(PI_F * u2);
    const float sign = (b & 0x10000u) == 0u ? 1.0f : -1.0f;
    z0 = r * c;
    z1 = sign * r * sqrtf(fmaxf(1.0f - c * c, 0.0f));
  } else {
    const uint32_t b1 = svt::bits_from_key(idx, keys.k0);
    const uint32_t b2 = svt::bits_from_key(idx, keys.k1);
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

struct State {
  float x, lns, sigma, qvar;
  float sig2dt;  // (sigma sigma) dt of the current sigma
};

// the Euler step's loop invariants
struct Euler {
  float dt, sdt, k1theta, k1_vt2, kappa2, theta, beta, volvol;

  __device__ __forceinline__ explicit Euler(const VariantArgs& a)
      : dt(a.dt), sdt(a.sdt), k1theta(a.k1theta), k1_vt2(a.kappa1 + a.half_vt2),
        kappa2(a.kappa2), theta(a.theta), beta(a.beta), volvol(a.volvol) {}

  // one Euler step of the state, as `_kernel.body`: the drift of ln sigma is
  // k1 theta / sigma - k1 + k2 (theta - sigma) - vartheta^2 / 2
  template <int V>
  __device__ __forceinline__ void step(float z0, float z1, State& s) const {
    const float w0 = z0 * sdt;
    const float w1 = z1 * sdt;
    s.x = __fmaf_rn(s.sigma, w0, __fmaf_rn(-0.5f, s.sig2dt, s.x));
    const float inv = V == NO_EXP ? 1.0f / s.sigma : svt::rcp_approx(s.sigma);
    const float drift = __fmaf_rn(kappa2, theta - s.sigma, __fmaf_rn(k1theta, inv, -k1_vt2));
    float sigma;
    if constexpr (has_lns(V) && !poly_exp(V)) {
      s.lns = __fmaf_rn(volvol, w1, __fmaf_rn(beta, w0, __fmaf_rn(drift, dt, s.lns)));
      sigma = abs_sigma(V) ? fabsf(1.0f + s.lns) : expf(s.lns);
    } else {  // sigma from its own increment; ln sigma is not needed
      const float dln = __fmaf_rn(volvol, w1, __fmaf_rn(beta, w0, drift * dt));
      sigma = s.sigma * (poly_exp(V) ? poly_exp_small(dln) : expf(dln));
    }
    const float sig2dt = sigma * sigma * dt;
    if constexpr (has_qvar(V)) s.qvar = __fmaf_rn(0.5f, s.sig2dt + sig2dt, s.qvar);
    s.sig2dt = sig2dt;
    s.sigma = sigma;
  }
};

template <int V>
__device__ __forceinline__ void draw_and_step(uint32_t idx, StepKeys keys, const float* log_c,
                                              const Euler& e, State& s) {
  float z0, z1;
  draws<V>(idx, keys, log_c, s.x, z0, z1);
  e.step<V>(z0, z1, s);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
logsv_variant_kernel(const float* __restrict__ x0, float* __restrict__ out, long long nb_path,
                     uint32_t seed, int nb_steps, VariantArgs a) {
  __shared__ __align__(16) uint32_t ring[Keys<V>::kWords];
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // threads past the end fill keys and meet every barrier, but load and store nothing
  const bool live = p < nb_path;
  const uint32_t idx = static_cast<uint32_t>(p & (svt::kProgramPaths - 1));
  const uint32_t seed_term =
      svt::program_seed_term(seed, blockIdx.x / (svt::kProgramPaths / kThreads));
  const Euler e(a);
  float log_c[7];  // fully unrolled: lives in registers
#pragma unroll
  for (int k = 0; k < 7; ++k) log_c[k] = a.log_c[k];

  State s{live ? x0[p] : 0.0f, a.lns0, a.sigma0, 0.0f, a.sigma0 * a.sigma0 * a.dt};
  int step = 0;
#pragma unroll 1
  for (; step + kStepsPerPass <= nb_steps; step += kStepsPerPass) {
    if constexpr (key_slots(V) > 0) {
      if ((step & (Keys<V>::kChunk - 1)) == 0) Keys<V>::fill(ring, seed_term, step);
    }
    StepKeys keys[kStepsPerPass];
    pass_keys<V>(ring, step, keys);
#pragma unroll
    for (int j = 0; j < kStepsPerPass; ++j) draw_and_step<V>(idx, keys[j], log_c, e, s);
  }
#pragma unroll 1
  for (; step < nb_steps; ++step) {  // the steps after the last whole pass
    if constexpr (key_slots(V) > 0) {
      if ((step & (Keys<V>::kChunk - 1)) == 0) Keys<V>::fill(ring, seed_term, step);
    }
    draw_and_step<V>(idx, step_keys<V>(ring, step), log_c, e, s);
  }
  if (live) out[p] = s.x + s.sigma + s.qvar;
}

int launch_variant(int variant, unsigned int blocks, cudaStream_t stream, const float* x0,
                   float* out, long long nb_path, uint32_t seed, int nb_steps,
                   const VariantArgs& a) {
#define SVT_VARIANT_CASE(V)                                                                  \
  case V:                                                                                    \
    logsv_variant_kernel<V><<<blocks, kThreads, 0, stream>>>(x0, out, nb_path, seed, nb_steps, \
                                                             a);                             \
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

// Launches variant `variant` (0 .. 13, the order of the enum above) on
// `stream`; `unroll` must be kStepsPerPass (2, the TPU study's unroll) and
// `threads` 256 (a block lies in one TPU program); `host_args` points to 18
// floats laid out as VariantArgs.  Returns the cudaError_t of the launch (0
// on success), cudaErrorInvalidValue for a variant, unroll or block size it
// does not take.
extern "C" int logsv_variants_launch(const float* x0, float* out, long long nb_path,
                                     uint32_t seed, int nb_steps, int variant, int unroll,
                                     int threads, const float* host_args, void* stream) {
  if (threads != kThreads || unroll != kStepsPerPass || nb_steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  VariantArgs a;
  std::memcpy(&a, host_args, sizeof(a));
  const auto blocks = static_cast<unsigned int>((nb_path + kThreads - 1) / kThreads);
  return launch_variant(variant, blocks, static_cast<cudaStream_t>(stream), x0, out, nb_path,
                        seed, nb_steps, a);
}
