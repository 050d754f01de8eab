// Hawkes jump-diffusion Monte Carlo: Euler with intensity thinning on
// (x, lambda+, lambda-), one thread per path.
//
// Replaces the TPU kernel `_hawkes_kernel` of stochvolmodels_tpu/ops/pallas_mc.py
// (with `_run_hawkes_kernel` and `simulate_hawkesjd_terminal_pallas`).  It
// computes what that kernel computes in its counter-hash mode:
//   * the random stream of counter_rng.cuh: program seed `seed + (p >> 15)`,
//     in-block counter `p & 32767`, salt = step index, six streams per step;
//   * streams 0 and 1 make one normal, sqrt(max(-2 ln u1, 0)) cos(pi u2), with
//     no second (sign-bit) normal; streams 2-5 make the exponentials -ln u of
//     the two thinning tests and the two jump sizes;
//   * per step, in this order: jump sizes shift_p + e mean_p and
//     shift_m - e (-mean_m); the diffusion
//     drift_dt - comp_p_dt lambda+ - comp_m_dt lambda- + sigma (z sdt); a jump
//     fires where lambda > e * inv_dt; x takes the diffusion and the jumps;
//     each lambda mean-reverts and takes its cross-excitation loads.
//
// Thinning is a discontinuity: one rounding flip in `lambda > e * inv_dt`
// moves x by a whole jump and lambda by up to beta * jump.  So the kernel keeps
// the TPU kernel's operation order term by term, and its plain version
// (simulate_hawkesjd_terminal_torch) equals it bit for bit.  inv_dt is the
// float32 rounding of 1/dt taken in float64, not a float32 reciprocal of dt.
//
// What bounds it on an H100: instruction issue.  The state is 24 bytes per
// path for the whole horizon and every step runs in registers, so the time
// is the SASS instructions each warp issues per step (an SM issues four
// warp-instructions a clock), many of them the integer hashes.  The design
// issues fewer:
//   * per-block keys: the key of (step, stream) depends only on the TPU
//     program, which holds 128 whole blocks of 256 threads.  The block keeps
//     a ring of keys in shared memory (KeyRing: 32 steps x 8 slots, streams
//     0-5, one key per thread and one barrier per 32 steps); a thread reads
//     its step's keys as broadcast loads and hashes only its own index;
//   * lazy jump sizes: streams 4 and 5 are drawn only where the jump fires
//     (0.5% and 0.6% of path-steps at the BTC defaults, so the branch runs
//     in 14% and 18% of warp-steps);
//   * a proven pre-test: -poly_log(u) >= (1 - u) - 9.54e-7 for every uniform
//     the stream can draw, so lambda < ((1 - u) - kPreC) * inv_dt * (1 -
//     kPreMargin) proves that no jump fires without the logarithm
//     (tests/test_torch_mc_redesign.py checks it over all 2^23 uniforms).
//     Where it fails, NaN lambda included, the exact test runs as written.
// Both skips leave every result as the full step computes it, bit for bit.
//
// Built by stochvolmodels_torch/ops/_build.py with nvcc for sm_90a and
// -fmad=false, so every operation rounds once in the order written.  No fast
// math: lambda can grow large under cross-excitation and the comparisons need
// IEEE semantics.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "counter_rng.cuh"

namespace {

constexpr int kThreads = 256;
static_assert(svt::kProgramPaths % kThreads == 0, "a block must lie in one TPU program");
using Keys = svt::KeyRing<kThreads, 8>;  // streams 0-5; slots 6 and 7 unused

// the pre-test's constants, mirrored by PRETEST_C and PRETEST_MARGIN in
// stochvolmodels_torch/ops/cuda_mc.py
constexpr float kPreC = 2e-6f;
constexpr float kPreMargin = 1e-6f;

struct HawkesArgs {
  // the TPU kernel's 16 parameters, each rounded once from float64
  float mu, sigma, shift_p, mean_p, shift_m, mean_m;
  float theta_p, kappa_p, beta1_p, beta2_p;
  float theta_m, kappa_m, beta1_m, beta2_m;
  float comp_p_dt, comp_m_dt;  // compensators times dt, taken in float64
  float dt;                    // f32(dt)
  float sdt;                   // f32(sqrt(dt)), sqrt taken in f64
  float inv_dt;                // f32(1/dt), reciprocal taken in f64
  float log_c[7];              // ln(1+f)/f polynomial, highest degree first
};
static_assert(sizeof(HawkesArgs) == 26 * sizeof(float), "HawkesArgs layout");

// whether `lam > -ln(u) * inv_dt` fires, the logarithm taken only where the
// pre-test cannot rule the jump out
__device__ __forceinline__ bool fires(float lam, float u, float pre_scale, float inv_dt,
                                      const float* log_c) {
  if (lam < ((1.0f - u) - kPreC) * pre_scale) return false;
  return lam > -svt::poly_log(u, log_c) * inv_dt;
}

__global__ void __launch_bounds__(kThreads)
hawkes_mc_kernel(const float* __restrict__ x0, const float* __restrict__ lp0,
                 const float* __restrict__ lm0, float* __restrict__ x_out,
                 float* __restrict__ lp_out, float* __restrict__ lm_out,
                 long long nb_path, uint32_t seed, int nb_steps, HawkesArgs a) {
  __shared__ __align__(16) uint32_t ring[Keys::kWords];
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // threads past the end fill keys and meet every barrier; they touch no state
  const bool active = p < nb_path;
  const uint32_t idx = static_cast<uint32_t>(p & (svt::kProgramPaths - 1));
  const uint32_t seed_term =
      svt::program_seed_term(seed, blockIdx.x / (svt::kProgramPaths / kThreads));
  float log_c[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) log_c[k] = a.log_c[k];
  const float drift_dt = (a.mu - 0.5f * a.sigma * a.sigma) * a.dt;
  const float neg_mean_m = -a.mean_m;
  const float pre_scale = a.inv_dt * (1.0f - kPreMargin);

  float x = active ? x0[p] : 0.0f;
  float lam_p = active ? lp0[p] : 0.0f;
  float lam_m = active ? lm0[p] : 0.0f;
#pragma unroll 1
  for (int step = 0; step < nb_steps; ++step) {
    if ((step & (Keys::kChunk - 1)) == 0) Keys::fill(ring, seed_term, step);
    const uint32_t* keys = Keys::row(ring, step);
    const uint4 k = *reinterpret_cast<const uint4*>(keys);
    const float u1 = svt::uniform_from_bits(svt::bits_from_key(idx, k.x));
    const float u2 = svt::uniform_from_bits(svt::bits_from_key(idx, k.y));
    const float z = sqrtf(fmaxf(-2.0f * svt::poly_log(u1, log_c), 0.0f)) * svt::poly_cospi(u2);
    const float u_up = svt::uniform_from_bits(svt::bits_from_key(idx, k.z));
    const float u_um = svt::uniform_from_bits(svt::bits_from_key(idx, k.w));

    const float diffusion = drift_dt - a.comp_p_dt * lam_p - a.comp_m_dt * lam_m +
                            a.sigma * (z * a.sdt);
    float jump_p = 0.0f;
    if (fires(lam_p, u_up, pre_scale, a.inv_dt, log_c)) {
      const float e_jp =
          -svt::poly_log(svt::uniform_from_bits(svt::bits_from_key(idx, keys[4])), log_c);
      jump_p = a.shift_p + e_jp * a.mean_p;
    }
    float jump_m = 0.0f;
    if (fires(lam_m, u_um, pre_scale, a.inv_dt, log_c)) {
      const float e_jm =
          -svt::poly_log(svt::uniform_from_bits(svt::bits_from_key(idx, keys[5])), log_c);
      jump_m = a.shift_m - e_jm * neg_mean_m;
    }
    x = x + diffusion + jump_p + jump_m;
    const float load_p = a.beta1_p * jump_p + a.beta2_p * jump_m;
    const float load_m = a.beta1_m * jump_p + a.beta2_m * jump_m;
    lam_p = lam_p + a.kappa_p * (a.theta_p - lam_p) * a.dt + load_p;
    lam_m = lam_m + a.kappa_m * (a.theta_m - lam_m) * a.dt + load_m;
  }
  if (active) {
    x_out[p] = x;
    lp_out[p] = lam_p;
    lm_out[p] = lam_m;
  }
}

}  // namespace

// Launches on `stream`; `host_args` points to 26 floats laid out as HawkesArgs.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int hawkes_mc_launch(const float* x0, const float* lp0, const float* lm0,
                                float* x_out, float* lp_out, float* lm_out,
                                long long nb_path, uint32_t seed, int nb_steps,
                                const float* host_args, void* stream) {
  HawkesArgs a;
  std::memcpy(&a, host_args, sizeof(a));
  const long long blocks = (nb_path + kThreads - 1) / kThreads;
  hawkes_mc_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      x0, lp0, lm0, x_out, lp_out, lm_out, nb_path, seed, nb_steps, a);
  return static_cast<int>(cudaGetLastError());
}
