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
// What bounds it on an H100: per step and path 12 integer hashes (a key and an
// index hash per stream), five polynomial logs, one cos polynomial and one
// sqrt, all in registers; 24 bytes of state in and out per path for the whole
// horizon.  It is bound by integer throughput, not by memory.
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

__global__ void __launch_bounds__(256)
hawkes_mc_kernel(const float* __restrict__ x0, const float* __restrict__ lp0,
                 const float* __restrict__ lm0, float* __restrict__ x_out,
                 float* __restrict__ lp_out, float* __restrict__ lm_out,
                 long long nb_path, uint32_t seed, int nb_steps, HawkesArgs a) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= nb_path) return;
  const svt::PathCounter pc = svt::path_counter(seed, p);
  float log_c[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) log_c[k] = a.log_c[k];
  const float drift_dt = (a.mu - 0.5f * a.sigma * a.sigma) * a.dt;
  const float neg_mean_m = -a.mean_m;

  float x = x0[p];
  float lam_p = lp0[p];
  float lam_m = lm0[p];
  for (int step = 0; step < nb_steps; ++step) {
    const float u1 = svt::stream_uniform(pc, step, 0);
    const float u2 = svt::stream_uniform(pc, step, 1);
    const float z = sqrtf(fmaxf(-2.0f * svt::poly_log(u1, log_c), 0.0f)) * svt::poly_cospi(u2);
    const float e_up = -svt::poly_log(svt::stream_uniform(pc, step, 2), log_c);
    const float e_um = -svt::poly_log(svt::stream_uniform(pc, step, 3), log_c);
    const float e_jp = -svt::poly_log(svt::stream_uniform(pc, step, 4), log_c);
    const float e_jm = -svt::poly_log(svt::stream_uniform(pc, step, 5), log_c);

    const float j_p = a.shift_p + e_jp * a.mean_p;
    const float j_m = a.shift_m - e_jm * neg_mean_m;
    const float diffusion = drift_dt - a.comp_p_dt * lam_p - a.comp_m_dt * lam_m +
                            a.sigma * (z * a.sdt);
    const float jump_p = lam_p > e_up * a.inv_dt ? j_p : 0.0f;
    const float jump_m = lam_m > e_um * a.inv_dt ? j_m : 0.0f;
    x = x + diffusion + jump_p + jump_m;
    const float load_p = a.beta1_p * jump_p + a.beta2_p * jump_m;
    const float load_m = a.beta1_m * jump_p + a.beta2_m * jump_m;
    lam_p = lam_p + a.kappa_p * (a.theta_p - lam_p) * a.dt + load_p;
    lam_m = lam_m + a.kappa_m * (a.theta_m - lam_m) * a.dt + load_m;
  }
  x_out[p] = x;
  lp_out[p] = lam_p;
  lm_out[p] = lam_m;
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
  const int threads = 256;
  const long long blocks = (nb_path + threads - 1) / threads;
  hawkes_mc_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      x0, lp0, lm0, x_out, lp_out, lm_out, nb_path, seed, nb_steps, a);
  return static_cast<int>(cudaGetLastError());
}
