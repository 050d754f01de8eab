// Heston Monte Carlo: full-truncation Euler on (X, V, I), one thread per path.
//
// Replaces the TPU kernel `_heston_kernel` of stochvolmodels_tpu/ops/pallas_mc.py
// (with `_run_heston_kernel_32` and `simulate_heston_terminal_pallas`).  It
// computes what that kernel computes in its counter-hash mode:
//   * the random stream of counter_rng.cuh: program seed `seed + (p >> 15)`,
//     in-block counter `p & 32767`, salt = step index (the TPU kernel has no
//     2-step unroll but salts by the step index as well), streams 0 and 1;
//   * rho_1 = sqrt(1 - rho^2) in float32 inside the kernel, as the TPU
//     kernel takes it from its float32 parameters;
//   * per step, in this order: sigma = sqrt(v), x += -v dt / 2 + sigma w0,
//     I += v dt, v += kappa (theta - v) dt + sigma volvol (rho w0 + rho_1 w1),
//     v = max(v, 1e-4).
//
// What bounds it on an H100: per step and path ~4 integer hashes, two
// polynomials and three square roots, all in registers; 24 bytes of state
// in and out per path for the whole horizon.  It is bound by integer and
// special-function throughput, not by memory; the design keeps the state in
// registers and the step loop inside the thread.
//
// Built by stochvolmodels_torch/ops/_build.py with nvcc for sm_90a and
// -fmad=false, so every operation rounds once in the order written, as the
// plain version (simulate_heston_terminal_torch) does.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "counter_rng.cuh"

namespace {

struct HestonArgs {
  float dt;      // f32(dt)
  float sdt;     // f32(sqrt(dt)) with the sqrt taken in f64
  float theta;
  float kappa;
  float rho;
  float volvol;
  float log_c[7];  // ln(1+f)/f polynomial, highest degree first
};
static_assert(sizeof(HestonArgs) == 13 * sizeof(float), "HestonArgs layout");

__global__ void __launch_bounds__(256)
heston_mc_kernel(const float* __restrict__ x0, const float* __restrict__ var0,
                 const float* __restrict__ qv0, float* __restrict__ x_out,
                 float* __restrict__ var_out, float* __restrict__ qv_out,
                 long long nb_path, uint32_t seed, int nb_steps, HestonArgs a) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= nb_path) return;
  const svt::PathCounter pc = svt::path_counter(seed, p);
  const float rho_1 = sqrtf(1.0f - a.rho * a.rho);
  float log_c[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) log_c[k] = a.log_c[k];

  float x = x0[p];
  float var = var0[p];
  float qvar = qv0[p];
  for (int step = 0; step < nb_steps; ++step) {
    float z0, z1;
    svt::normal_pair(pc, step, log_c, z0, z1);
    const float w0 = z0 * a.sdt;
    const float w1 = z1 * a.sdt;
    const float sigma = sqrtf(var);
    const float var_dt = var * a.dt;
    x = x - 0.5f * var_dt + sigma * w0;
    qvar = qvar + var_dt;
    var = var + a.kappa * (a.theta - var) * a.dt
          + sigma * a.volvol * (a.rho * w0 + rho_1 * w1);
    var = svt::max_keep_nan(var, 1e-4f);
  }
  x_out[p] = x;
  var_out[p] = var;
  qv_out[p] = qvar;
}

}  // namespace

// Launches on `stream`; `host_args` points to 13 floats laid out as HestonArgs.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int heston_mc_launch(const float* x0, const float* var0, const float* qv0,
                                float* x_out, float* var_out, float* qv_out,
                                long long nb_path, uint32_t seed, int nb_steps,
                                const float* host_args, void* stream) {
  HestonArgs a;
  std::memcpy(&a, host_args, sizeof(a));
  const int threads = 256;
  const long long blocks = (nb_path + threads - 1) / threads;
  heston_mc_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      x0, var0, qv0, x_out, var_out, qv_out, nb_path, seed, nb_steps, a);
  return static_cast<int>(cudaGetLastError());
}
