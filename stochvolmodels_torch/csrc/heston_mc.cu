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
// What bounds it on an H100: instruction issue.  Per step and path the work
// is two hashes, two polynomials and three square roots, all in registers,
// with 24 bytes of state in and out per path for the whole horizon; the time
// is the SASS instructions each warp issues per step.  The design issues
// fewer:
//   * per-block keys: the keys of streams 0 and 1 depend only on the TPU
//     program, which holds 128 whole blocks of 256 threads; the block keeps
//     them in a shared-memory ring (KeyRing: 128 steps x 2 keys, one barrier
//     per 128 steps) and each thread hashes only its own index;
//   * the step loop unrolled by 2 (kStepsPerPass) with an odd last step: the
//     ring's refill test runs once per two steps;
//   * the update as multiply-adds (__fmaf_rn), with kappa dt hoisted.  The
//     square roots stay IEEE (the TPU kernel's jnp.sqrt is exact), and the
//     normals are drawn without contraction, bit for bit the TPU stream's.
//     The kernel therefore differs from its plain version
//     (simulate_heston_terminal_torch, one rounding per operation) by the
//     update's roundings, held to 1e-4 in x and to 1e-4 |plain| + 1e-4 in v
//     and qvar, path by path.
//
// Built by stochvolmodels_torch/ops/_build.py with nvcc for sm_90a and
// -fmad=false: the compiler contracts nothing, so the FMAs are the explicit
// ones above.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "counter_rng.cuh"

namespace {

constexpr int kThreads = 256;
static_assert(svt::kProgramPaths % kThreads == 0, "a block must lie in one TPU program");
using Keys = svt::KeyRing<kThreads, 2>;  // streams 0 and 1
// model steps in one pass of the step loop (scripts/sass_step_loops.py reads it)
constexpr int kStepsPerPass = 2;
static_assert(Keys::kChunk % kStepsPerPass == 0, "a refill step must begin a pass");

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

struct State {
  float x, var, qvar;
};

// step `step` of one path, its normals from the keys in the ring
__device__ __forceinline__ void draw_and_step(const uint32_t* ring, int step, uint32_t idx,
                                              const float* log_c, const HestonArgs& a,
                                              float rho_1, float kdt, State& s) {
  const uint2 k = *reinterpret_cast<const uint2*>(Keys::row(ring, step));
  float z0, z1;
  svt::normal_pair_from_keys(idx, k.x, k.y, log_c, z0, z1);
  const float w0 = z0 * a.sdt;
  const float w1 = z1 * a.sdt;
  const float sigma = sqrtf(s.var);
  const float var_dt = s.var * a.dt;
  s.x = __fmaf_rn(sigma, w0, __fmaf_rn(-0.5f, var_dt, s.x));
  s.qvar = s.qvar + var_dt;
  const float var = __fmaf_rn(sigma * a.volvol, __fmaf_rn(a.rho, w0, rho_1 * w1),
                              __fmaf_rn(kdt, a.theta - s.var, s.var));
  s.var = svt::max_keep_nan(var, 1e-4f);
}

__global__ void __launch_bounds__(kThreads)
heston_mc_kernel(const float* __restrict__ x0, const float* __restrict__ var0,
                 const float* __restrict__ qv0, float* __restrict__ x_out,
                 float* __restrict__ var_out, float* __restrict__ qv_out,
                 long long nb_path, uint32_t seed, int nb_steps, HestonArgs a) {
  __shared__ __align__(8) uint32_t ring[Keys::kWords];
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // threads past the end fill keys and meet every barrier, but load and store no state
  const bool live = p < nb_path;
  const uint32_t idx = static_cast<uint32_t>(p & (svt::kProgramPaths - 1));
  const uint32_t seed_term =
      svt::program_seed_term(seed, blockIdx.x / (svt::kProgramPaths / kThreads));
  const float rho_1 = sqrtf(1.0f - a.rho * a.rho);
  const float kdt = a.kappa * a.dt;
  float log_c[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) log_c[k] = a.log_c[k];

  State s{0.0f, 1.0f, 0.0f};
  if (live) s = State{x0[p], var0[p], qv0[p]};
  int step = 0;
#pragma unroll 1
  for (; step + kStepsPerPass <= nb_steps; step += kStepsPerPass) {
    if ((step & (Keys::kChunk - 1)) == 0) Keys::fill(ring, seed_term, step);
#pragma unroll
    for (int j = 0; j < kStepsPerPass; ++j)
      draw_and_step(ring, step + j, idx, log_c, a, rho_1, kdt, s);
  }
#pragma unroll 1
  for (; step < nb_steps; ++step) {  // the steps after the last whole pass
    if ((step & (Keys::kChunk - 1)) == 0) Keys::fill(ring, seed_term, step);
    draw_and_step(ring, step, idx, log_c, a, rho_1, kdt, s);
  }
  if (live) {
    x_out[p] = s.x;
    var_out[p] = s.var;
    qv_out[p] = s.qvar;
  }
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
  const unsigned int blocks = static_cast<unsigned int>((nb_path + kThreads - 1) / kThreads);
  heston_mc_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x0, var0, qv0, x_out, var_out, qv_out, nb_path, seed, nb_steps, a);
  return static_cast<int>(cudaGetLastError());
}
