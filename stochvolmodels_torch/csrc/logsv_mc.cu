// LogSV Monte Carlo: full-horizon explicit Euler on (X, ln sigma, I), one
// thread per path.
//
// Replaces the TPU kernel `_logsv_kernel` of stochvolmodels_tpu/ops/pallas_mc.py
// (with `_run_logsv_kernel_32` and `simulate_logsv_terminal_pallas`).  It
// computes what that kernel computes in its counter-hash mode, bit for bit in
// the random stream:
//   * path p takes the TPU program seed `seed + (p >> 15)` and the in-block
//     counter `p & 32767`, which reproduces the (256 x 128)-path block layout
//     of `_counter_bits` whatever the CUDA launch geometry;
//   * the step salt is the step index 0 .. nb_steps-1; streams 0 and 1 feed
//     the two uniforms of each step;
//   * murmur3 finalizer bits -> mantissa-bitcast uniforms -> polynomial ln
//     (coefficients passed in from the Python side, where numpy fits them
//     exactly as the JAX package does) and polynomial cos(pi u) -> sign-bit
//     Box-Muller, all in counter_rng.cuh;
//   * the drift of ln sigma takes the hardware's approximate 1/sigma
//     (rcp.approx, one MUFU instruction), as the TPU kernel takes
//     pl.reciprocal(sigma, approx=True): ~2^-23 relative error on a term of
//     order dt.
//
// What bounds it on an H100: instruction issue.  Per step and path the work
// is two hashes, two polynomials, two sqrt, one exp and one division, all in
// registers, with 24 bytes of state in and out per path for the whole
// horizon; the time is the SASS instructions each warp issues per step.  The
// design issues fewer:
//   * per-block keys: the keys of streams 0 and 1 depend only on the TPU
//     program, which holds 128 whole blocks of 256 threads; the block keeps
//     them in a shared-memory ring (KeyRing: 128 steps x 2 keys, one barrier
//     per 128 steps) and each thread hashes only its own index;
//   * the carried sigma^2 dt: the second term of a step's qvar update,
//     (eta^2 dt sigma') sigma', is the next step's sigma^2 dt, the same
//     operations in the same order;
//   * the step loop unrolled by 2 (kStepsPerPass), as the TPU kernel unrolls
//     it, with an odd last step: the ring's refill test runs once per two
//     steps;
//   * the Euler update as multiply-adds (__fmaf_rn), with eta^2 dt and
//     kappa1 + vartheta^2 / 2 hoisted, and the approximate reciprocal above.
//     One step serves both measures: under the spot measure adj = 0, and
//     fma(0, sigma, drift) is drift wherever sigma is finite.
//     The normals are drawn without contraction, bit for bit the TPU
//     stream's.  The kernel therefore differs from its plain version
//     (simulate_logsv_terminal_torch, one rounding per operation and an exact
//     1/sigma) by the update's roundings, held to 1e-4 in x and to
//     1e-4 |plain| + 1e-4 in sigma and qvar, path by path.
//
// Built by stochvolmodels_torch/ops/_build.py with nvcc for sm_90a into a
// shared library with the plain C entry point `logsv_mc_launch`, with
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

struct LogSvArgs {
  float dt;      // f32(dt)
  float sdt;     // f32(sqrt(dt)) with the sqrt taken in f64
  float alpha;   // -1 spot measure, +1 inverse measure
  float theta;
  float kappa1;
  float kappa2;
  float beta;
  float volvol;
  float eta;     // vol backbone eta
  float adj;     // beta * eta under the inverse measure, else 0
  float log_c[7];  // ln(1+f)/f polynomial, highest degree first
};
static_assert(sizeof(LogSvArgs) == 17 * sizeof(float), "LogSvArgs layout");

// 1/x by the hardware's approximation (the stand-in for the CPU divides)
__device__ __forceinline__ float rcp_approx(float x) {
#ifdef __CUDA_ARCH__
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
#else
  return 1.0f / x;
#endif
}

struct State {
  float x, lns, qvar, sigma;
  float sig2dt;  // (eta^2 dt sigma) sigma of the current sigma
};

// the Euler step's loop invariants
struct Euler {
  float dt, sdt, eta, eta2dt, alpha_half, k1theta, k1_vt2, kappa2, theta, adj, beta, volvol;

  __device__ __forceinline__ explicit Euler(const LogSvArgs& a)
      : dt(a.dt), sdt(a.sdt), eta(a.eta), eta2dt(a.eta * a.eta * a.dt),
        alpha_half(a.alpha * 0.5f), k1theta(a.kappa1 * a.theta),
        k1_vt2(a.kappa1 + 0.5f * (a.beta * a.beta + a.volvol * a.volvol)), kappa2(a.kappa2),
        theta(a.theta), adj(a.adj), beta(a.beta), volvol(a.volvol) {}

  // the drift of ln sigma, k1 theta / sigma - k1 + k2 (theta - sigma) + adj sigma
  // - vartheta^2 / 2, and the Euler update
  __device__ __forceinline__ void step(float z0, float z1, State& s) const {
    const float w0 = z0 * sdt;
    const float w1 = z1 * sdt;
    s.x = __fmaf_rn(eta * s.sigma, w0, __fmaf_rn(alpha_half, s.sig2dt, s.x));
    const float drift = __fmaf_rn(
        adj, s.sigma,
        __fmaf_rn(kappa2, theta - s.sigma, __fmaf_rn(k1theta, rcp_approx(s.sigma), -k1_vt2)));
    s.lns = __fmaf_rn(volvol, w1, __fmaf_rn(beta, w0, __fmaf_rn(drift, dt, s.lns)));
    s.sigma = expf(s.lns);
    const float sig2dt = eta2dt * s.sigma * s.sigma;
    s.qvar = __fmaf_rn(0.5f, s.sig2dt + sig2dt, s.qvar);
    s.sig2dt = sig2dt;
  }
};

// step `step` of one path, its normals from the keys in the ring
__device__ __forceinline__ void draw_and_step(const uint32_t* ring, int step, uint32_t idx,
                                              const float* log_c, const Euler& e, State& s) {
  const uint2 k = *reinterpret_cast<const uint2*>(Keys::row(ring, step));
  float z0, z1;
  svt::normal_pair_from_keys(idx, k.x, k.y, log_c, z0, z1);
  e.step(z0, z1, s);
}

__global__ void __launch_bounds__(kThreads)
logsv_mc_kernel(const float* __restrict__ x0, const float* __restrict__ lns0,
                const float* __restrict__ qv0, float* __restrict__ x_out,
                float* __restrict__ sig_out, float* __restrict__ qv_out,
                long long nb_path, uint32_t seed, int nb_steps, LogSvArgs a) {
  __shared__ __align__(8) uint32_t ring[Keys::kWords];
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // threads past the end fill keys and meet every barrier, but load and store no state
  const bool live = p < nb_path;
  const uint32_t idx = static_cast<uint32_t>(p & (svt::kProgramPaths - 1));
  const uint32_t seed_term =
      svt::program_seed_term(seed, blockIdx.x / (svt::kProgramPaths / kThreads));
  const Euler e(a);
  float log_c[7];  // fully unrolled below: lives in registers
#pragma unroll
  for (int k = 0; k < 7; ++k) log_c[k] = a.log_c[k];

  State s{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (live) {
    s.x = x0[p];
    s.lns = lns0[p];
    s.qvar = qv0[p];
  }
  s.sigma = expf(s.lns);
  s.sig2dt = e.eta2dt * s.sigma * s.sigma;

  int step = 0;
#pragma unroll 1
  for (; step + kStepsPerPass <= nb_steps; step += kStepsPerPass) {
    if ((step & (Keys::kChunk - 1)) == 0) Keys::fill(ring, seed_term, step);
#pragma unroll
    for (int j = 0; j < kStepsPerPass; ++j) draw_and_step(ring, step + j, idx, log_c, e, s);
  }
#pragma unroll 1
  for (; step < nb_steps; ++step) {  // the steps after the last whole pass
    if ((step & (Keys::kChunk - 1)) == 0) Keys::fill(ring, seed_term, step);
    draw_and_step(ring, step, idx, log_c, e, s);
  }
  if (live) {
    x_out[p] = s.x;
    sig_out[p] = s.sigma;
    qv_out[p] = s.qvar;
  }
}

}  // namespace

// Launches on `stream`; `host_args` points to 17 floats laid out as LogSvArgs.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int logsv_mc_launch(const float* x0, const float* lns0, const float* qv0,
                               float* x_out, float* sig_out, float* qv_out,
                               long long nb_path, uint32_t seed, int nb_steps,
                               const float* host_args, void* stream) {
  LogSvArgs a;
  std::memcpy(&a, host_args, sizeof(a));
  const unsigned int blocks = static_cast<unsigned int>((nb_path + kThreads - 1) / kThreads);
  logsv_mc_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x0, lns0, qv0, x_out, sig_out, qv_out, nb_path, seed, nb_steps, a);
  return static_cast<int>(cudaGetLastError());
}
