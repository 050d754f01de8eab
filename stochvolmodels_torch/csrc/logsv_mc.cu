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
//   * the drift of ln sigma uses an exact 1/sigma (the TPU kernel's
//     approximate reciprocal is not reproduced).
//
// What bounds it on an H100: each step of each path is ~4 integer hashes
// (32-bit multiplies), two polynomials, two sqrt, one exp and one division,
// all in registers; memory traffic is 24 bytes per path (three f32 state
// values in, three out) for hundreds of steps, so the kernel is bound by
// integer and special-function throughput, not by bandwidth.  The design
// answer is one thread per path with the whole state in registers and the
// step loop inside the thread; nothing touches memory until the end.
//
// Built by stochvolmodels_torch/ops/_build.py with nvcc for sm_90a into a
// shared library with the plain C entry point `logsv_mc_launch`, with
// -fmad=false: every operation rounds once, in the order written, as in the
// plain version (simulate_logsv_terminal_torch); with the same CUDA expf,
// sqrtf and IEEE division that PyTorch's CUDA ops call, kernel and plain
// version agree bit for bit on the card.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "counter_rng.cuh"

namespace {

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

__global__ void __launch_bounds__(256)
logsv_mc_kernel(const float* __restrict__ x0, const float* __restrict__ lns0,
                const float* __restrict__ qv0, float* __restrict__ x_out,
                float* __restrict__ sig_out, float* __restrict__ qv_out,
                long long nb_path, uint32_t seed, int nb_steps, LogSvArgs a) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= nb_path) return;
  const svt::PathCounter pc = svt::path_counter(seed, p);
  const float vartheta2 = a.beta * a.beta + a.volvol * a.volvol;
  const float eta2 = a.eta * a.eta;
  const float alpha_half = a.alpha * 0.5f;
  const float k1theta = a.kappa1 * a.theta;
  float log_c[7];  // fully unrolled below: lives in registers
#pragma unroll
  for (int k = 0; k < 7; ++k) log_c[k] = a.log_c[k];

  float x = x0[p];
  float lns = lns0[p];
  float qvar = qv0[p];
  float sigma = expf(lns);
  for (int step = 0; step < nb_steps; ++step) {
    float z0, z1;
    svt::normal_pair(pc, step, log_c, z0, z1);
    const float w0 = z0 * a.sdt;
    const float w1 = z1 * a.sdt;
    const float sig2dt = eta2 * sigma * sigma * a.dt;
    x = x + alpha_half * sig2dt + a.eta * sigma * w0;
    lns = lns + ((k1theta * (1.0f / sigma) - a.kappa1) + a.kappa2 * (a.theta - sigma)
                 + a.adj * sigma - 0.5f * vartheta2) * a.dt
              + a.beta * w0 + a.volvol * w1;
    const float sigma_new = expf(lns);
    qvar = qvar + 0.5f * (sig2dt + eta2 * sigma_new * sigma_new * a.dt);
    sigma = sigma_new;
  }
  x_out[p] = x;
  sig_out[p] = sigma;
  qv_out[p] = qvar;
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
  const int threads = 256;
  const long long blocks = (nb_path + threads - 1) / threads;
  logsv_mc_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      x0, lns0, qv0, x_out, sig_out, qv_out, nb_path, seed, nb_steps, a);
  return static_cast<int>(cudaGetLastError());
}
