// Rough LogSV Monte Carlo: Strang splitting of the N-factor Markovian lift,
// one thread per path.
//
// Replaces the TPU kernel `_rough_kernel` of stochvolmodels_tpu/ops/pallas_mc.py
// (with `_run_rough_kernel_32` and `simulate_rough_terminal_pallas`).  The
// lifted vol is sum_i w_i v_i over N = 1..5 factors; every path starts at
// v_i = v0f, log-spot 0 and integrated variance 0.  Each step, in the TPU
// kernel's operation order:
//   1. RK4 half step (h/2) of the drift ODE dv_i = -x_i (v_i - v0f) + g(w.v),
//      g(s) = (kappa1 + kappa2 s)(theta - s);
//   2. exact log-normal diffusion of the weighted sum, its increment spread
//      equally over the factors (times 1/sum w);
//   3. a second RK4 half step;
//   4. paths whose weighted vol is NaN or <= 0 are floored at 1e-6 per
//      factor (an IEEE test: never build with --use_fast_math);
//   5. the log-spot reconstruction with sqrt(max(term2, 0)).
// The random stream is counter_rng.cuh's: normal z0 drives the vol, z1 the
// orthogonal part of the spot.
//
// What bounds it on an H100: per step and path 8 evaluations of the drift
// right-hand side (each an N-term dot product), one expf, four hashes and
// three square roots, all in registers: it is bound by float and
// special-function throughput.  The factor count is a template parameter,
// as the TPU kernel unrolls the factors at trace time, so the whole lifted
// state (N floats) and the node and weight constants live in registers.
//
// Built by stochvolmodels_torch/ops/_build.py with nvcc for sm_90a and
// -fmad=false: every operation rounds once in the order written, as the
// plain version (simulate_rough_terminal_torch) does.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "counter_rng.cuh"

namespace {

constexpr int kMaxNodes = 5;

struct RoughArgs {
  float hf;      // f32(dt)
  float h2;      // f32(dt / 2)
  float sqh;     // f32(sqrt(dt)) with the sqrt taken in f64
  float theta;
  float kappa1;
  float kappa2;
  float rho;
  float volvol;
  float v0f;     // f32(sigma0 / sum w), taken in f64 on the host
  float nodes[kMaxNodes];
  float weights[kMaxNodes];
  float log_c[7];  // ln(1+f)/f polynomial, highest degree first
};
static_assert(sizeof(RoughArgs) == 26 * sizeof(float), "RoughArgs layout");

template <int N>
__device__ __forceinline__ float dot(const float* w, const float* v) {
  float acc = w[0] * v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) acc = acc + w[i] * v[i];
  return acc;
}

template <int N>
struct Lift {
  float x[N];   // nodes
  float w[N];   // weights
  float wl[N];  // w_i * x_i
  float theta, kappa1, kappa2, v0f;

  __device__ __forceinline__ void rhs(const float* v, float* out) const {
    const float zw = dot<N>(w, v);
    const float g = (kappa1 + kappa2 * zw) * (theta - zw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = -x[i] * (v[i] - v0f) + g;
  }

  // v + (h/6)(s1 + 2 s2 + 2 s3 + s4), with h/2 taken as 0.5f * h
  __device__ __forceinline__ void rk4(const float* v, float h, float h6, float* out) const {
    float s1[N], s2[N], s3[N], s4[N], t[N];
    rhs(v, s1);
#pragma unroll
    for (int i = 0; i < N; ++i) t[i] = v[i] + 0.5f * h * s1[i];
    rhs(t, s2);
#pragma unroll
    for (int i = 0; i < N; ++i) t[i] = v[i] + 0.5f * h * s2[i];
    rhs(t, s3);
#pragma unroll
    for (int i = 0; i < N; ++i) t[i] = v[i] + h * s3[i];
    rhs(t, s4);
#pragma unroll
    for (int i = 0; i < N; ++i)
      out[i] = v[i] + h6 * (s1[i] + 2.0f * s2[i] + 2.0f * s3[i] + s4[i]);
  }
};

template <int N>
__global__ void __launch_bounds__(256)
rough_mc_kernel(float* __restrict__ x_out, float* __restrict__ vw_out,
                float* __restrict__ y_out, long long nb_path, uint32_t seed,
                int nb_steps, RoughArgs a) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= nb_path) return;
  const svt::PathCounter pc = svt::path_counter(seed, p);
  float log_c[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) log_c[k] = a.log_c[k];

  Lift<N> lift;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    lift.x[i] = a.nodes[i];
    lift.w[i] = a.weights[i];
    lift.wl[i] = a.weights[i] * a.nodes[i];
  }
  lift.theta = a.theta;
  lift.kappa1 = a.kappa1;
  lift.kappa2 = a.kappa2;
  lift.v0f = a.v0f;

  float w_sum = lift.w[0];
#pragma unroll
  for (int i = 1; i < N; ++i) w_sum = w_sum + lift.w[i];
  float wlam_sum = lift.wl[0];
#pragma unroll
  for (int i = 1; i < N; ++i) wlam_sum = wlam_sum + lift.wl[i];
  const float h6 = a.h2 / 6.0f;
  const float rho_comp = sqrtf(fmaxf(1.0f - a.rho * a.rho, 0.0f));
  const float volvol_s = a.volvol * w_sum;
  const float w_inv = 1.0f / w_sum;
  const float inv_volvol = 1.0f / a.volvol;
  const float diff_drift = -0.5f * volvol_s * volvol_s * a.hf;
  const float w_lam_v0 = wlam_sum * a.v0f;
  const float k1theta = a.kappa1 * a.theta;
  const float k12 = a.kappa1 - a.kappa2 * a.theta;
  const float half_h = 0.5f * a.hf;

  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = a.v0f;
  float log_s = 0.0f;
  float y = 0.0f;
  for (int step = 0; step < nb_steps; ++step) {
    float z0, z1;
    svt::normal_pair(pc, step, log_c, z0, z1);
    float d_inn[N];
    lift.rk4(v, a.h2, h6, d_inn);
    // exact log-normal diffusion of the weighted sum
    const float yw = dot<N>(lift.w, d_inn);
    const float y_h = yw * expf(diff_drift + volvol_s * (z0 * a.sqh));
    const float q = (y_h - yw) * w_inv;
#pragma unroll
    for (int i = 0; i < N; ++i) d_inn[i] = d_inn[i] + q;
    float vol_h[N];
    lift.rk4(d_inn, a.h2, h6, vol_h);

    const float w_vol_h = dot<N>(lift.w, vol_h);
    if (isnan(w_vol_h) || w_vol_h <= 0.0f) {
#pragma unroll
      for (int i = 0; i < N; ++i) vol_h[i] = 1e-6f;
    }
    const float vw = dot<N>(lift.w, v);
    const float volw_h = dot<N>(lift.w, vol_h);
    const float sq_vw = vw * vw;
    const float sq_vhw = volw_h * volw_h;
    const float w_lam_vol = dot<N>(lift.wl, v);
    const float w_lam_vol_h = dot<N>(lift.wl, vol_h);
    const float term1 = inv_volvol * (
        ((volw_h - vw) / a.hf + 0.5f * w_lam_vol + 0.5f * w_lam_vol_h - w_lam_v0) * w_inv
        - k1theta + k12 * (0.5f * vw + 0.5f * volw_h)
        + a.kappa2 * (0.5f * sq_vw + 0.5f * sq_vhw)) * a.hf;
    const float term2 = half_h * sq_vw + half_h * sq_vhw;
    log_s = log_s - 0.5f * term2 + a.rho * term1
            + rho_comp * sqrtf(svt::max_keep_nan(term2, 0.0f)) * z1;
    y = y + half_h * (sq_vw + sq_vhw);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = vol_h[i];
  }
  x_out[p] = log_s;
  vw_out[p] = dot<N>(lift.w, v);
  y_out[p] = y;
}

template <int N>
int launch(float* x_out, float* vw_out, float* y_out, long long nb_path, uint32_t seed,
           int nb_steps, const RoughArgs& a, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (nb_path + threads - 1) / threads;
  rough_mc_kernel<N><<<static_cast<unsigned int>(blocks), threads, 0, stream>>>(
      x_out, vw_out, y_out, nb_path, seed, nb_steps, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the N = n_nodes instance on `stream`; `host_args` points to 26
// floats laid out as RoughArgs.  Returns the cudaError_t of the launch (0 on
// success), or cudaErrorInvalidValue for n_nodes outside 1..5.
extern "C" int rough_mc_launch(float* x_out, float* vw_out, float* y_out,
                               long long nb_path, uint32_t seed, int nb_steps,
                               int n_nodes, const float* host_args, void* stream) {
  RoughArgs a;
  std::memcpy(&a, host_args, sizeof(a));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_nodes) {
    case 1: return launch<1>(x_out, vw_out, y_out, nb_path, seed, nb_steps, a, s);
    case 2: return launch<2>(x_out, vw_out, y_out, nb_path, seed, nb_steps, a, s);
    case 3: return launch<3>(x_out, vw_out, y_out, nb_path, seed, nb_steps, a, s);
    case 4: return launch<4>(x_out, vw_out, y_out, nb_path, seed, nb_steps, a, s);
    case 5: return launch<5>(x_out, vw_out, y_out, nb_path, seed, nb_steps, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
