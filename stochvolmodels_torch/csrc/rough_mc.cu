// Rough LogSV Monte Carlo: Strang splitting of the N-factor Markovian lift,
// one thread per path.
//
// Replaces the TPU kernel `_rough_kernel` of stochvolmodels_tpu/ops/pallas_mc.py
// (with `_run_rough_kernel_32` and `simulate_rough_terminal_pallas`).  The
// lifted vol is sum_i w_i v_i over N = 1..5 factors; every path starts at
// v_i = v0f, log-spot 0 and integrated variance 0.  Each step, in the TPU
// kernel's order:
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
// What bounds it on an H100: instruction issue.  Per step and path the work
// is 8 evaluations of the drift right-hand side (each an N-term dot
// product), one expf, two hashes and three square roots, all in registers,
// with 12 bytes written per path for the whole horizon; the time is the SASS
// instructions each warp issues per step.  The design issues fewer:
//   * per-block keys: the keys of streams 0 and 1 depend only on the TPU
//     program, which holds 128 whole blocks of 256 threads; the block keeps
//     them in a shared-memory ring (KeyRing: 128 steps x 2 keys, one barrier
//     per 128 steps) and each thread hashes only its own index;
//   * carried dot products: w.v and wl.v of a step are w.vol_h and wl.vol_h
//     of the step before (w.vol_h is a constant where the floor fired), and
//     w.v seeds the first RK4 stage; these are exact;
//   * multiply-adds as FMA (__fmaf_rn): the dots, g, the right-hand side, the
//     RK4 stages and combination, the diffusion's exponent and the log-spot
//     and variance algebra.  The normals are drawn without contraction, bit
//     for bit the TPU stream's.  The kernel therefore differs from its plain
//     version (simulate_rough_terminal_torch, one rounding per operation in
//     the TPU kernel's order) by the drift's roundings, held to 1e-4.
// The factor count is a template parameter, as the TPU kernel unrolls the
// factors at trace time, so the lifted state and the node and weight
// constants live in registers.
//
// Built by stochvolmodels_torch/ops/_build.py with nvcc for sm_90a and
// -fmad=false: the compiler contracts nothing, so the FMAs are the explicit
// ones above.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "counter_rng.cuh"

namespace {

constexpr int kMaxNodes = 5;
constexpr int kThreads = 256;
static_assert(svt::kProgramPaths % kThreads == 0, "a block must lie in one TPU program");
using Keys = svt::KeyRing<kThreads, 2>;  // streams 0 and 1
constexpr float kVolFloor = 1e-6f;

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
  for (int i = 1; i < N; ++i) acc = __fmaf_rn(w[i], v[i], acc);
  return acc;
}

template <int N>
struct Lift {
  float x[N];   // nodes
  float w[N];   // weights
  float theta, kappa1, kappa2, v0f;

  // the drift at v, whose weighted sum w.v is zw
  __device__ __forceinline__ void rhs(const float* v, float zw, float* out) const {
    const float g = __fmaf_rn(kappa2, zw, kappa1) * (theta - zw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __fmaf_rn(-x[i], v[i] - v0f, g);
  }

  // v + (h/6)(s1 + 2 s2 + 2 s3 + s4) for v with w.v = vw; hh = h/2, h6 = h/6
  __device__ __forceinline__ void rk4(const float* v, float vw, float h, float hh, float h6,
                                      float* out) const {
    float s1[N], s2[N], s3[N], s4[N], t[N];
    rhs(v, vw, s1);
#pragma unroll
    for (int i = 0; i < N; ++i) t[i] = __fmaf_rn(hh, s1[i], v[i]);
    rhs(t, dot<N>(w, t), s2);
#pragma unroll
    for (int i = 0; i < N; ++i) t[i] = __fmaf_rn(hh, s2[i], v[i]);
    rhs(t, dot<N>(w, t), s3);
#pragma unroll
    for (int i = 0; i < N; ++i) t[i] = __fmaf_rn(h, s3[i], v[i]);
    rhs(t, dot<N>(w, t), s4);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float s = __fmaf_rn(2.0f, s3[i], __fmaf_rn(2.0f, s2[i], s1[i])) + s4[i];
      out[i] = __fmaf_rn(h6, s, v[i]);
    }
  }
};

template <int N>
__global__ void __launch_bounds__(kThreads)
rough_mc_kernel(float* __restrict__ x_out, float* __restrict__ vw_out,
                float* __restrict__ y_out, long long nb_path, uint32_t seed,
                int nb_steps, RoughArgs a) {
  __shared__ __align__(8) uint32_t ring[Keys::kWords];
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const uint32_t idx = static_cast<uint32_t>(p & (svt::kProgramPaths - 1));
  const uint32_t seed_term =
      svt::program_seed_term(seed, blockIdx.x / (svt::kProgramPaths / kThreads));
  float log_c[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) log_c[k] = a.log_c[k];

  Lift<N> lift;
  float wl[N];  // w_i * x_i
#pragma unroll
  for (int i = 0; i < N; ++i) {
    lift.x[i] = a.nodes[i];
    lift.w[i] = a.weights[i];
    wl[i] = a.weights[i] * a.nodes[i];
  }
  lift.theta = a.theta;
  lift.kappa1 = a.kappa1;
  lift.kappa2 = a.kappa2;
  lift.v0f = a.v0f;

  float w_sum = lift.w[0];
#pragma unroll
  for (int i = 1; i < N; ++i) w_sum = w_sum + lift.w[i];
  float wlam_sum = wl[0];
#pragma unroll
  for (int i = 1; i < N; ++i) wlam_sum = wlam_sum + wl[i];
  const float hh = 0.5f * a.h2;
  const float h6 = a.h2 / 6.0f;
  const float rho_comp = sqrtf(fmaxf(1.0f - a.rho * a.rho, 0.0f));
  const float volvol_s = a.volvol * w_sum;
  const float w_inv = 1.0f / w_sum;
  const float diff_drift = -0.5f * volvol_s * volvol_s * a.hf;
  const float w_lam_v0 = wlam_sum * a.v0f;
  const float k1theta = a.kappa1 * a.theta;
  const float k12_half = 0.5f * (a.kappa1 - a.kappa2 * a.theta);
  const float k2_half = 0.5f * a.kappa2;
  const float half_h = 0.5f * a.hf;
  const float rho_term1 = a.rho * (1.0f / a.volvol) * a.hf;  // rho inv_volvol dt
  float floor_v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) floor_v[i] = kVolFloor;
  const float floor_vw = dot<N>(lift.w, floor_v);

  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = a.v0f;
  // carried from step to step: w.v, (w.v)^2 and wl.v
  float vw = dot<N>(lift.w, v);
  float sq_vw = vw * vw;
  float w_lam_vol = dot<N>(wl, v);
  float log_s = 0.0f;
  float y = 0.0f;
#pragma unroll 1
  for (int step = 0; step < nb_steps; ++step) {
    if ((step & (Keys::kChunk - 1)) == 0) Keys::fill(ring, seed_term, step);
    const uint2 k = *reinterpret_cast<const uint2*>(Keys::row(ring, step));
    float z0, z1;
    svt::normal_pair_from_keys(idx, k.x, k.y, log_c, z0, z1);
    float d_inn[N];
    lift.rk4(v, vw, a.h2, hh, h6, d_inn);
    // exact log-normal diffusion of the weighted sum
    const float yw = dot<N>(lift.w, d_inn);
    const float y_h = yw * expf(__fmaf_rn(volvol_s, z0 * a.sqh, diff_drift));
    const float q = (y_h - yw) * w_inv;
#pragma unroll
    for (int i = 0; i < N; ++i) d_inn[i] = d_inn[i] + q;
    float vol_h[N];
    lift.rk4(d_inn, dot<N>(lift.w, d_inn), a.h2, hh, h6, vol_h);

    float volw_h = dot<N>(lift.w, vol_h);
    if (!(volw_h > 0.0f)) {  // NaN or <= 0
#pragma unroll
      for (int i = 0; i < N; ++i) vol_h[i] = kVolFloor;
      volw_h = floor_vw;
    }
    const float sq_vhw = volw_h * volw_h;
    const float w_lam_vol_h = dot<N>(wl, vol_h);
    const float sq_sum = sq_vw + sq_vhw;
    const float a_term =
        (__fmaf_rn(0.5f, w_lam_vol + w_lam_vol_h, (volw_h - vw) / a.hf) - w_lam_v0) * w_inv;
    const float inner =
        __fmaf_rn(k2_half, sq_sum, __fmaf_rn(k12_half, vw + volw_h, a_term - k1theta));
    const float term2 = half_h * sq_sum;
    log_s = __fmaf_rn(rho_term1, inner, __fmaf_rn(-0.5f, term2, log_s));
    log_s = __fmaf_rn(rho_comp * sqrtf(svt::max_keep_nan(term2, 0.0f)), z1, log_s);
    y = y + term2;
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = vol_h[i];
    vw = volw_h;
    sq_vw = sq_vhw;
    w_lam_vol = w_lam_vol_h;
  }
  if (p < nb_path) {  // threads past the end only filled keys and met the barriers
    x_out[p] = log_s;
    vw_out[p] = vw;
    y_out[p] = y;
  }
}

template <int N>
int launch(float* x_out, float* vw_out, float* y_out, long long nb_path, uint32_t seed,
           int nb_steps, const RoughArgs& a, cudaStream_t stream) {
  const long long blocks = (nb_path + kThreads - 1) / kThreads;
  rough_mc_kernel<N><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
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
