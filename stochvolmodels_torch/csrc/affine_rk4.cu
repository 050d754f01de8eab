// The LogSV affine-expansion RK4 of a whole option chain on the transform
// grid, chained across its maturities, in one launch; and in a second launch
// the same with its forward sensitivities in the six model parameters.
//
// Replaces no TPU kernel: the JAX package leaves this solve to XLA
// (stochvolmodels_tpu/models/logsv/affine.py, solve_a_ode_grid, chained over
// the maturities by models/logsv/pricer.py).  Added because the plain PyTorch
// version (stochvolmodels_torch/models/logsv/affine.py, _solve_a_ode_grid_dts)
// is ~45 small kernels an RK4 step, ~155 under torch.func.jacfwd: 81% of the
// ~450k kernels of a captured LM fit of the BTC chain on an H100, at ~1.9 us
// each, so that fit paid for launches, not arithmetic.
//
// What it computes, for SECOND order, the spot measure, vol backbone eta 1
// and psi 0 (the LM and Adam objectives of models/logsv/fast_calibration.py):
//   * per chain b and transform point phi, the 5-term complex state A(0) = 0
//     advances as dA/dt = A'M A + (L0 + phi L1) A + h phi (phi + 1), the
//     terms of affine.py's _quadratic_term_entries, by classic RK4 over each
//     maturity segment's steps (the host's schedule: a step count and dt a
//     segment), the state carried from one segment to the next;
//   * the divergence freeze of _solve_a_ode_grid_dts, term by term: once a
//     term's |Re| or |Im| is not below 1e6 (NaN included), it is (1e6, 0)
//     for good, and its tangents are 0 (what jacfwd through torch.where
//     gives);
//   * at each maturity the log-MGF A . (1, y, y^2, y^3, y^4), y = sigma0 -
//     theta, written as a (B, T, N) complex128 panel;
//   * tangent launch: the exact derivative of that discrete map (each RK4
//     stage differentiated as jacfwd differentiates it) in sigma0, theta,
//     kappa1, kappa2, beta and volvol, written as (B, 6, T, N), beside the
//     panel.
// The sums run in another order than torch's complex GEMM and gemv and the
// symmetric pairs of M are summed once, so the results match the plain
// version to rounding, not bit for bit.
//
// What bounds it on an H100: float64 instruction rate and latency, not bytes.  A
// point-step is 1,122 flops primal and 2,098 more for each of the five
// directions, counted from this source (ops/affine_rk4.py, PRIMAL_FLOPS and
// DIRECTION_FLOPS); the BTC chain is 1,000 points x 156 steps, 0.175 GFLOP
// a primal launch and 1.81 GFLOP a tangent launch: 5.1 us and 53 us at 34
// TFLOP/s.  Reads and writes are under 0.5 MB a launch.
// What the design does about it:
//   * no device memory between steps: a thread keeps its point's 5-term
//     state (and, in the tangent launch, the tangent along its direction) in
//     registers through every step of every segment, and writes only at the
//     maturities; one launch a residual pass, one more for the tangents;
//   * M's 30 nonzeros as a compile-time pattern: the 8 distinct products
//     A_i A_j it touches, each symmetric pair's two entries summed into one
//     coefficient (18), and L's 13 + 11 nonzeros; no dense 25x5 product;
//   * the right-hand side is linear in 11 parameter "atoms" (qv2, qv, vt2,
//     kp, ...), so the parameter derivative of a stage is the same code run
//     on the atoms' derivatives: one thread of a block builds the chain's
//     coefficients and those of the block's direction into shared memory,
//     once per launch;
//   * only ~1,000 points a chain exist, so blocks are one warp and the
//     tangent launch spreads the five directions over separate blocks (a
//     warp never diverges on its direction): ~32 warps a chain in the primal
//     launch, ~160 in the tangent one, over the 132 SMs.  Each tangent
//     thread recomputes its point's primal stages itself rather than
//     receiving them from another warp through shared memory and a barrier
//     a stage: the primal is about a third of the thread's work, and the
//     warps stay independent (the price: 255 registers and a small spill
//     in the tangent instance);
//   * a leading chain axis: a batch of chains (the LM sweep's vmap) is one
//     launch of B x 5 x ceil(N / 32) blocks.
//
// Built by stochvolmodels_torch/ops/_build.py with nvcc for sm_90a and
// -fmad=false, like the other kernels.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;     // one warp a block
constexpr int kParams = 6;       // sigma0, theta, kappa1, kappa2, beta, volvol
constexpr int kDirections = 5;   // the ODE's parameters: theta, kappa1, kappa2, beta, volvol
constexpr int kMaxSegments = 32;
constexpr double kCap = 1e6;

struct Schedule {
  int nb_segments;
  int steps[kMaxSegments];
  double dt[kMaxSegments];
  double half_dt[kMaxSegments];   // 0.5 dt
  double sixth_dt[kMaxSegments];  // dt / 6
};

struct Cx {
  double re, im;
};

__device__ __forceinline__ Cx operator+(Cx a, Cx b) { return {a.re + b.re, a.im + b.im}; }
__device__ __forceinline__ Cx operator-(Cx a, Cx b) { return {a.re - b.re, a.im - b.im}; }
__device__ __forceinline__ Cx operator*(Cx a, Cx b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
__device__ __forceinline__ Cx operator*(double s, Cx a) { return {s * a.re, s * a.im}; }

// the right-hand side's parameter dependence: every coefficient is a
// constant times one of these, or a sum of two
struct Atoms {
  double qv2;  // theta^2 vartheta^2
  double qv;   // theta vartheta^2
  double vt2;  // vartheta^2 = beta^2 + volvol^2
  double kp;   // kappa1 + kappa2 theta
  double k2;   // kappa2
  double b;    // beta
  double tb;   // theta beta
  double t2b;  // theta^2 beta
  double h0;   // theta^2 / 2
  double h1;   // theta
  double h2;   // 1 / 2
};

// dA/dt = quad(A) + (l0 + phi l1) A + h phi (phi + 1) at the nonzeros:
//   m: the coefficients of the products A1A1, A1A2, A2A2, A1A3, A3A3, A1A4,
//      A2A3, A2A4 in each term (M's two entries of a symmetric pair summed);
//   l0: L0 at (0,2) (1,1) (1,2) (1,3) (2,1) (2,2) (2,3) (2,4) (3,2) (3,3)
//       (3,4) (4,3) (4,4); l1: L1 at (0,1) (1,1) (1,2) (2,1) (2,2) (2,3)
//       (3,2) (3,3) (3,4) (4,3) (4,4); h: terms 0-2 (3 and 4 are 0)
struct Coefs {
  double m[18];
  double l0[13];
  double l1[11];
  double h[3];
};

__device__ Atoms atoms_of(double theta, double kappa1, double kappa2, double beta,
                          double volvol) {
  const double theta2 = theta * theta;
  const double vt2 = beta * beta + volvol * volvol;
  return {theta2 * vt2, theta * vt2, vt2, kappa1 + kappa2 * theta, kappa2,
          beta, theta * beta, theta2 * beta, 0.5 * theta2, theta, 0.5};
}

// d atoms / d parameter `dir` (0 theta, 1 kappa1, 2 kappa2, 3 beta, 4 volvol)
__device__ Atoms atom_derivatives(int dir, double theta, double kappa2, double beta,
                                  double volvol) {
  const double theta2 = theta * theta;
  Atoms d = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if (dir == 0) {
    const double vt2 = beta * beta + volvol * volvol;
    d.qv2 = 2.0 * theta * vt2;
    d.qv = vt2;
    d.kp = kappa2;
    d.tb = beta;
    d.t2b = 2.0 * theta * beta;
    d.h0 = theta;
    d.h1 = 1.0;
  } else if (dir == 1) {
    d.kp = 1.0;
  } else if (dir == 2) {
    d.kp = theta;
    d.k2 = 1.0;
  } else {
    const double g = 2.0 * (dir == 3 ? beta : volvol);
    d.vt2 = g;
    d.qv = theta * g;
    d.qv2 = theta2 * g;
    if (dir == 3) {
      d.b = 1.0;
      d.tb = theta;
      d.t2b = theta2;
    }
  }
  return d;
}

// linear in the atoms, so the coefficients' derivatives are this of the
// atoms' derivatives
__device__ void make_coefs(const Atoms& a, Coefs* c) {
  const double m[18] = {0.5 * a.qv2,                                        // term 0
                        a.qv, 2.0 * a.qv2,                                  // term 1
                        0.5 * a.vt2, 2.0 * a.qv2, 4.0 * a.qv, 3.0 * a.qv2,  // term 2
                        4.0 * a.qv, 2.0 * a.vt2, 6.0 * a.qv, 4.0 * a.qv2, 6.0 * a.qv2,
                        2.0 * a.vt2, 4.5 * a.qv2, 3.0 * a.vt2, 8.0 * a.qv, 12.0 * a.qv,
                        8.0 * a.qv2};
  const double l0[13] = {a.qv2, -a.kp, 2.0 * a.qv, 3.0 * a.qv2,
                         -a.k2, a.vt2 - 2.0 * a.kp, 6.0 * a.qv, 6.0 * a.qv2,
                         -2.0 * a.k2, 3.0 * (a.vt2 - a.kp), 12.0 * a.qv,
                         -3.0 * a.k2, 2.0 * (a.vt2 - 2.0 * a.kp)};
  const double l1[11] = {-a.t2b, -2.0 * a.tb, -2.0 * a.t2b, -a.b, -4.0 * a.tb, -3.0 * a.t2b,
                         -2.0 * a.b, -6.0 * a.tb, -4.0 * a.t2b, -3.0 * a.b, -8.0 * a.tb};
  for (int i = 0; i < 18; ++i) c->m[i] = m[i];
  for (int i = 0; i < 13; ++i) c->l0[i] = l0[i];
  for (int i = 0; i < 11; ++i) c->l1[i] = l1[i];
  c->h[0] = a.h0;
  c->h[1] = a.h1;
  c->h[2] = a.h2;
}

// the 8 products A_i A_j that M's nonzeros touch
struct Products {
  Cx p11, p12, p22, p13, p33, p14, p23, p24;
};

__device__ __forceinline__ Products products(const Cx* y) {
  return {y[1] * y[1], y[1] * y[2], y[2] * y[2], y[1] * y[3],
          y[3] * y[3], y[1] * y[4], y[2] * y[3], y[2] * y[4]};
}

// their derivative along dy: d(y_i y_j) = dy_i y_j + y_i dy_j
__device__ __forceinline__ Products product_tangents(const Cx* y, const Cx* dy) {
  return {2.0 * (y[1] * dy[1]), dy[1] * y[2] + y[1] * dy[2], 2.0 * (y[2] * dy[2]),
          dy[1] * y[3] + y[1] * dy[3], 2.0 * (y[3] * dy[3]), dy[1] * y[4] + y[1] * dy[4],
          dy[2] * y[3] + y[2] * dy[3], dy[2] * y[4] + y[2] * dy[4]};
}

// out = quad(p) + (l0 + phi l1) y, plus h r with kForcing
template <bool kForcing>
__device__ __forceinline__ void rhs(const Coefs& c, const Products& p, Cx phi, Cx r,
                                    const Cx* y, Cx* out) {
  const double* m = c.m;
  const double* l0 = c.l0;
  const double* l1 = c.l1;
  const Cx q0 = m[0] * p.p11;
  const Cx q1 = m[1] * p.p11 + m[2] * p.p12;
  const Cx q2 = m[3] * p.p11 + m[4] * p.p22 + m[5] * p.p12 + m[6] * p.p13;
  const Cx q3 = m[7] * p.p22 + m[8] * p.p12 + m[9] * p.p13 + m[10] * p.p14 + m[11] * p.p23;
  const Cx q4 = m[12] * p.p22 + m[13] * p.p33 + m[14] * p.p13 + m[15] * p.p14 +
                m[16] * p.p23 + m[17] * p.p24;
  const Cx u0 = l0[0] * y[2] + phi * (l1[0] * y[1]);
  const Cx u1 = l0[1] * y[1] + l0[2] * y[2] + l0[3] * y[3] +
                phi * (l1[1] * y[1] + l1[2] * y[2]);
  const Cx u2 = l0[4] * y[1] + l0[5] * y[2] + l0[6] * y[3] + l0[7] * y[4] +
                phi * (l1[3] * y[1] + l1[4] * y[2] + l1[5] * y[3]);
  const Cx u3 = l0[8] * y[2] + l0[9] * y[3] + l0[10] * y[4] +
                phi * (l1[6] * y[2] + l1[7] * y[3] + l1[8] * y[4]);
  const Cx u4 = l0[11] * y[3] + l0[12] * y[4] + phi * (l1[9] * y[3] + l1[10] * y[4]);
  out[0] = q0 + u0;
  out[1] = q1 + u1;
  out[2] = q2 + u2;
  out[3] = q3 + u3;
  out[4] = q4 + u4;
  if (kForcing) {
    out[0] = out[0] + c.h[0] * r;
    out[1] = out[1] + c.h[1] * r;
    out[2] = out[2] + c.h[2] * r;
  }
}

// one RK4 stage: k = f(y) and, with kTangent, dk = f_A(y) dy + f_p(y), the
// latter being f's own code on the coefficients' derivatives
template <bool kTangent>
__device__ __forceinline__ void stage(const Coefs* coef, Cx phi, Cx r, const Cx* y,
                                      const Cx* dy, Cx* k, Cx* dk) {
  const Products p = products(y);
  rhs<true>(coef[0], p, phi, r, y, k);
  if (kTangent) {
    Cx u[5], v[5];
    rhs<false>(coef[0], product_tangents(y, dy), phi, r, dy, u);
    rhs<true>(coef[1], p, phi, r, y, v);
    for (int i = 0; i < 5; ++i) dk[i] = u[i] + v[i];
  }
}

__device__ __forceinline__ Cx dot(const Cx* a, const double* w) {
  Cx s = w[0] * a[0];
  for (int i = 1; i < 5; ++i) s = s + w[i] * a[i];
  return s;
}

__device__ __forceinline__ void store(double* out, long long index, Cx v) {
  out[2 * index] = v.re;
  out[2 * index + 1] = v.im;
}

// blockIdx.x: the chain (primal) or chain x direction (tangent); blockIdx.y:
// a warp's worth of points.  params (B, 6) float64; phi_grid (B, N) and
// log_mgf (B, T, N) complex128 (interleaved float64 pairs); partials
// (B, 6, T, N) complex128, written by the tangent launch only.
template <bool kTangent>
__global__ void __launch_bounds__(kThreads)
affine_rk4_kernel(const double* __restrict__ params, const double* __restrict__ phi_grid,
                  double* __restrict__ log_mgf, double* __restrict__ partials, int nb_points,
                  Schedule s) {
  __shared__ Coefs coef[2];  // the chain's, and their derivative along the block's direction
  const int chain = kTangent ? blockIdx.x / kDirections : blockIdx.x;
  const int dir = kTangent ? blockIdx.x % kDirections : 0;
  const double* p = params + static_cast<long long>(chain) * kParams;
  const double sigma0 = p[0], theta = p[1], kappa1 = p[2], kappa2 = p[3], beta = p[4],
               volvol = p[5];
  if (threadIdx.x == 0) {
    make_coefs(atoms_of(theta, kappa1, kappa2, beta, volvol), &coef[0]);
    if (kTangent) make_coefs(atom_derivatives(dir, theta, kappa2, beta, volvol), &coef[1]);
  }
  __syncthreads();
  const int n = blockIdx.y * kThreads + threadIdx.x;
  if (n >= nb_points) return;
  const long long point = static_cast<long long>(chain) * nb_points + n;
  const Cx phi = {phi_grid[2 * point], phi_grid[2 * point + 1]};
  const Cx r = phi * Cx{phi.re + 1.0, phi.im};
  // the contraction's weights and their derivative in sigma0 (minus that in theta)
  const double y = sigma0 - theta;
  const double y2 = y * y;
  const double ys[5] = {1.0, y, y2, y2 * y, y2 * y2};
  const double dys[5] = {0.0, 1.0, 2.0 * y, 3.0 * y2, 4.0 * (y2 * y)};
  const int nb_maturities = s.nb_segments;

  Cx a[5], da[5], acc[5], dacc[5], yv[5], dyv[5], k[5], dk[5];
  bool dead[5];
  for (int i = 0; i < 5; ++i) {
    a[i] = Cx{0.0, 0.0};
    da[i] = Cx{0.0, 0.0};
    dead[i] = false;
  }
  for (int seg = 0; seg < nb_maturities; ++seg) {
    const double dt = s.dt[seg], half = s.half_dt[seg], sixth = s.sixth_dt[seg];
    for (int step = 0; step < s.steps[seg]; ++step) {
      // k1 .. k4 and acc = ((k1 + 2 k2) + 2 k3) + k4, in the plain version's order
      stage<kTangent>(coef, phi, r, a, da, k, dk);
      for (int i = 0; i < 5; ++i) {
        acc[i] = k[i];
        yv[i] = a[i] + half * k[i];
        if (kTangent) {
          dacc[i] = dk[i];
          dyv[i] = da[i] + half * dk[i];
        }
      }
      stage<kTangent>(coef, phi, r, yv, dyv, k, dk);
      for (int i = 0; i < 5; ++i) {
        acc[i] = acc[i] + 2.0 * k[i];
        yv[i] = a[i] + half * k[i];
        if (kTangent) {
          dacc[i] = dacc[i] + 2.0 * dk[i];
          dyv[i] = da[i] + half * dk[i];
        }
      }
      stage<kTangent>(coef, phi, r, yv, dyv, k, dk);
      for (int i = 0; i < 5; ++i) {
        acc[i] = acc[i] + 2.0 * k[i];
        yv[i] = a[i] + dt * k[i];
        if (kTangent) {
          dacc[i] = dacc[i] + 2.0 * dk[i];
          dyv[i] = da[i] + dt * dk[i];
        }
      }
      stage<kTangent>(coef, phi, r, yv, dyv, k, dk);
      for (int i = 0; i < 5; ++i) {
        const Cx a1 = a[i] + sixth * (acc[i] + k[i]);
        // !(x < cap) also holds for NaN
        dead[i] = dead[i] || !(fabs(a1.re) < kCap) || !(fabs(a1.im) < kCap);
        a[i] = dead[i] ? Cx{kCap, 0.0} : a1;
        if (kTangent) {
          const Cx da1 = da[i] + sixth * (dacc[i] + dk[i]);
          da[i] = dead[i] ? Cx{0.0, 0.0} : da1;
        }
      }
    }
    const long long out = (static_cast<long long>(chain) * nb_maturities + seg) * nb_points + n;
    if (!kTangent) {
      store(log_mgf, out, dot(a, ys));
      continue;
    }
    // partials (chain, j, seg, n): j = 0 sigma0, 1 theta, ... 5 volvol
    const long long plane = static_cast<long long>(nb_maturities) * nb_points;
    const long long base = (static_cast<long long>(chain) * kParams * nb_maturities + seg) *
                               nb_points + n;
    const Cx dlog = dot(da, ys);
    if (dir == 0) {
      const Cx ds = dot(a, dys);
      store(log_mgf, out, dot(a, ys));
      store(partials, base, ds);
      store(partials, base + plane, dlog - ds);
    } else {
      store(partials, base + (dir + 1) * plane, dlog);
    }
  }
}

}  // namespace

// Launches one pass on `stream`: the primal (tangent = 0) or the tangent
// launch.  params: nb_chains x 6 float64 (sigma0, theta, kappa1, kappa2,
// beta, volvol); phi_grid: nb_chains x nb_points complex128; log_mgf:
// nb_chains x nb_segments x nb_points complex128; partials (tangent only):
// nb_chains x 6 x nb_segments x nb_points complex128.  steps: nb_segments
// step counts; dts: per segment (dt, dt / 2, dt / 6), on the host.  Returns
// the cudaError_t of the launch.
extern "C" int affine_rk4_launch(const double* params, const double* phi_grid, double* log_mgf,
                                 double* partials, int tangent, int nb_chains, int nb_points,
                                 int nb_segments, const int* steps, const double* dts,
                                 void* stream) {
  if (nb_chains < 1 || nb_points < 1 || nb_segments < 1 || nb_segments > kMaxSegments)
    return static_cast<int>(cudaErrorInvalidValue);
  Schedule s;
  s.nb_segments = nb_segments;
  for (int i = 0; i < kMaxSegments; ++i) {
    const bool used = i < nb_segments;
    s.steps[i] = used ? steps[i] : 0;
    s.dt[i] = used ? dts[3 * i] : 0.0;
    s.half_dt[i] = used ? dts[3 * i + 1] : 0.0;
    s.sixth_dt[i] = used ? dts[3 * i + 2] : 0.0;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned point_blocks = static_cast<unsigned>((nb_points + kThreads - 1) / kThreads);
  if (tangent) {
    const dim3 grid(static_cast<unsigned>(nb_chains) * kDirections, point_blocks);
    affine_rk4_kernel<true><<<grid, kThreads, 0, st>>>(params, phi_grid, log_mgf, partials,
                                                       nb_points, s);
  } else {
    const dim3 grid(static_cast<unsigned>(nb_chains), point_blocks);
    affine_rk4_kernel<false><<<grid, kThreads, 0, st>>>(params, phi_grid, log_mgf, partials,
                                                        nb_points, s);
  }
  return static_cast<int>(cudaGetLastError());
}
