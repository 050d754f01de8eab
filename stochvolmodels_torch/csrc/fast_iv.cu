// The fast Black implied vol of a whole price panel in one launch: the
// bracket test, a short bisection and a Newton polish, and at the solved vol
// the inputs of its implicit-function tangent rule.
//
// Replaces no TPU kernel: the JAX package leaves its fast implied vol to XLA
// (stochvolmodels_tpu/ops/bsm.py, _fast_iv_impl).  Added because the plain
// PyTorch version (stochvolmodels_torch/ops/bsm.py, _fast_iv_impl, and the
// rule's _inverse_vega_and_partials) is ~3,000 float64 elementwise kernels a
// call and ~240 more a jacfwd pass, each of ~1.3 us over a few dozen
// doubles: ~77k of the ~87k kernels of a captured LogSV LM fit of the BTC
// chain on an H100, so that fit paid for launches, not arithmetic.
//
// What it computes, slot by slot, exactly what the plain version computes,
// in float64 and with the same Numerical Recipes erfcc normal CDF:
//   * the bracket test at [0.01, 5.0]: (P(0.01) - price) (P(5.0) - price) <
//     0; an unbracketed or NaN quote takes the dummy price P(1.0), so that no
//     NaN circulates, and its vol is NaN at the end;
//   * nb_bisect halvings, moving the lower end up where P(mid) - price has
//     the sign of P(0.01) - price;
//   * nb_newton Newton steps from the midpoint, vega = df F n(d1) sqrt(T)
//     floored at 1e-12, the vol clamped to [0.01, 5.0];
//   * at the solved vol (1 where it is NaN) the tangent rule's inputs: 1 /
//     vega of the erfcc price (0 where the vol is NaN or |vega| < 1e-12 F),
//     and the price partials dP/dF, dP/dK, dP/dT and dP/d(df), the
//     derivative of the erfcc CDF being that of its rational fit.
// Operation order follows the torch ops, and -fmad=false keeps a product and
// a sum two roundings, as two torch ops are.  A division by a Python number
// is, on a card, a product with its reciprocal (torch's div_true on CUDA),
// and so is it here (kInvSqrt2, kInvSqrt2Pi): the kernel gives the bits of
// the plain version on the card.  log(F / K) and sqrt(T), which the plain
// version recomputes at every price, are computed once a slot: the same
// values.
//
// What bounds it on an H100: the latency of one thread's dependent chain,
// not flops or bytes.  A slot is 31 price evaluations, 29 of them in
// sequence (the bracket's two and the dummy's overlap; then one a bisection
// stage, one a Newton stage), each two erfcc CDFs with an exp and a division
// each, and the rule's CDFs and slopes at the end: 2,538 float64
// operations a slot at 24 + 4 stages (ops/bsm.py, FAST_IV_FLOPS, counted
// from this source: a libm call or a division one each), 0.15 MFLOP for the
// BTC chain's 60 slots, 4.5 ns at 34 TFLOP/s; reads and writes are 96 bytes
// a slot.  What the design does about it:
//   * one thread a slot, 128-thread blocks, the ragged edge masked; no
//     shared memory, no barrier, every stage in registers;
//   * the two CDFs of a price evaluation are independent, and so are the
//     bracket's three prices, a Newton stage's price and vega, and the
//     rule's CDFs and slopes: the thread overlaps their exp and division
//     chains;
//   * nb_bisect and nb_newton are launch arguments and no stage is dropped;
//     the rule's outputs come from the same launch, so a jacfwd or backward
//     pass combines saved tensors and launches nothing.
//
// Built by stochvolmodels_torch/ops/_build.py with nvcc for sm_90a and
// -fmad=false, like the other kernels.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr double kLower = 0.01;
constexpr double kUpper = 5.0;
constexpr double kNewtonVegaFloor = 1e-12;
constexpr double kRuleVegaFloor = 1e-12;   // times the forward
// ops/gauss.py's ERFCC_COEFFS: exponent -z^2 + c0 + t (c1 + t (c2 + ... + t c9))
constexpr double kC0 = -1.26551223, kC1 = 1.00002368, kC2 = 0.37409196, kC3 = 0.09678418,
                 kC4 = -0.18628806, kC5 = 0.27886807, kC6 = -1.13520398, kC7 = 1.48851587,
                 kC8 = -0.82215223, kC9 = 0.17087277;
// 1 / math.sqrt(2.0) and 1 / math.sqrt(2.0 * math.pi), rounded once, as torch
// forms them on the host before a product on the card
constexpr double kInvSqrt2 = 1.0 / 1.4142135623730951;
constexpr double kInvSqrt2Pi = 1.0 / 2.5066282746310002;

// what stays fixed over a slot's solve
struct Slot {
  double fwd, strike, df, sgn;
  double x;       // log(F / K)
  double sq;      // sqrt(T)
  double df_sgn;  // df sgn
};

// torch.clamp: NaN passes through
__device__ __forceinline__ double clamp_min(double v, double lo) {
  return isnan(v) ? v : fmax(v, lo);
}
__device__ __forceinline__ double clamp(double v, double lo, double hi) {
  return isnan(v) ? v : fmin(fmax(v, lo), hi);
}

// ops/gauss.py's erfcc
__device__ __forceinline__ double erfcc(double u) {
  const double z = fabs(u);
  const double t = 1.0 / (1.0 + 0.5 * z);
  const double poly =
      kC1 + t * (kC2 + t * (kC3 + t * (kC4 + t * (kC5 + t * (kC6 + t * (kC7 + t * (kC8 +
                                                                                 t * kC9)))))));
  const double r = t * exp(-z * z + kC0 + t * poly);
  return u > 0.0 ? r : 2.0 - r;
}

// ops/gauss.py's ncdf
__device__ __forceinline__ double ncdf(double x) { return 1.0 - 0.5 * erfcc(x * kInvSqrt2); }

// ops/bsm.py's _ncdf_slope: d ncdf / dx of the rational fit itself
__device__ __forceinline__ double ncdf_slope(double x) {
  const double u = x * kInvSqrt2;
  const double z = fabs(u);
  const double t = 1.0 / (1.0 + 0.5 * z);
  constexpr double kHorner[8] = {kC8, kC7, kC6, kC5, kC4, kC3, kC2, kC1};
  double q = kC9, dq = 0.0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    dq = dq * t + q;
    q = q * t + kHorner[i];
  }
  const double e = exp(-z * z + kC0 + t * q);
  const double dt_dz = -0.5 * t * t;
  const double dr_dz = dt_dz * e + t * e * (-2.0 * z + (q + t * dq) * dt_dz);
  return -0.5 * dr_dz * kInvSqrt2;
}

// _fast_iv_impl's price_at: df sgn (F N(sgn d1) - K N(sgn d2))
__device__ __forceinline__ double price_at(double vol, const Slot& s) {
  const double s_ttm = vol * s.sq;
  const double d1 = (s.x + 0.5 * s_ttm * s_ttm) / s_ttm;
  const double d2 = d1 - s_ttm;
  const double n1 = ncdf(s.sgn * d1);
  const double n2 = ncdf(s.sgn * d2);
  return s.df_sgn * (s.fwd * n1 - s.strike * n2);
}

// the six outputs of n slots each
struct Outputs {
  double* vol;
  double* inv_vega;
  double* dp_dforward;
  double* dp_dstrike;
  double* dp_dttm;
  double* dp_ddiscfactor;
};

__global__ void __launch_bounds__(kThreads)
fast_iv_kernel(const double* __restrict__ price, const double* __restrict__ forward,
               const double* __restrict__ strike, const double* __restrict__ ttm,
               const double* __restrict__ discfactor, const double* __restrict__ sign,
               Outputs out, long long n, int nb_bisect, int nb_newton) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  Slot s;
  s.fwd = forward[i];
  s.strike = strike[i];
  s.df = discfactor[i];
  s.sgn = sign[i];
  s.x = log(s.fwd / s.strike);
  s.sq = sqrt(ttm[i]);
  s.df_sgn = s.df * s.sgn;

  // the bracket, and the dummy price of an unbracketed or NaN quote: three
  // independent price evaluations, which the thread overlaps
  const double p_lo = price_at(kLower, s);
  const double p_hi = price_at(kUpper, s);
  const double p_one = price_at(1.0, s);
  const bool bracketed = (p_lo - price[i]) * (p_hi - price[i]) < 0.0;
  const double given = bracketed ? price[i] : p_one;
  const double f_lo = p_lo - given;
  double lo = kLower, hi = kUpper;
  for (int k = 0; k < nb_bisect; ++k) {
    const double mid = 0.5 * (lo + hi);
    const bool go_up = (price_at(mid, s) - given) * f_lo > 0.0;  // same sign as lo: root above
    lo = go_up ? mid : lo;
    hi = go_up ? hi : mid;
  }
  double vol = 0.5 * (lo + hi);
  for (int k = 0; k < nb_newton; ++k) {
    const double s_ttm = vol * s.sq;
    const double d1 = s.x / s_ttm + 0.5 * s_ttm;
    const double pdf = exp(-0.5 * (d1 * d1)) * kInvSqrt2Pi;
    const double vega = s.df * s.fwd * pdf * s.sq;
    const double step = (price_at(vol, s) - given) / clamp_min(vega, kNewtonVegaFloor);
    vol = clamp(vol - step, kLower, kUpper);
  }
  vol = bracketed ? vol : NAN;

  // _inverse_vega_and_partials at the safe vol
  const double v = isnan(vol) ? 1.0 : vol;
  const double sv = v * s.sq;
  const double d1 = (s.x + 0.5 * sv * sv) / sv;
  const double d2 = d1 - sv;
  const double n1 = ncdf(s.sgn * d1), n2 = ncdf(s.sgn * d2);
  const double g1 = ncdf_slope(s.sgn * d1), g2 = ncdf_slope(s.sgn * d2);
  const double dp_dx = s.df * (s.fwd * g1 - s.strike * g2) / sv;
  const double dd1_ds = 0.5 - s.x / (sv * sv);
  const double dp_ds = s.df * (s.fwd * g1 * dd1_ds - s.strike * g2 * (dd1_ds - 1.0));
  const double dp_df = s.df_sgn * n1 + dp_dx / s.fwd;
  const double dp_dk = -s.df * s.sgn * n2 - dp_dx / s.strike;
  const double dp_dt = dp_ds * v * 0.5 / s.sq;
  const double dp_ddisc = s.sgn * (s.fwd * n1 - s.strike * n2);
  const double vega = dp_ds * s.sq;
  const bool flat = isnan(vol) || fabs(vega) < kRuleVegaFloor * s.fwd;
  out.vol[i] = vol;
  out.inv_vega[i] = flat ? 0.0 : 1.0 / vega;
  out.dp_dforward[i] = dp_df;
  out.dp_dstrike[i] = dp_dk;
  out.dp_dttm[i] = dp_dt;
  out.dp_ddiscfactor[i] = dp_ddisc;
}

}  // namespace

// Launches one solve on `stream`.  price, forward, strike, ttm, discfactor
// and sign (1.0 for a call, -1.0 for a put): n float64 each, 1 <= n < 2^31;
// vol, inv_vega, dp_dforward, dp_dstrike, dp_dttm, dp_ddiscfactor: n float64
// each, written.  Returns the cudaError_t of the launch.
extern "C" int fast_iv_launch(const double* price, const double* forward, const double* strike,
                              const double* ttm, const double* discfactor, const double* sign,
                              double* vol, double* inv_vega, double* dp_dforward,
                              double* dp_dstrike, double* dp_dttm, double* dp_ddiscfactor,
                              long long n, int nb_bisect, int nb_newton, void* stream) {
  if (n < 1 || n >= (1LL << 31) || nb_bisect < 0 || nb_newton < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  fast_iv_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      price, forward, strike, ttm, discfactor, sign,
      Outputs{vol, inv_vega, dp_dforward, dp_dstrike, dp_dttm, dp_ddiscfactor}, n, nb_bisect,
      nb_newton);
  return static_cast<int>(cudaGetLastError());
}
