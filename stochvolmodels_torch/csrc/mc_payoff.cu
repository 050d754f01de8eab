// MC payoff reductions of one slice: the discounted price and the standard
// error of each strike, in float64, read straight from the terminal state.
//
// Replaces no TPU kernel: the JAX package leaves its payoffs to XLA
// (stochvolmodels_tpu/ops/payoffs.py).  Added because the plain PyTorch
// version (ops/payoffs.py, mc_vars_payoff) builds float64 (strikes, paths)
// panels and reduces them: 22.6 of the 25.3 ms of device time of an MC chain
// call of 4,194,304 paths on an H100, for ~16 MB of state.
//
// It computes what mc_vars_payoff computes on the card, with the same float64
// operation on every element; only the order of the sums differs:
//   * x (float32 or float64) widened to float64, spot = forward * exp(x)
//     (libdevice exp, as torch's), recentred as spot - (nanmean(spot) -
//     forward), over the whole slice or over each replicate group;
//   * the underlying u = spot (LOG_RETURN) or qvar * (1 / ttm) (Q_VAR: the
//     card divides a tensor by a number through its reciprocal);
//   * a call (codes & 1) pays u > k ? u - k : 0, a put u < k ? k - u : 0,
//     taken as e = fma(s, u, -s k) with s = +-1 and e > 0 ? e : 0: s u and
//     s k are exact, so e is +-(u - k) rounded once, bit for bit u - k or
//     k - u, and the comparisons agree (also for NaN and inf);
//   * an inverse option (codes & 2) pays that over the recentred spot: a NaN
//     spot pays 0 to a plain option (both comparisons fail) and is counted,
//     and pays 0 / NaN to an inverse one, which is dropped;
//   * price = discfactor * nanmean; standard error = discfactor * the
//     two-pass nanstd (ddof 0) times 1 / sqrt(paths); antithetic: the pair
//     averages 0.5 (p_i + p_{i+P/2}) over P/2 pairs; R replicate groups: the
//     groups' means, their nanmean and their nanstd (ddof 1) over sqrt(R).
//
// What bounds it on an H100: float64 issue and the grid-wide reductions, not
// bytes.  The work is ~6 float64 operations a path and strike (a slice of
// 4,194,304 paths and 15 strikes: ~0.4 GFLOP, ~12 us at 34 TFLOP/s), and the
// state of a slice (16.8 MB in float32) fits in the 50 MB L2.  The design:
//   * three passes over x, which stays in L2 between them, and none writes
//     anything a path: (a) the spots' NaN-dropping sum and count, (b) each
//     strike's payoff sum and NaN count, (c) each strike's sum of squared
//     deviations from (b)'s mean (replicates need no (c)); then one block
//     finishes.  Four launches a slice, no panel;
//   * a grid of two blocks an SM (the wrapper sizes it), each thread walking
//     a grid stride of 16-byte loads (4 float32 or 2 float64 paths), one exp
//     a path a pass;
//   * the strikes in tiles of kTile, whose accumulators stay in registers; a
//     block takes one tile of one group, so a chain of more strikes re-reads
//     x from L2 once a tile; each strike's (s, -s k) (and mean) is read
//     from shared memory once a pack of paths;
//   * each block writes its partial sums; the next pass (and the last block)
//     reduces them itself, one warp a sum, in a fixed order: no float64
//     atomics, so one input gives the same bits run after run.
//
// Built by stochvolmodels_torch/ops/_build.py with nvcc for sm_90a and
// -fmad=false, like the path kernels: the only FMA is the exact one above.

#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;  // strikes whose accumulators a block keeps in registers
constexpr unsigned kFullMask = 0xffffffffu;

struct PayoffArgs {
  double forward;
  double inv_ttm;     // 1 / ttm, rounded on the host
  double discfactor;
  double inv_sqrt_n;  // 1 / sqrt(paths, pairs or replicates), rounded on the host
  long long nb_path;
  int nb_strikes;
  int nb_groups;      // 1, or the replicate groups R
  int bx_spot;        // blocks along the paths of a group in pass (a)
  int bx_pay;         // blocks along the paths of a (group, tile) in passes (b) and (c)
};

// the partial sums every pass leaves, laid out in the wrapper's two scratch
// buffers: spot (g, b) at g * bx_spot + b, payoff (k, g, b) at (k G + g) *
// bx_pay + b, deviation (k, b) at k * bx_pay + b
struct Partials {
  double* spot_sum;
  long long* spot_nan;
  double* pay_sum;
  long long* pay_nan;
  double* dev_sum;
};

__device__ __forceinline__ Partials partials(double* dscratch, long long* iscratch,
                                             const PayoffArgs& a) {
  const long long spot = static_cast<long long>(a.nb_groups) * a.bx_spot;
  const long long pay = static_cast<long long>(a.nb_strikes) * a.nb_groups * a.bx_pay;
  return Partials{dscratch, iscratch, dscratch + spot, iscratch + spot, dscratch + spot + pay};
}

template <typename T>
struct Pack;
template <>
struct Pack<float> {
  using V = float4;
  static constexpr int N = 4;
};
template <>
struct Pack<double> {
  using V = double2;
  static constexpr int N = 2;
};

__device__ __forceinline__ void widen(const float4& v, double (&out)[4]) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void widen(const double2& v, double (&out)[2]) {
  out[0] = v.x;
  out[1] = v.y;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// N elements from p, widened to float64: one 16-byte load where p is aligned
// (a replicate group or the second half of an antithetic pair need not be)
template <typename T>
__device__ __forceinline__ void load_pack(const T* p, bool aligned, double (&out)[Pack<T>::N]) {
  if (aligned) {
    widen(*reinterpret_cast<const typename Pack<T>::V*>(p), out);
  } else {
#pragma unroll
    for (int e = 0; e < Pack<T>::N; ++e) out[e] = static_cast<double>(p[e]);
  }
}

// M elements a call of a pass's visitor: x and qvar of the first path of each
// pair (or of each path) and, antithetic, of its partner
template <int M>
struct Paths {
  static constexpr int kM = M;
  double xa[M], qa[M], xb[M], qb[M];
};

// calls f(paths) on the elements [0, n) of this thread: packs by a grid
// stride over the bx blocks along the paths, then the last n % N elements
// one a thread.  Paired, element i is the pair (i, i + n).
template <typename T, bool kPaired, bool kQvar, typename F>
__device__ __forceinline__ void for_each_pack(const T* x, const T* q, long long n, int bx,
                                              F&& f) {
  constexpr int N = Pack<T>::N;
  const bool al_xa = aligned16(x), al_xb = !kPaired || aligned16(x + n);
  const bool al_qa = !kQvar || aligned16(q), al_qb = !(kQvar && kPaired) || aligned16(q + n);
  const long long packs = n / N;
  const long long start = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(bx) * kThreads;
  for (long long i = start; i < packs; i += stride) {
    Paths<N> v;
    load_pack(x + i * N, al_xa, v.xa);
    if (kQvar) load_pack(q + i * N, al_qa, v.qa);
    if (kPaired) {
      load_pack(x + n + i * N, al_xb, v.xb);
      if (kQvar) load_pack(q + n + i * N, al_qb, v.qb);
    }
    f(v);
  }
  if (start < n - packs * N) {
    const long long i = packs * N + start;
    Paths<1> v;
    v.xa[0] = static_cast<double>(x[i]);
    if (kQvar) v.qa[0] = static_cast<double>(q[i]);
    if (kPaired) {
      v.xb[0] = static_cast<double>(x[n + i]);
      if (kQvar) v.qb[0] = static_cast<double>(q[n + i]);
    }
    f(v);
  }
}

// the sum over a warp, the same bits in every lane (IEEE addition commutes)
template <typename V>
__device__ __forceinline__ V warp_reduce(V s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFullMask, s, off);
  return s;
}

// the sum of p[0, n) by one warp in a fixed order: lane l adds p[l], p[l + 32],
// ... in turn, then the lanes are reduced.  Every reader of a partial sum calls
// this on the same partials, so every block gets the same bits.
template <typename V>
__device__ __forceinline__ V warp_sum(const V* p, int n) {
  V s = 0;
  for (int i = threadIdx.x & 31; i < n; i += 32) s += p[i];
  return warp_reduce(s);
}

// mean - forward of group g's spots, from pass (a)'s partials (one warp)
__device__ __forceinline__ double spot_shift(const Partials& pt, const PayoffArgs& a, int g) {
  const long long len = a.nb_path / a.nb_groups;
  const double s = warp_sum(pt.spot_sum + static_cast<long long>(g) * a.bx_spot, a.bx_spot);
  const long long dropped = warp_sum(pt.spot_nan + static_cast<long long>(g) * a.bx_spot, a.bx_spot);
  return s / static_cast<double>(len - dropped) - a.forward;
}

// strike k's mean payoff over the len elements of group g, from pass (b)'s
// partials (one warp)
__device__ __forceinline__ double payoff_mean(const Partials& pt, const PayoffArgs& a, int k,
                                              int g, long long len) {
  const long long at = (static_cast<long long>(k) * a.nb_groups + g) * a.bx_pay;
  const double s = warp_sum(pt.pay_sum + at, a.bx_pay);
  const long long dropped = warp_sum(pt.pay_nan + at, a.bx_pay);
  return s / static_cast<double>(len - dropped);
}

// the payoff of one option on underlying u: s = 1 for a call and -1 for a
// put, c = -s k, so e = +-(u - k) rounded once (see the note above)
__device__ __forceinline__ double vanilla(double u, double s, double c) {
  const double e = __fma_rn(s, u, c);
  return e > 0.0 ? e : 0.0;
}

// a tile's (s, -s k) and means live in volatile shared memory and are read
// anew for each pack: hoisted out of the path loop, 16 strikes' legs and
// means would take 64-96 registers beside the accumulators, and spill
struct Legs {
  volatile double s[kTile];
  volatile double c[kTile];
};

// the strikes [k0, k0 + nk) of a block's tile in shared memory, and the bits
// of the inverse ones
__device__ __forceinline__ unsigned load_legs(const double* strikes, const int8_t* codes, int k0,
                                              int nk, Legs& legs) {
  unsigned inverse = 0;
  for (int j = 0; j < nk; ++j) inverse |= (codes[k0 + j] & 2) ? (1u << j) : 0u;
  if (static_cast<int>(threadIdx.x) < nk) {
    const double s = (codes[k0 + threadIdx.x] & 1) ? 1.0 : -1.0;
    legs.s[threadIdx.x] = s;
    legs.c[threadIdx.x] = -s * strikes[k0 + threadIdx.x];
  }
  return inverse;
}

// the recentred spots and the underlyings of a pack
template <int M, bool kQvar>
__device__ __forceinline__ void underlying(const double (&x)[M], const double (&q)[M],
                                           double shift, const PayoffArgs& a, double (&spot)[M],
                                           double (&u)[M]) {
#pragma unroll
  for (int e = 0; e < M; ++e) {
    spot[e] = a.forward * exp(x[e]) - shift;
    u[e] = kQvar ? q[e] * a.inv_ttm : spot[e];
  }
}

// one element's value for strike leg: the payoff, over the spot if inverse,
// and antithetic the pair's average
template <bool kPaired, bool kInverse>
__device__ __forceinline__ double element(double s, double c, double ua, double sa, double ub,
                                          double sb) {
  double p = vanilla(ua, s, c);
  if (kInverse) p = p / sa;
  if (kPaired) {
    double pb = vanilla(ub, s, c);
    if (kInverse) pb = pb / sb;
    p = 0.5 * (p + pb);
  }
  return p;
}

// pass (a): each block's NaN-dropping sum and NaN count of its group's spots
template <typename T>
__global__ void __launch_bounds__(kThreads)
mc_payoff_spot_kernel(const T* __restrict__ x, double* dscratch, long long* iscratch,
                      PayoffArgs a) {
  __shared__ double sum_w[kWarps];
  __shared__ long long nan_w[kWarps];
  const Partials pt = partials(dscratch, iscratch, a);
  const int g = blockIdx.y;
  const long long len = a.nb_path / a.nb_groups;
  double sum = 0.0;
  int dropped = 0;
  for_each_pack<T, false, false>(x + g * len, x, len, a.bx_spot, [&](const auto& v) {
#pragma unroll
    for (int e = 0; e < v.kM; ++e) {
      const double spot = a.forward * exp(v.xa[e]);
      if (isnan(spot)) {
        ++dropped;
      } else {
        sum += spot;
      }
    }
  });
  const double s = warp_reduce(sum);
  const long long n = warp_reduce(static_cast<long long>(dropped));
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    sum_w[warp] = s;
    nan_w[warp] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double bs = sum_w[0];
    long long bn = nan_w[0];
    for (int w = 1; w < kWarps; ++w) {
      bs += sum_w[w];
      bn += nan_w[w];
    }
    pt.spot_sum[static_cast<long long>(g) * a.bx_spot + blockIdx.x] = bs;
    pt.spot_nan[static_cast<long long>(g) * a.bx_spot + blockIdx.x] = bn;
  }
}

// the block's sums of acc[0, nk) in a fixed order (each warp's, then the
// warps' in turn), strike j's written by thread j to out[j * out_stride]
template <typename V, typename W>
__device__ __forceinline__ void block_store(V (&acc)[kTile], int nk, W (*red)[kTile], W* out,
                                            long long out_stride) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    if (j < nk) {
      const V s = warp_reduce(acc[j]);
      if ((threadIdx.x & 31) == 0) red[warp][j] = static_cast<W>(s);
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < nk) {
    W s = red[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += red[w][threadIdx.x];
    out[threadIdx.x * out_stride] = s;
  }
}

// pass (b): each block's payoff sums and NaN counts of its tile of strikes
// over its group's elements (pairs, antithetic)
template <typename T, bool kPaired, bool kQvar>
__global__ void __launch_bounds__(kThreads, 2)
mc_payoff_sum_kernel(const T* __restrict__ x, const T* __restrict__ q,
                     const double* __restrict__ strikes, const int8_t* __restrict__ codes,
                     double* dscratch, long long* iscratch, PayoffArgs a) {
  __shared__ Legs legs;
  __shared__ double shift_s;
  __shared__ double red_sum[kWarps][kTile];
  __shared__ long long red_nan[kWarps][kTile];
  const Partials pt = partials(dscratch, iscratch, a);
  const int g = blockIdx.y % a.nb_groups;
  const int k0 = (blockIdx.y / a.nb_groups) * kTile;
  const int nk = a.nb_strikes - k0 < kTile ? a.nb_strikes - k0 : kTile;
  const unsigned inverse = load_legs(strikes, codes, k0, nk, legs);
  if (threadIdx.x < 32) {
    const double shift = spot_shift(pt, a, g);
    if (threadIdx.x == 0) shift_s = shift;
  }
  __syncthreads();
  const double shift = shift_s;
  const long long len = kPaired ? a.nb_path / 2 : a.nb_path / a.nb_groups;
  double sum[kTile];
  int dropped[kTile];  // a thread's count; the block's is 64-bit
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    sum[j] = 0.0;
    dropped[j] = 0;
  }
  for_each_pack<T, kPaired, kQvar>(x + g * len, q + g * len, len, a.bx_pay, [&](const auto& v) {
    constexpr int M = std::remove_reference_t<decltype(v)>::kM;
    double sa[M], ua[M], sb[M] = {}, ub[M] = {};
    underlying<M, kQvar>(v.xa, v.qa, shift, a, sa, ua);
    if (kPaired) underlying<M, kQvar>(v.xb, v.qb, shift, a, sb, ub);
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j >= nk) break;
      const double s = legs.s[j], c = legs.c[j];
      if ((inverse >> j) & 1u) {
#pragma unroll
        for (int e = 0; e < M; ++e) {
          const double p = element<kPaired, true>(s, c, ua[e], sa[e], ub[e], sb[e]);
          if (isnan(p)) {
            ++dropped[j];
          } else {
            sum[j] += p;
          }
        }
      } else {  // a plain option's payoff is never NaN
#pragma unroll
        for (int e = 0; e < M; ++e) sum[j] += element<kPaired, false>(s, c, ua[e], sa[e], ub[e], sb[e]);
      }
    }
  });
  const long long at = (static_cast<long long>(k0) * a.nb_groups + g) * a.bx_pay + blockIdx.x;
  const long long stride = static_cast<long long>(a.nb_groups) * a.bx_pay;
  block_store(sum, nk, red_sum, pt.pay_sum + at, stride);
  block_store(dropped, nk, red_nan, pt.pay_nan + at, stride);
}

// pass (c), one group: each block's sums of squared deviations of its tile's
// payoffs from their means
template <typename T, bool kPaired, bool kQvar>
__global__ void __launch_bounds__(kThreads, 2)
mc_payoff_dev_kernel(const T* __restrict__ x, const T* __restrict__ q,
                     const double* __restrict__ strikes, const int8_t* __restrict__ codes,
                     double* dscratch, long long* iscratch, PayoffArgs a) {
  __shared__ Legs legs;
  __shared__ volatile double mean_s[kTile];
  __shared__ double shift_s;
  __shared__ double red_sum[kWarps][kTile];
  const Partials pt = partials(dscratch, iscratch, a);
  const int k0 = blockIdx.y * kTile;
  const int nk = a.nb_strikes - k0 < kTile ? a.nb_strikes - k0 : kTile;
  const long long len = kPaired ? a.nb_path / 2 : a.nb_path;
  const unsigned inverse = load_legs(strikes, codes, k0, nk, legs);
  const int warp = threadIdx.x / 32;
  if (warp == 0) {
    const double shift = spot_shift(pt, a, 0);
    if (threadIdx.x == 0) shift_s = shift;
  }
  for (int j = warp; j < nk; j += kWarps) {
    const double mean = payoff_mean(pt, a, k0 + j, 0, len);
    if ((threadIdx.x & 31) == 0) mean_s[j] = mean;
  }
  __syncthreads();
  const double shift = shift_s;
  double dev[kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j) dev[j] = 0.0;
  for_each_pack<T, kPaired, kQvar>(x, q, len, a.bx_pay, [&](const auto& v) {
    constexpr int M = std::remove_reference_t<decltype(v)>::kM;
    double sa[M], ua[M], sb[M] = {}, ub[M] = {};
    underlying<M, kQvar>(v.xa, v.qa, shift, a, sa, ua);
    if (kPaired) underlying<M, kQvar>(v.xb, v.qb, shift, a, sb, ub);
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j >= nk) break;
      const double s = legs.s[j], c = legs.c[j], mean = mean_s[j];
      if ((inverse >> j) & 1u) {
#pragma unroll
        for (int e = 0; e < M; ++e) {
          const double p = element<kPaired, true>(s, c, ua[e], sa[e], ub[e], sb[e]);
          if (!isnan(p)) {
            const double d = p - mean;
            dev[j] += d * d;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < M; ++e) {
          const double d = element<kPaired, false>(s, c, ua[e], sa[e], ub[e], sb[e]) - mean;
          dev[j] += d * d;
        }
      }
    }
  });
  block_store(dev, nk, red_sum, pt.dev_sum + static_cast<long long>(k0) * a.bx_pay + blockIdx.x,
              a.bx_pay);
}

// the last step, one block: each strike's price and standard error, one warp
// a strike, from the partials of (b) and (c)
template <bool kPaired>
__global__ void __launch_bounds__(kThreads)
mc_payoff_finish_kernel(double* dscratch, long long* iscratch, double* prices, double* stds,
                        PayoffArgs a) {
  const Partials pt = partials(dscratch, iscratch, a);
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x / 32; k < a.nb_strikes; k += kWarps) {
    double mean, sd;
    if (a.nb_groups == 1) {
      const long long len = kPaired ? a.nb_path / 2 : a.nb_path;
      mean = payoff_mean(pt, a, k, 0, len);
      const long long dropped = warp_sum(pt.pay_nan + static_cast<long long>(k) * a.bx_pay, a.bx_pay);
      const double count = static_cast<double>(len - dropped);
      const double var =
          warp_sum(pt.dev_sum + static_cast<long long>(k) * a.bx_pay, a.bx_pay) / count;
      sd = sqrt(count > 0.0 ? var : nan(""));
    } else {  // the replicate means, their nanmean and nanstd (ddof 1)
      const long long len = a.nb_path / a.nb_groups;
      double sum = 0.0;
      long long n = 0;
      for (int g = 0; g < a.nb_groups; ++g) {
        const double m = payoff_mean(pt, a, k, g, len);
        if (!isnan(m)) {
          sum += m;
          ++n;
        }
      }
      mean = sum / static_cast<double>(n);
      double ss = 0.0;
      for (int g = 0; g < a.nb_groups; ++g) {
        const double m = payoff_mean(pt, a, k, g, len);
        if (!isnan(m)) {
          const double d = m - mean;
          ss += d * d;
        }
      }
      const double count = static_cast<double>(n);
      const double var = ss / (count - 1.0);
      sd = sqrt(count > 1.0 ? var : nan(""));
    }
    if (lane == 0) {
      prices[k] = a.discfactor * mean;
      stds[k] = (a.discfactor * sd) * a.inv_sqrt_n;
    }
  }
}

template <typename T, bool kPaired, bool kQvar>
cudaError_t launch_passes(const void* x, const void* q, const double* strikes,
                          const int8_t* codes, double* prices, double* stds, double* dscratch,
                          long long* iscratch, const PayoffArgs& a, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* qt = static_cast<const T*>(q);
  const unsigned tiles = static_cast<unsigned>((a.nb_strikes + kTile - 1) / kTile);
  const unsigned groups = static_cast<unsigned>(a.nb_groups);
  auto spot = mc_payoff_spot_kernel<T>;
  spot<<<dim3(a.bx_spot, groups), kThreads, 0, stream>>>(xt, dscratch, iscratch, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto sum = mc_payoff_sum_kernel<T, kPaired, kQvar>;
  sum<<<dim3(a.bx_pay, groups * tiles), kThreads, 0, stream>>>(xt, qt, strikes, codes, dscratch,
                                                               iscratch, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.nb_groups == 1) {
    auto dev = mc_payoff_dev_kernel<T, kPaired, kQvar>;
    dev<<<dim3(a.bx_pay, tiles), kThreads, 0, stream>>>(xt, qt, strikes, codes, dscratch,
                                                        iscratch, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto finish = mc_payoff_finish_kernel<kPaired>;
  finish<<<1, kThreads, 0, stream>>>(dscratch, iscratch, prices, stds, a);
  return cudaGetLastError();
}

template <typename T, bool kPaired>
cudaError_t launch_paired(const void* x, const void* q, int qvar, const double* strikes,
                          const int8_t* codes, double* prices, double* stds, double* dscratch,
                          long long* iscratch, const PayoffArgs& a, cudaStream_t stream) {
  return qvar ? launch_passes<T, kPaired, true>(x, q, strikes, codes, prices, stds, dscratch,
                                                iscratch, a, stream)
              : launch_passes<T, kPaired, false>(x, q, strikes, codes, prices, stds, dscratch,
                                                 iscratch, a, stream);
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* q, int paired, int qvar,
                         const double* strikes, const int8_t* codes, double* prices,
                         double* stds, double* dscratch, long long* iscratch,
                         const PayoffArgs& a, cudaStream_t stream) {
  return paired ? launch_paired<T, true>(x, q, qvar, strikes, codes, prices, stds, dscratch,
                                         iscratch, a, stream)
                : launch_paired<T, false>(x, q, qvar, strikes, codes, prices, stds, dscratch,
                                          iscratch, a, stream);
}

}  // namespace

// Launches the passes of one slice on `stream` (3 or 4 launches).  x and q
// hold nb_path float32 (x_is_f64 = 0) or float64 values; q is read only with
// qvar.  strikes (float64) and codes (int8) hold nb_strikes values on the
// card; prices and stds receive nb_strikes float64.  dscratch holds
// G bx_spot + K G bx_pay + K bx_pay doubles and iscratch G bx_spot + K G
// bx_pay 64-bit integers; paired needs G = 1.  host_args: forward, 1 / ttm,
// discfactor, 1 / sqrt(n).  Returns the first non-zero cudaError_t.
extern "C" int mc_payoff_launch(const void* x, const void* q, int x_is_f64, int paired, int qvar,
                                const double* strikes, const int8_t* codes, double* prices,
                                double* stds, double* dscratch, long long* iscratch,
                                long long nb_path, int nb_strikes, int nb_groups, int bx_spot,
                                int bx_pay, const double* host_args, void* stream) {
  PayoffArgs a;
  a.forward = host_args[0];
  a.inv_ttm = host_args[1];
  a.discfactor = host_args[2];
  a.inv_sqrt_n = host_args[3];
  a.nb_path = nb_path;
  a.nb_strikes = nb_strikes;
  a.nb_groups = nb_groups;
  a.bx_spot = bx_spot;
  a.bx_pay = bx_pay;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_is_f64 ? launch_typed<double>(x, q, paired, qvar, strikes, codes, prices, stds, dscratch,
                                      iscratch, a, st)
               : launch_typed<float>(x, q, paired, qvar, strikes, codes, prices, stds, dscratch,
                                     iscratch, a, st);
  return static_cast<int>(err);
}
