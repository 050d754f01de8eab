"""
Student-t distribution analytics for option valuation, on tensors.

PyTorch counterpart of ``stochvolmodels_tpu/ops/tdist.py``: terminal
log-returns are Student-t with nu > 2 degrees of freedom, scaled by upsilon
so that the variance is vol^2 ttm.  The risk-neutral drift is a
fixed-iteration Newton solve, differentiable through its iterations.

Torch has no regularized incomplete beta function, so :func:`betainc` is
written here in float64: the continued fraction of DLMF 8.17.22 (the one the
JAX package's ``betainc`` evaluates by modified Lentz) at a fixed
``BETAINC_TERMS`` terms, after the symmetry I_x(a, b) = 1 - I_{1-x}(b, a)
where x > (a + 1) / (a + b + 2), so that it converges fast.  Its convergent
A_N / B_N is the product of the terms' 2x2 recurrence matrices, taken as a
tree of batched products: log2(N) stages of a few kernels each instead of N
sequential Lentz updates of ~20, with no host sync, so a CUDA graph or a
``torch.func`` transform can hold it.  Its derivatives are the JAX
package's: the analytic x-derivative and central differences (eps = 1e-6)
in a and b, in forward and reverse mode.  Float inputs and numpy arrays
become float64 tensors on the device of the first tensor argument (the card
if none).
"""
from __future__ import annotations

import math

import torch

from stochvolmodels_torch.ops.bsm import _device_of, _f64, _is_call, frozen_bisection

# terms of the continued fraction: 50 reach float64 convergence (|delta - 1|
# < eps / 2, the JAX package's stopping test) everywhere on the Student-t
# callers' domain a = nu / 2 in [1.005, 10], b = 1/2, and on b in [1/2, 5/2];
# a power of two for the product tree.  The recurrence entries stay below
# 2^N in size, so no rescaling is needed.
BETAINC_TERMS = 64
BETAINC_FD_EPS = 1e-6


def _continued_fraction(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + d_1 / (1 + d_2 / (1 + ...))) to BETAINC_TERMS terms, with
    d_{2m+1} = -(a + m)(a + b + m) x / ((a + 2m)(a + 2m + 1)) and d_{2m} =
    m (b - m) x / ((a + 2m - 1)(a + 2m)): the convergent A_N / B_N of the
    Wallis recurrence [A_n, B_n] = [A_{n-1}, B_{n-1}] + a_n [A_{n-2},
    B_{n-2}] (a_1 = 1, a_n = d_{n-1}), i.e. the (0, 1) / (0, 0) entries of
    M_N ... M_1 with M_n = [[1, a_n], [1, 0]]."""
    n = torch.arange(2, BETAINC_TERMS + 1, dtype=torch.float64, device=x.device)
    m = torch.floor((n - 1.0) * 0.5)
    a_, b_, x_ = a[..., None], b[..., None], x[..., None]
    even = -(a_ + m) * (a_ + b_ + m) * x_ / ((a_ + 2.0 * m) * (a_ + 2.0 * m + 1.0))
    odd = m * (b_ - m) * x_ / ((a_ + 2.0 * m - 1.0) * (a_ + 2.0 * m))
    nums = torch.where(n % 2.0 == 0.0, even, odd)
    nums = torch.cat([torch.ones_like(x_), nums], dim=-1)                # a_1 .. a_N
    ones = torch.ones_like(nums)
    mats = torch.stack([torch.stack([ones, nums], dim=-1),
                        torch.stack([ones, torch.zeros_like(nums)], dim=-1)], dim=-2)
    while mats.shape[-3] > 1:                                            # (..., count, 2, 2)
        pairs = mats.unflatten(-3, (mats.shape[-3] // 2, 2))
        mats = pairs[..., 1, :, :] @ pairs[..., 0, :, :]                 # later term on the left
    prod = mats[..., 0, :, :]
    return prod[..., 0, 1] / prod[..., 0, 0]


def _betaln(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _betainc_value(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """I_x(a, b) for float64 tensors of one shape: 0 at x = 0, 1 at x = 1,
    NaN where a, b or x is NaN or negative or x > 1."""
    fast = x < (a + 1.0) / (a + b + 2.0)
    aa, bb = torch.where(fast, a, b), torch.where(fast, b, a)
    xx = torch.where(fast, x, 1.0 - x)
    factor = torch.exp(torch.log(xx) * aa + torch.log1p(-xx) * bb - _betaln(aa, bb)) / aa
    res = _continued_fraction(aa, bb, xx) * factor
    res = torch.where(fast, res, 1.0 - res)
    res = torch.where(x == 0.0, 0.0, torch.where(x == 1.0, 1.0, res))
    bad = (a < 0.0) | (b < 0.0) | (x < 0.0) | (x > 1.0) | torch.isnan(a + b + x)
    return torch.where(bad, torch.nan, res)


class _Betainc(torch.autograd.Function):
    """I_x(a, b) with the JAX package's tangent rule: the analytic dI/dx =
    x^(a-1) (1-x)^(b-1) / B(a, b) (x clipped to [1e-300, 1 - 1e-16]) and
    central differences with eps = 1e-6 in a and b; ``jvp`` for forward
    mode, ``backward`` for reverse mode (each difference taken only for an
    input that carries a tangent or needs a gradient)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(a, b, x):
        return _betainc_value(a, b, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)
        ctx.save_for_backward(*inputs)

    @staticmethod
    def _partials(ctx, want_a: bool, want_b: bool, want_x: bool):
        a, b, x = ctx.saved_tensors
        eps = BETAINC_FD_EPS
        fd = lambda lo, hi: (_betainc_value(*hi) - _betainc_value(*lo)) / (2.0 * eps)
        d_a = fd((a - eps, b, x), (a + eps, b, x)) if want_a else None
        d_b = fd((a, b - eps, x), (a, b + eps, x)) if want_b else None
        d_x = None
        if want_x:
            xc = torch.clamp(x, 1e-300, 1.0 - 1e-16)
            d_x = torch.exp((a - 1.0) * torch.log(xc) + (b - 1.0) * torch.log1p(-xc)
                            - _betaln(a, b))
        return d_a, d_b, d_x

    @staticmethod
    def jvp(ctx, da, db, dx):
        partials = _Betainc._partials(ctx, da is not None, db is not None, dx is not None)
        out = torch.zeros_like(ctx.saved_tensors[2])
        for tangent, partial in zip((da, db, dx), partials):
            if tangent is not None:
                out = out + partial * tangent
        return out

    @staticmethod
    def backward(ctx, grad):
        partials = _Betainc._partials(ctx, *ctx.needs_input_grad)
        return tuple(None if p is None else grad * p for p in partials)


def betainc(a, b, x) -> torch.Tensor:
    """regularized incomplete beta I_x(a, b), float64, broadcast over its
    arguments, differentiable in a, b and x in forward and reverse mode."""
    device = _device_of(x, a, b)
    a, b, x = torch.broadcast_tensors(*(_f64(v, device).to(torch.float64) for v in (a, b, x)))
    return _Betainc.apply(a, b, x)


def compute_upsilon(vol, ttm, nu) -> torch.Tensor:
    """the scale upsilon = vol sqrt(ttm (nu - 2) / nu); a finite variance needs nu > 2."""
    return vol * torch.sqrt(ttm * (nu - 2.0) / nu)


def _gamma_ratio(nu) -> torch.Tensor:
    """Gamma((nu + 1) / 2) / Gamma(nu / 2) through lgamma."""
    return torch.exp(torch.lgamma(0.5 * (nu + 1.0)) - torch.lgamma(0.5 * nu))


def _tensors(*xs):
    device = _device_of(*xs)
    return tuple(_f64(v, device) for v in xs)


def pdf_tdist(x, mu, vol, nu, ttm) -> torch.Tensor:
    """the location-scale Student-t density."""
    x, mu, vol, nu, ttm = _tensors(x, mu, vol, nu, ttm)
    upsilon = compute_upsilon(vol=vol, ttm=ttm, nu=nu)
    z = (x - mu * ttm) / upsilon
    c = (1.0 / torch.sqrt(math.pi * nu)) * _gamma_ratio(nu) / upsilon
    return c * torch.pow(1.0 + torch.square(z) / nu, -0.5 * (nu + 1.0))


def _cdf_and_cum_mean(x, mu, vol, nu, ttm):
    """(cdf, partial expectation) at x from one incomplete beta: the two
    values :func:`cdf_tdist` and :func:`cum_mean_tdist` give."""
    upsilon = compute_upsilon(vol=vol, ttm=ttm, nu=nu)
    z = (x - mu * ttm) / upsilon
    cdf = 0.5 * (1.0 + torch.sign(z) * (1.0 - betainc(nu / 2.0, 0.5, nu / (torch.square(z) + nu))))
    norm = _gamma_ratio(nu) * torch.sqrt(nu / math.pi) / (1.0 - nu)
    cum_mean = mu * cdf + upsilon * norm * torch.pow(1.0 + torch.square(z) / nu,
                                                     -0.5 * (nu - 1.0))
    return cdf, cum_mean


def cdf_tdist(x, mu, vol, nu, ttm) -> torch.Tensor:
    """the location-scale Student-t CDF, through the incomplete beta."""
    return _cdf_and_cum_mean(*_tensors(x, mu, vol, nu, ttm))[0]


def cum_mean_tdist(x, mu=0.0, vol=0.2, nu=3.0, ttm=0.25) -> torch.Tensor:
    """the partial expectation h(x) = int_{-inf}^x u f(u) du."""
    return _cdf_and_cum_mean(*_tensors(x, mu, vol, nu, ttm))[1]


def imply_drift_tdist(rf_rate=0.0, vol=0.2, nu=3.0, ttm=0.25, nb_iters: int = 50) -> torch.Tensor:
    """the risk-neutral drift mu that solves the martingale condition, by
    ``nb_iters`` Newton iterations (differentiable through them), from
    mu = rf_rate; the derivative is d/dmu with x* = -(1 + ttm mu), dcdf/dx =
    f(x), dh/dx = x f(x), floored at 1e-14 in magnitude."""
    rf_rate, vol, nu, ttm = _tensors(rf_rate, vol, nu, ttm)
    rf_return = torch.exp(rf_rate * ttm) - 1.0
    zero = torch.zeros_like(vol)
    mu = rf_rate + zero
    for _ in range(int(nb_iters)):
        x_star = -(1.0 + ttm * mu)
        cdf, cum_mean = _cdf_and_cum_mean(x_star, zero, vol, nu, ttm)
        f = mu * ttm - cdf - cum_mean - rf_return
        fx = pdf_tdist(x_star, zero, vol, nu, ttm)
        df = ttm * (1.0 + (1.0 + x_star) * fx)
        mu = mu - f / torch.where(torch.abs(df) < 1e-14, 1e-14, df)
    return mu


def compute_default_prob_tdist(ttm, vol, nu=4.5, rf_rate=0.0) -> torch.Tensor:
    """P(terminal return <= -1) under the risk-neutral drift."""
    ttm, vol, nu, rf_rate = _tensors(ttm, vol, nu, rf_rate)
    mu = imply_drift_tdist(rf_rate=rf_rate, vol=vol, nu=nu, ttm=ttm)
    return cdf_tdist(x=-(1.0 + mu * ttm), mu=torch.zeros_like(mu), vol=vol, nu=nu, ttm=ttm)


def compute_forward_tdist(spot, ttm, vol, nu=4.5, rf_rate=0.0) -> torch.Tensor:
    """the forward with the default barrier."""
    spot, ttm, vol, nu, rf_rate = _tensors(spot, ttm, vol, nu, rf_rate)
    mu = imply_drift_tdist(rf_rate=rf_rate, vol=vol, nu=nu, ttm=ttm)
    x_star = -(1.0 + mu * ttm)
    c_1, h_1 = _cdf_and_cum_mean(x_star, torch.zeros_like(mu), vol, nu, ttm)
    return spot * ((1.0 + mu * ttm) * (1.0 - c_1) - h_1)


def _vanilla_price_tdist_core(spot, strikes, ttm, vol, nu, is_call, rf_rate,
                              is_compute_risk_neutral_mu: bool) -> torch.Tensor:
    """calls and puts under the Student-t terminal law with the default
    barrier at a return of -1; the drift implied, or ``rf_rate``."""
    discfactor = torch.exp(-rf_rate * ttm)
    if is_compute_risk_neutral_mu:
        mu = imply_drift_tdist(rf_rate=rf_rate, vol=vol, nu=nu, ttm=ttm)
    else:
        mu = rf_rate
    zero = torch.zeros_like(vol)
    spot_star = spot * (1.0 + mu * ttm)
    x_lower_bound = -1.0 - mu * ttm
    y = strikes / spot - (1.0 + mu * ttm)
    c_y, h_y = _cdf_and_cum_mean(y, zero, vol, nu, ttm)
    call_px = -spot * h_y + (spot_star - strikes) * (1.0 - c_y)
    c_1, h_1 = _cdf_and_cum_mean(x_lower_bound, zero, vol, nu, ttm)
    put_px = discfactor * ((strikes - spot_star) * (c_y - c_1) - spot * (h_y - h_1)
                           + strikes * c_1)
    return torch.where(is_call, call_px, put_px)


def compute_vanilla_price_tdist(spot, strikes, ttm, vol, nu=4.5, optiontypes='C', rf_rate=0.0,
                                is_compute_risk_neutral_mu: bool = True) -> torch.Tensor:
    """vanilla prices under the Student-t terminal law, over strikes and
    option types."""
    spot, strikes, ttm, vol, nu, rf_rate = _tensors(spot, strikes, ttm, vol, nu, rf_rate)
    return _vanilla_price_tdist_core(spot, strikes, ttm, vol, nu,
                                     _is_call(optiontypes, strikes.device), rf_rate,
                                     is_compute_risk_neutral_mu)


def infer_implied_vol_tdist(spot, ttm, strike, given_price, rf_rate=0.0, optiontype='C',
                            nu=4.5, tol: float = 1e-12,
                            is_bounds_to_nan: bool = False) -> torch.Tensor:
    """Student-t implied vol by the reference bisection on [0.05, 10]: 100
    iterations, each element frozen once its |price error| < 1e-12, every
    price with the drift implied at its vol.  ``tol`` is accepted for
    signature parity; out-of-bracket prices clamp to the violated bound (the
    reference default), or give NaN with ``is_bounds_to_nan=True``."""
    del tol
    spot, ttm, strike, given_price, rf_rate, nu = _tensors(spot, ttm, strike, given_price,
                                                           rf_rate, nu)
    is_call = _is_call(optiontype, given_price.device)
    price_at = lambda vol: _vanilla_price_tdist_core(spot, strike, ttm, vol, nu, is_call,
                                                     rf_rate, True)
    xmid, f, bracketed = frozen_bisection(price_at, given_price, 0.05, 10.0, 100, 1e-12)
    out_of_bracket = (torch.full_like(xmid, torch.nan) if is_bounds_to_nan else
                      torch.where(f < 0.0, torch.full_like(xmid, 0.05), torch.full_like(xmid, 10.0)))
    return torch.where(bracketed, xmid, out_of_bracket)


def infer_tdist_implied_vols_from_model_slice_prices(ttm, spot, strikes, optiontypes,
                                                     model_prices, rf_rate, nu) -> torch.Tensor:
    """Student-t implied vols of one maturity slice."""
    return infer_implied_vol_tdist(spot=spot, ttm=ttm, strike=strikes, given_price=model_prices,
                                   rf_rate=rf_rate, optiontype=optiontypes, nu=nu)
