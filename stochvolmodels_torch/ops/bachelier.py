"""
Bachelier (normal) model analytics on tensors: prices, deltas, vegas and
implied normal vols.

PyTorch counterpart of ``stochvolmodels_tpu/ops/bachelier.py``, with its
reference's convention quirks kept for parity: deltas and vegas scale the
normal vol by the forward (``sdev = forward * vol * sqrt(ttm)``) while the
price uses the absolute normal vol (``sdev = vol * sqrt(ttm)``); the implied
vol is a 100-iteration bisection on [0.001, 0.1] with a frozen-when-done
mask and tolerance 1e-12.  On a CUDA device the bisection replays as one
captured graph per panel shape (``ops/graphs.py``), bit for bit its eager
call.  Its gradient flows to the price only (1 / vega).  The fast implied
normal vol (a 20-step bisection and 4 Newton steps) carries the implicit-
function tangent in forward and reverse mode, so ``torch.func.jacfwd`` and
``vmap`` go through it.  Float inputs and numpy arrays become float64
tensors on the device of the first tensor argument (the card if none).
"""
from __future__ import annotations

import torch

from stochvolmodels_torch.ops import graphs
from stochvolmodels_torch.ops.bsm import (
    _broadcast_inputs,
    _device_of,
    _f64,
    _is_call,
    _ncdf_slope,
    bisection_nan_at_bounds,
)
from stochvolmodels_torch.ops.gauss import ncdf, norm_ppf, npdf

NORMAL_IV_LOWER, NORMAL_IV_UPPER, NORMAL_IV_TOL = 0.001, 0.1, 1e-12


def compute_normal_price(forward, strike, ttm, vol, discfactor=1.0,
                         optiontype='C') -> torch.Tensor:
    """Bachelier forward price with the absolute normal vol; elementwise."""
    device = _device_of(forward, strike, ttm, vol)
    forward, strike, ttm, vol = (_f64(a, device) for a in (forward, strike, ttm, vol))
    is_call = _is_call(optiontype, device)
    sdev = vol * torch.sqrt(ttm)
    d = (forward - strike) / sdev
    call_px = (forward - strike) * ncdf(d) + sdev * npdf(d)
    put_px = (forward - strike) * (ncdf(d) - 1.0) + sdev * npdf(d)
    return discfactor * torch.where(is_call, call_px, put_px)


def compute_normal_slice_prices(ttm, forward, strikes, vols, optiontypes,
                                discfactor=1.0) -> torch.Tensor:
    """prices of one maturity slice, over its strikes."""
    return compute_normal_price(forward=forward, strike=strikes, ttm=ttm, vol=vols,
                                optiontype=optiontypes, discfactor=discfactor)


def compute_normal_delta(ttm, forward, strike, vol, optiontype, discfactor=1.0) -> torch.Tensor:
    """normal delta N(d) (call) or -N(-d) (put), the vol scaled by the forward."""
    device = _device_of(forward, strike, ttm, vol)
    forward, strike, ttm, vol = (_f64(a, device) for a in (forward, strike, ttm, vol))
    is_call = _is_call(optiontype, device)
    sdev = forward * vol * torch.sqrt(ttm)
    d = (forward - strike) / sdev
    return discfactor * torch.where(is_call, ncdf(d), -ncdf(-d))


def compute_normal_slice_deltas(ttm, forward, strikes, vols, optiontypes,
                                discfactor=1.0) -> torch.Tensor:
    """deltas of one maturity slice, over its strikes."""
    return compute_normal_delta(ttm=ttm, forward=forward, strike=strikes, vol=vols,
                                optiontype=optiontypes, discfactor=discfactor)


def compute_normal_slice_vegas(ttm, forward, strikes, vols, optiontypes=None) -> torch.Tensor:
    """normal vegas F n(d) sqrt(T), the vol scaled by the forward."""
    device = _device_of(forward, strikes, ttm, vols)
    forward, strikes, ttm, vols = (_f64(a, device) for a in (forward, strikes, ttm, vols))
    sdev = forward * vols * torch.sqrt(ttm)
    d = (forward - strikes) / sdev
    return forward * npdf(d) * torch.sqrt(ttm)


def compute_normal_vegas_ttms(ttms, forwards, strikes_ttms, vols_ttms,
                              optiontypes_ttms=None) -> torch.Tensor:
    """vegas of a padded (T, K) chain panel."""
    device = _device_of(strikes_ttms, vols_ttms, ttms, forwards)
    return compute_normal_slice_vegas(ttm=_f64(ttms, device)[:, None],
                                      forward=_f64(forwards, device)[:, None],
                                      strikes=strikes_ttms, vols=vols_ttms)


def compute_normal_deltas_ttms(ttms, forwards, strikes_ttms, vols_ttms, optiontypes_ttms,
                               device="cuda") -> list:
    """deltas of a ragged chain, one numpy array per slice."""
    host = lambda a: _f64(a, torch.device(device))
    return [compute_normal_slice_deltas(ttm=host(t), forward=host(f), strikes=host(s),
                                        vols=host(v), optiontypes=o).cpu().numpy()
            for t, f, s, v, o in zip(ttms, forwards, strikes_ttms, vols_ttms, optiontypes_ttms)]


def compute_normal_delta_to_strike(ttm, forward, delta, vol) -> torch.Tensor:
    """the strike at a given normal delta (a call's for delta > 0, a put's below)."""
    device = _device_of(delta, forward, ttm, vol)
    delta, ttm = _f64(delta, device), _f64(ttm, device)
    inv_delta = torch.where(delta > 0.0, norm_ppf(delta), norm_ppf(1.0 + delta))
    sdev = forward * vol * torch.sqrt(ttm)
    return forward - sdev * inv_delta


def strikes_to_delta(strikes, ivols, f0, ttm):
    """the normal call delta N((F - K) / (vol sqrt(T))) of each strike: a
    tensor for tensor inputs, a numpy array for host inputs (a delta axis
    that pandas takes as an index, as it takes the JAX package's array)."""
    device = _device_of(strikes, ivols, ttm)
    host = not any(isinstance(a, torch.Tensor) for a in (strikes, ivols, f0, ttm))
    strikes, ivols, ttm = (_f64(a, device) for a in (strikes, ivols, ttm))
    deltas = ncdf((f0 - strikes) / ivols / torch.sqrt(ttm))
    return deltas.cpu().numpy() if host else deltas


def _normal_bisection_impl(given_price, forward, strike, ttm, discfactor, is_call_f):
    """the reference's 100-step bisection on [0.001, 0.1] on whole tensors of
    one shape; a result at a bound is NaN."""
    def price_at(vol):
        sdev = vol * torch.sqrt(ttm)
        d = (forward - strike) / sdev
        call_px = (forward - strike) * ncdf(d) + sdev * npdf(d)
        put_px = (forward - strike) * (ncdf(d) - 1.0) + sdev * npdf(d)
        return discfactor * torch.where(is_call_f > 0, call_px, put_px)

    return bisection_nan_at_bounds(price_at, given_price, NORMAL_IV_LOWER, NORMAL_IV_UPPER, 100,
                                   NORMAL_IV_TOL)


def _normal_bisection(given_price, forward, strike, ttm, discfactor, is_call_f) -> torch.Tensor:
    """``_normal_bisection_impl``, through its captured graph on a CUDA device."""
    inputs = (given_price, forward, strike, ttm, discfactor, is_call_f)
    if not graphs.use_graph(given_price):
        return _normal_bisection_impl(*inputs)
    key = (tuple(given_price.shape), str(given_price.device))
    return graphs.run_captured("normal_bisection", key,
                               lambda *a: (_normal_bisection_impl(*a),), inputs)[0]


class _NormalIVCore(torch.autograd.Function):
    """the 100-step bisection; its gradient goes to the price only, 1/vega
    (0 where the vol is NaN or |vega| < 1e-300), as the JAX package's
    ``custom_vjp`` gives it.  The forward replays a captured graph on the
    card, so no ``torch.func`` transform goes through it."""

    @staticmethod
    def forward(ctx, given_price, forward, strike, ttm, discfactor, is_call_f):
        vol = _normal_bisection(given_price, forward, strike, ttm, discfactor, is_call_f)
        ctx.save_for_backward(vol, forward, strike, ttm, discfactor)
        return vol

    @staticmethod
    def backward(ctx, grad):
        vol, forward, strike, ttm, discfactor = ctx.saved_tensors
        nan = torch.isnan(vol)
        sdev = torch.where(nan, 1.0, vol) * torch.sqrt(ttm)
        vega = discfactor * npdf((forward - strike) / sdev) * torch.sqrt(ttm)
        inv_vega = torch.where(nan | (torch.abs(vega) < 1e-300), 0.0, 1.0 / vega)
        return grad * inv_vega, None, None, None, None, None


def infer_normal_implied_vol(forward, ttm, strike, given_price, discfactor=1.0,
                             optiontype='C', tol: float = 1e-12,
                             is_bounds_to_nan: bool = True) -> torch.Tensor:
    """normal implied vol by the reference bisection on [0.001, 0.1].

    ``tol`` is accepted for signature parity (the fixed 100 iterations
    exceed it).  With ``is_bounds_to_nan`` (the default) out-of-bracket
    prices give NaN; otherwise they clamp to the violated bound.  The vol is
    differentiable in reverse mode in the price only.
    """
    del tol
    inputs = _broadcast_inputs(forward, ttm, strike, given_price, discfactor, optiontype)
    res = _NormalIVCore.apply(*inputs)
    if not is_bounds_to_nan:
        given_price, forward, strike, ttm, discfactor, _ = inputs
        p_low = compute_normal_price(forward=forward, strike=strike, ttm=ttm,
                                     vol=torch.full_like(ttm, NORMAL_IV_LOWER),
                                     optiontype=optiontype, discfactor=discfactor)
        unbracketed = torch.isnan(res) & torch.isfinite(given_price)
        bound = torch.where(given_price <= p_low, torch.full_like(res, NORMAL_IV_LOWER),
                            torch.full_like(res, NORMAL_IV_UPPER))
        res = torch.where(unbracketed, bound, res)
    return res


def infer_normal_ivols_from_model_slice_prices(ttm, forward, strikes, optiontypes,
                                               model_prices, discfactor) -> torch.Tensor:
    """normal implied vols of one maturity slice."""
    return infer_normal_implied_vol(forward=forward, ttm=ttm, strike=strikes,
                                    given_price=model_prices, discfactor=discfactor,
                                    optiontype=optiontypes)


def infer_normal_ivols_from_slice_prices(ttm, forward, discfactor, strikes, optiontypes,
                                         model_prices) -> torch.Tensor:
    """:func:`infer_normal_ivols_from_model_slice_prices` with the discount
    factor third, as the reference orders it."""
    return infer_normal_ivols_from_model_slice_prices(
        ttm=ttm, forward=forward, strikes=strikes, optiontypes=optiontypes,
        model_prices=model_prices, discfactor=discfactor)


def infer_normal_ivols_from_chain_prices(ttms, forwards, discfactors, strikes_ttms,
                                         optiontypes_ttms, model_prices_ttms) -> torch.Tensor:
    """normal implied vols of a padded (T, K) chain panel."""
    device = _device_of(model_prices_ttms, strikes_ttms, ttms)
    ttms, forwards, discfactors = (_f64(a, device)[:, None]
                                   for a in (ttms, forwards, discfactors))
    return infer_normal_implied_vol(forward=forwards, ttm=ttms, strike=strikes_ttms,
                                    given_price=model_prices_ttms, discfactor=discfactors,
                                    optiontype=optiontypes_ttms)


def compute_normal_delta_from_lognormal_vol(ttm, forward, strike, given_price, optiontype,
                                            discfactor=1.0) -> torch.Tensor:
    """the normal delta of an option quoted by its price."""
    normal_vol = infer_normal_implied_vol(forward=forward, ttm=ttm, strike=strike,
                                          given_price=given_price, optiontype=optiontype,
                                          discfactor=discfactor)
    return compute_normal_delta(ttm=ttm, forward=forward, strike=strike, vol=normal_vol,
                                optiontype=optiontype, discfactor=discfactor)


# ----------------------------------------------------------------------------
# fast implied normal vol (bisection + Newton, implicit-function tangent)
# ----------------------------------------------------------------------------

def _signed_price(forward, strike, ttm, discfactor, sgn, vol):
    """df (sgn (F - K) N(sgn d) + sdev n(d)), the fast inversion's price."""
    sdev = vol * torch.sqrt(ttm)
    d = (forward - strike) / sdev
    return discfactor * (sgn * (forward - strike) * ncdf(sgn * d) + sdev * npdf(d))


def _fast_normal_iv_impl(given_price, forward, strike, ttm, discfactor, sgn,
                         nb_bisect: int, nb_newton: int) -> torch.Tensor:
    """a short bisection on [0.001, 0.1] and a Newton polish, NaN where the
    price is not bracketed (the JAX package's ``_fast_normal_iv_impl``)."""
    price_at = lambda vol: _signed_price(forward, strike, ttm, discfactor, sgn, vol)
    lo = torch.full_like(given_price, NORMAL_IV_LOWER)
    hi = torch.full_like(given_price, NORMAL_IV_UPPER)
    bracketed = (price_at(lo) - given_price) * (price_at(hi) - given_price) < 0.0
    # unbracketed (or NaN) quotes are replaced by a solvable dummy before the
    # solver, so no NaN circulates; their output is NaN all the same
    mid_vol = torch.full_like(lo, 0.5 * (NORMAL_IV_LOWER + NORMAL_IV_UPPER))
    given_price = torch.where(bracketed, given_price, price_at(mid_vol))
    f_lo = price_at(lo) - given_price
    for _ in range(nb_bisect):
        mid = 0.5 * (lo + hi)
        go_up = (price_at(mid) - given_price) * f_lo > 0.0
        lo, hi = torch.where(go_up, mid, lo), torch.where(go_up, hi, mid)
    vol = 0.5 * (lo + hi)
    for _ in range(nb_newton):
        sdev = vol * torch.sqrt(ttm)
        vega = discfactor * npdf((forward - strike) / sdev) * torch.sqrt(ttm)
        step = (price_at(vol) - given_price) / torch.clamp(vega, min=1e-16)
        vol = torch.clamp(vol - step, NORMAL_IV_LOWER, NORMAL_IV_UPPER)
    return torch.where(bracketed, vol, torch.nan)


def _normal_price_partials(forward, strike, ttm, discfactor, vol, sgn):
    """(dP/dF, dP/dK, dP/dT, dP/d df, dP/d vol) of the fast inversion's price
    at ``vol``, N the erfcc normal CDF: the gradients that the JAX package
    takes with ``jax.grad`` of that price in its tangent rule."""
    sq = torch.sqrt(ttm)
    sdev = vol * sq
    u = forward - strike
    d = u / sdev
    n, slope = npdf(d), _ncdf_slope(sgn * d)
    # with u = F - K and s = sdev: dP/du = df (sgn N(sgn d) + d N'(sgn d) - d n(d)),
    # dP/ds = df (n(d) (1 + d^2) - d^2 N'(sgn d)); sgn^2 = 1
    dp_du = discfactor * (sgn * ncdf(sgn * d) + d * slope - d * n)
    dp_ds = discfactor * (n * (1.0 + d * d) - d * d * slope)
    dp_ddisc = sgn * u * ncdf(sgn * d) + sdev * n
    return dp_du, -dp_du, dp_ds * vol * 0.5 / sq, dp_ddisc, dp_ds * sq


class _FastNormalIVCore(torch.autograd.Function):
    """the fast implied normal vol with the implicit-function tangent rule

        dvol = (dP - dP/dF dF - dP/dK dK - dP/dT dT - dP/d df d df) / vega,

    1/vega set to 0 where the vol is NaN or |vega| < 1e-16, the partials
    taken at the vol (0.01 where it is NaN); in forward mode (``jvp``) and
    transposed in reverse mode (``backward``).  Torch does not differentiate
    a custom Function's ``jvp`` rule a second time, as JAX differentiates
    its ``custom_jvp`` rule: nested forward mode through this inversion
    gives 0 for the second order.  No caller needs second order."""
    generate_vmap_rule = True

    @staticmethod
    def forward(given_price, forward, strike, ttm, discfactor, sgn, nb_bisect, nb_newton):
        return _fast_normal_iv_impl(given_price, forward, strike, ttm, discfactor, sgn,
                                    nb_bisect, nb_newton)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, forward, strike, ttm, discfactor, sgn, _, _ = inputs
        ctx.save_for_forward(output, forward, strike, ttm, discfactor, sgn)
        ctx.save_for_backward(output, forward, strike, ttm, discfactor, sgn)

    @staticmethod
    def _rule(ctx):
        vol, forward, strike, ttm, discfactor, sgn = ctx.saved_tensors
        nan = torch.isnan(vol)
        *partials, vega = _normal_price_partials(forward, strike, ttm, discfactor,
                                                 torch.where(nan, 0.01, vol), sgn)
        inv_vega = torch.where(nan | (torch.abs(vega) < 1e-16), 0.0, 1.0 / vega)
        return inv_vega, partials

    @staticmethod
    def jvp(ctx, d_price, d_forward, d_strike, d_ttm, d_disc, _d_sgn, _nb_bisect, _nb_newton):
        inv_vega, partials = _FastNormalIVCore._rule(ctx)
        dvol = d_price if d_price is not None else torch.zeros_like(inv_vega)
        for d, partial in zip((d_forward, d_strike, d_ttm, d_disc), partials):
            if d is not None:
                dvol = dvol - partial * d
        return inv_vega * dvol

    @staticmethod
    def backward(ctx, grad):
        inv_vega, partials = _FastNormalIVCore._rule(ctx)
        gv = grad * inv_vega
        return (gv,) + tuple(-gv * d for d in partials) + (None, None, None)


def infer_normal_implied_vol_fast(forward, ttm, strike, given_price, discfactor=1.0,
                                  optiontype='C', nb_bisect: int = 20,
                                  nb_newton: int = 4) -> torch.Tensor:
    """fast implied normal vol: a 20-step bisection bracket on [0.001, 0.1]
    and a 4-step Newton polish, NaN at unbracketed quotes, for calibration
    objectives.  Its first derivatives in price, forward, strike, ttm and
    discount factor come from the implicit function theorem, in forward and
    reverse mode (``torch.func.jacfwd``, ``vmap`` and ``backward``)."""
    inputs = _broadcast_inputs(forward, ttm, strike, given_price, discfactor, optiontype)
    return _FastNormalIVCore.apply(*inputs, int(nb_bisect), int(nb_newton))

