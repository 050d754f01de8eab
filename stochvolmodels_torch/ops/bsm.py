"""
Black-Scholes-Merton prices, greeks, digitals and implied volatilities on
tensors.

PyTorch counterpart of ``stochvolmodels_tpu/ops/bsm.py``.  Every function is
elementwise over broadcastable tensors.  Implied volatility is the reference's
200-iteration bisection on [0.01, 5.0] with NaN at the bounds, run on whole
panels with a frozen-when-done mask; on a CUDA device it replays as one
captured graph per panel shape (``ops/graphs.py``).  The fast implied vol is
a 24-step bisection and 4 Newton steps, for calibration objectives: on a
CUDA panel one launch of the hand-written kernel ``csrc/fast_iv.cu``
(:func:`fast_iv_cuda`), which also writes the tangent rule's inputs at the
solved vol; on a CPU panel the plain torch-op version
(:func:`_fast_iv_impl`).  Both inversions are differentiable by the implicit
function theorem (d vol / d price = 1 / vega): the bisection in reverse mode,
the fast one in forward mode too, so ``torch.func.jacfwd`` and ``vmap`` go
through it.  Float inputs and numpy arrays become float64 tensors on the
device of the first tensor argument (the card if none).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from stochvolmodels_torch.config import encode_optiontypes
from stochvolmodels_torch.ops import graphs
from stochvolmodels_torch.ops.cuda_mc import _batch_first, _launcher, _raise_on_error
from stochvolmodels_torch.ops.gauss import ERFCC_COEFFS, _device_of, ncdf, norm_ppf, npdf
from stochvolmodels_torch.utils.profiling import to_device

IV_LOWER, IV_UPPER, IV_TOL = 0.01, 5.0, 1e-16
# csrc/fast_iv.cu's fast_iv_launch: (price, forward, strike, ttm, discfactor, sign, vol,
# inv_vega, dp_dforward, dp_dstrike, dp_dttm, dp_ddiscfactor, n, nb_bisect, nb_newton, stream)
FAST_IV_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_void_p]
# float64 operations a slot, counted from csrc/fast_iv.cu (a libm call or a division one):
# the bracket, the dummy price, the midpoint and the rule's inputs; a bisection stage; a
# Newton stage
FAST_IV_FLOPS = (426, 74, 84)


def _f64(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def as_option_codes(optiontypes, device: torch.device) -> torch.Tensor:
    """string option types (or already-encoded ints) as an int8 tensor."""
    if isinstance(optiontypes, torch.Tensor):
        return optiontypes.to(torch.int8)
    arr = np.asarray(optiontypes)
    if arr.dtype.kind in ('U', 'S', 'O'):
        arr = encode_optiontypes(arr)
    return to_device(arr.astype(np.int8), torch.int8, device)


def _is_call(optiontypes, device: torch.device) -> torch.Tensor:
    """bit0 of the option code: True for 'C'/'IC'."""
    return (as_option_codes(optiontypes, device) & 1).to(torch.bool)


def is_intrinsic(ttm: torch.Tensor, vol: torch.Tensor) -> torch.Tensor:
    """True where the option degenerates to intrinsic value."""
    return (ttm <= 0.0) | (vol <= 0.0) | torch.isnan(vol)


def compute_bsm_vanilla_price(forward, strike, ttm, vol, optiontype='C',
                              discfactor=1.0) -> torch.Tensor:
    """BSM forward price with the intrinsic fallback where ttm<=0 or vol<=0/NaN."""
    device = _device_of(forward, strike, ttm, vol)
    forward, strike, ttm, vol = (_f64(a, device) for a in (forward, strike, ttm, vol))
    is_call = _is_call(optiontype, device)
    sgn = torch.where(is_call, 1.0, -1.0).to(forward.dtype)
    intrinsic = torch.clamp(sgn * (forward - strike), min=0.0)

    intr = is_intrinsic(ttm, vol)
    safe_vol = torch.where(intr, 1.0, vol)
    safe_ttm = torch.where(ttm <= 0.0, 1.0, ttm)
    s_ttm = safe_vol * torch.sqrt(safe_ttm)
    d1 = (torch.log(forward / strike) + 0.5 * s_ttm * s_ttm) / s_ttm
    d2 = d1 - s_ttm
    live = discfactor * sgn * (forward * ncdf(sgn * d1) - strike * ncdf(sgn * d2))
    return torch.where(intr, intrinsic, live)


def _safe_d1(forward, strike, ttm, vol):
    """(inputs as float64 tensors, intrinsic mask, safe vol, safe ttm, vol
    sqrt(T), d1) with the intrinsic region's vol and ttm set to 1."""
    device = _device_of(forward, strike, ttm, vol)
    forward, strike, ttm, vol = (_f64(a, device) for a in (forward, strike, ttm, vol))
    intr = is_intrinsic(ttm, vol)
    safe_vol = torch.where(intr, 1.0, vol)
    safe_ttm = torch.where(ttm <= 0.0, 1.0, ttm)
    s_t = safe_vol * torch.sqrt(safe_ttm)
    d1 = torch.log(forward / strike) / s_t + 0.5 * s_t
    return (forward, strike, ttm, vol), intr, safe_vol, safe_ttm, s_t, d1


def compute_bsm_vanilla_vega(ttm, forward, strike, vol, optiontype=None) -> torch.Tensor:
    """BSM vega = F n(d1) sqrt(T), zero in the intrinsic region."""
    (forward, _, _, _), intr, _, safe_ttm, _, d1 = _safe_d1(forward, strike, ttm, vol)
    return torch.where(intr, 0.0, forward * npdf(d1) * torch.sqrt(safe_ttm))


compute_bsm_vanilla_price_vector = compute_bsm_vanilla_price
compute_bsm_vanilla_vega_vector = compute_bsm_vanilla_vega


def compute_bsm_vanilla_slice_prices(ttm, forward, strikes, vols, optiontypes,
                                     discfactor=1.0) -> torch.Tensor:
    """prices of one maturity slice, over its strikes."""
    return compute_bsm_vanilla_price(forward=forward, strike=strikes, ttm=ttm, vol=vols,
                                     optiontype=optiontypes, discfactor=discfactor)


def compute_bsm_forward_grid_prices(ttm, forwards, strike, vol, optiontype,
                                    discfactor=1.0) -> torch.Tensor:
    """prices over a grid of forwards at one strike."""
    return compute_bsm_vanilla_price(forward=forwards, strike=strike, ttm=ttm, vol=vol,
                                     optiontype=optiontype, discfactor=discfactor)


def compute_bsm_vanilla_delta(ttm, forward, strike, vol, optiontype,
                              discfactor=1.0) -> torch.Tensor:
    """BSM delta: +-N(d1) for vanilla codes, 0 for inverse codes, the
    intrinsic step where ttm <= 0 or vol <= 0/NaN."""
    (forward, strike, ttm, vol), intr, _, _, _, d1 = _safe_d1(forward, strike, ttm, vol)
    codes = as_option_codes(optiontype, forward.device)
    is_call = (codes & 1).to(torch.bool)
    is_inverse = (codes & 2).to(torch.bool)
    one, zero = torch.ones_like(d1), torch.zeros_like(d1)
    intrinsic_delta = torch.where(is_call, torch.where(forward >= strike, one, zero),
                                  torch.where(forward <= strike, -one, zero))
    d1_sign = torch.where(is_inverse, 0.0, torch.where(is_call, 1.0, -1.0)).to(torch.float64)
    live = discfactor * d1_sign * ncdf(d1_sign * d1)
    return torch.where(intr, intrinsic_delta, live)


compute_bsm_vanilla_delta_vector = compute_bsm_vanilla_delta


def compute_bsm_vanilla_slice_deltas(ttm, forward, strikes, vols, optiontypes,
                                     discfactor=1.0) -> torch.Tensor:
    """deltas of one maturity slice, over its strikes."""
    return compute_bsm_vanilla_delta(forward=forward, strike=strikes, ttm=ttm, vol=vols,
                                     optiontype=optiontypes, discfactor=discfactor)


def compute_bsm_vanilla_grid_deltas(ttm, forwards, strike, vol, optiontype,
                                    discfactor=1.0) -> torch.Tensor:
    """deltas over a grid of forwards at one strike."""
    return compute_bsm_vanilla_delta(forward=forwards, strike=strike, ttm=ttm, vol=vol,
                                     optiontype=optiontype, discfactor=discfactor)


def compute_bsm_vanilla_slice_vegas(ttm, forward, strikes, vols,
                                    optiontypes=None) -> torch.Tensor:
    """vegas of one maturity slice, over its strikes."""
    return compute_bsm_vanilla_vega(forward=forward, strike=strikes, ttm=ttm, vol=vols,
                                    optiontype=optiontypes)


compute_bsm_slice_vegas = compute_bsm_vanilla_slice_vegas


def compute_bsm_vanilla_gamma(ttm, forward, strike, vol) -> torch.Tensor:
    """BSM gamma = n(d1) / (F vol sqrt(T)), zero in the intrinsic region."""
    (forward, _, _, _), intr, _, _, s_t, d1 = _safe_d1(forward, strike, ttm, vol)
    return torch.where(intr, 0.0, npdf(d1) / (forward * s_t))


compute_bsm_vanilla_gamma_vector = compute_bsm_vanilla_gamma


def compute_bsm_vanilla_theta(ttm, forward, strike, vol, optiontype, discfactor=1.0,
                              discount_rate=0.0) -> torch.Tensor:
    """BSM theta, with the decay term -df F n(d1) vol / (2 sqrt(T)) and the
    rate term of a call (-r df K N(d2)) or a put (+r df K N(-d2))."""
    (forward, strike, _, _), intr, safe_vol, safe_ttm, s_t, d1 = _safe_d1(
        forward, strike, ttm, vol)
    is_call = _is_call(optiontype, forward.device)
    d2 = d1 - s_t
    decay = -discfactor * forward * npdf(d1) * safe_vol / (2.0 * torch.sqrt(safe_ttm))
    rate_term = torch.where(is_call, -discount_rate * discfactor * strike * ncdf(d2),
                            discount_rate * discfactor * strike * ncdf(-d2))
    return torch.where(intr, 0.0, decay + rate_term)


compute_bsm_vanilla_theta_vector = compute_bsm_vanilla_theta


def compute_bsm_strike_from_delta(ttm, forward, delta, vol) -> torch.Tensor:
    """the strike at which the BSM call delta (delta > 0) or put delta
    (delta < 0) equals ``delta``."""
    device = _device_of(delta, forward, ttm, vol)
    delta, ttm, vol = (_f64(a, device) for a in (delta, ttm, vol))
    inv_delta = torch.where(delta > 0.0, norm_ppf(torch.abs(delta)), -norm_ppf(torch.abs(delta)))
    s_t = vol * torch.sqrt(ttm)
    return forward * torch.exp(-s_t * (inv_delta - 0.5 * s_t))


def _digital_d2(forward, strike, ttm, vol):
    """(inputs, intrinsic mask, vol sqrt(T), d2) of the cash digital."""
    device = _device_of(forward, strike, ttm, vol)
    forward, strike, ttm, vol = (_f64(a, device) for a in (forward, strike, ttm, vol))
    intr = is_intrinsic(ttm, vol)
    safe_vol = torch.where(intr, 1.0, vol)
    safe_ttm = torch.where(ttm <= 0.0, 1.0, ttm)
    s_ttm = safe_vol * torch.sqrt(safe_ttm)
    d2 = (torch.log(forward / strike) + 0.5 * s_ttm * s_ttm) / s_ttm - s_ttm
    return (forward, strike), intr, s_ttm, d2


def compute_bsm_digital_price(forward, strike, ttm, vol, optiontype='C',
                              discfactor=1.0) -> torch.Tensor:
    """cash digital price df N(+-d2), the indicator where ttm <= 0 or vol <= 0/NaN."""
    (forward, strike), intr, _, d2 = _digital_d2(forward, strike, ttm, vol)
    is_call = _is_call(optiontype, forward.device)
    one, zero = torch.ones_like(d2), torch.zeros_like(d2)
    intrinsic = torch.where(is_call, torch.where(forward >= strike, one, zero),
                            torch.where(forward <= strike, one, zero))
    live = discfactor * torch.where(is_call, ncdf(d2), ncdf(-d2))
    return torch.where(intr, intrinsic, live)


def compute_bsm_digital_delta(forward, strike, ttm, vol, optiontype='C',
                              discfactor=1.0) -> torch.Tensor:
    """cash digital delta +-df n(d2) / (F vol sqrt(T)), zero in the intrinsic region."""
    (forward, _), intr, s_ttm, d2 = _digital_d2(forward, strike, ttm, vol)
    is_call = _is_call(optiontype, forward.device)
    pnorm = discfactor / (forward * s_ttm)
    live = torch.where(is_call, pnorm * npdf(d2), -pnorm * npdf(d2))
    return torch.where(intr, 0.0, live)


def frozen_bisection(price_at, given_price, lower: float, upper: float, iters: int, tol: float):
    """the reference bisection for price_at(vol) = given_price on [lower,
    upper], on whole tensors: ``iters`` halvings, each element frozen once
    its |price error| falls below ``tol`` (the reference's early break).
    Returns (last midpoint, price error at ``lower``, bracketed mask)."""
    x1 = torch.full_like(given_price, lower)
    x2 = torch.full_like(given_price, upper)
    f = price_at(x1) - given_price
    fmid = price_at(x2) - given_price
    bracketed = f * fmid < 0.0
    rtb = torch.where(f < 0.0, x1, x2)
    dx = torch.where(f < 0.0, x2 - x1, x1 - x2)
    xmid = rtb
    done = torch.zeros_like(bracketed)
    for _ in range(iters):
        dx_new = dx * 0.5
        xmid_new = rtb + dx_new
        fmid_new = price_at(xmid_new) - given_price
        rtb_new = torch.where(fmid_new <= 0.0, xmid_new, rtb)
        upd = ~done
        rtb = torch.where(upd, rtb_new, rtb)
        dx = torch.where(upd, dx_new, dx)
        xmid = torch.where(upd, xmid_new, xmid)
        done = done | (torch.abs(fmid_new) < tol)
    return xmid, f, bracketed


def bisection_nan_at_bounds(price_at, given_price, lower: float, upper: float, iters: int,
                            tol: float) -> torch.Tensor:
    """:func:`frozen_bisection`, with an unbracketed quote at its nearer
    bound and any result within ``tol`` of a bound set to NaN."""
    xmid, f, bracketed = frozen_bisection(price_at, given_price, lower, upper, iters, tol)
    x1, x2 = torch.full_like(given_price, lower), torch.full_like(given_price, upper)
    v1 = torch.where(bracketed, xmid, torch.where(f < 0.0, x1, x2))
    at_bounds = (torch.abs(v1 - x1) < tol) | (torch.abs(v1 - x2) < tol)
    return torch.where(at_bounds, torch.nan, v1)


def _bisection_impl(given_price, forward, strike, ttm, discfactor, is_call_f):
    """the reference's 200-step bisection on [0.01, 5.0] on whole tensors
    (all of one shape); ``is_call_f`` is 1.0 for calls and -1.0 for puts."""
    def price_at(vol):
        sgn = is_call_f
        s_ttm = vol * torch.sqrt(ttm)
        d1 = (torch.log(forward / strike) + 0.5 * s_ttm * s_ttm) / s_ttm
        d2 = d1 - s_ttm
        return discfactor * sgn * (forward * ncdf(sgn * d1) - strike * ncdf(sgn * d2))

    return bisection_nan_at_bounds(price_at, given_price, IV_LOWER, IV_UPPER, 200, IV_TOL)


def _bisection(given_price, forward, strike, ttm, discfactor, is_call_f) -> torch.Tensor:
    """``_bisection_impl``, through its captured graph on a CUDA device."""
    inputs = (given_price, forward, strike, ttm, discfactor, is_call_f)
    if not graphs.use_graph(given_price):
        return _bisection_impl(*inputs)
    key = (tuple(given_price.shape), str(given_price.device))
    return graphs.run_captured("bisection", key, lambda *a: (_bisection_impl(*a),), inputs)[0]


def _ncdf_slope(x: torch.Tensor) -> torch.Tensor:
    """d ncdf / dx of the erfcc approximation itself (not the normal density):
    what automatic differentiation of :func:`ncdf` gives."""
    u = x / math.sqrt(2.0)
    z = torch.abs(u)
    t = 1.0 / (1.0 + 0.5 * z)
    # Horner for q(t) = c1 + c2 t + ... + c9 t^8 and its derivative q'(t)
    q, dq = torch.full_like(t, ERFCC_COEFFS[-1]), torch.zeros_like(t)
    for c in reversed(ERFCC_COEFFS[1:-1]):
        dq = dq * t + q
        q = q * t + c
    e = torch.exp(-z * z + ERFCC_COEFFS[0] + t * q)
    dt_dz = -0.5 * t * t
    dr_dz = dt_dz * e + t * e * (-2.0 * z + (q + t * dq) * dt_dz)
    # erfcc is r(|u|) for u > 0 and 2 - r(|u|) below, so d erfcc / du = dr/dz
    return -0.5 * dr_dz / math.sqrt(2.0)


def _price_partials(forward, strike, ttm, discfactor, vol, sgn):
    """(dP/dF, dP/dK, dP/dT, dP/d df, dP/d vol) of the forward price
    P = df sgn (F N(sgn d1) - K N(sgn d2)), N the erfcc normal CDF, at
    ``vol``: the gradients that the JAX package takes with ``jax.grad`` of
    that price in its implicit-function rules."""
    sq = torch.sqrt(ttm)
    s = vol * sq
    x = torch.log(forward / strike)
    d1 = (x + 0.5 * s * s) / s
    d2 = d1 - s
    n1, n2 = ncdf(sgn * d1), ncdf(sgn * d2)
    g1, g2 = _ncdf_slope(sgn * d1), _ncdf_slope(sgn * d2)
    # d d1/dx = d d2/dx = 1/s; d d1/ds = 1/2 - x/s^2; d d2/ds = d d1/ds - 1; sgn^2 = 1
    dp_dx = discfactor * (forward * g1 - strike * g2) / s
    dd1_ds = 0.5 - x / (s * s)
    dp_ds = discfactor * (forward * g1 * dd1_ds - strike * g2 * (dd1_ds - 1.0))
    dp_df = discfactor * sgn * n1 + dp_dx / forward
    dp_dk = -discfactor * sgn * n2 - dp_dx / strike
    dp_dt = dp_ds * vol * 0.5 / sq
    dp_ddisc = sgn * (forward * n1 - strike * n2)
    return dp_df, dp_dk, dp_dt, dp_ddisc, dp_ds * sq


def _inverse_vega_and_partials(vol, forward, strike, ttm, discfactor, sgn, vega_floor):
    """(1/vega, 0 where vol is NaN or |vega| < vega_floor) and the price
    partials in F, K, T and df, at the safe vol (1 where vol is NaN)."""
    safe_vol = torch.where(torch.isnan(vol), 1.0, vol)
    dp_df, dp_dk, dp_dt, dp_ddisc, vega = _price_partials(
        forward, strike, ttm, discfactor, safe_vol, sgn)
    inv_vega = torch.where(torch.isnan(vol) | (torch.abs(vega) < vega_floor), 0.0, 1.0 / vega)
    return inv_vega, (dp_df, dp_dk, dp_dt, dp_ddisc)


class _ImpliedVolCore(torch.autograd.Function):
    """the 200-step bisection with the implicit-function gradient in reverse
    mode.  Its forward replays a captured graph on the card, which cannot run
    inside a ``torch.func`` transform: this Function defines no vmap rule and
    no forward-mode rule, so such a transform raises."""

    @staticmethod
    def forward(ctx, given_price, forward, strike, ttm, discfactor, is_call_f):
        vol = _bisection(given_price, forward, strike, ttm, discfactor, is_call_f)
        ctx.save_for_backward(vol, forward, strike, ttm, discfactor, is_call_f)
        return vol

    @staticmethod
    def backward(ctx, grad):
        vol, forward, strike, ttm, discfactor, sgn = ctx.saved_tensors
        inv_vega, partials = _inverse_vega_and_partials(vol, forward, strike, ttm,
                                                         discfactor, sgn, 1e-300)
        gv = grad * inv_vega
        return (gv,) + tuple(-gv * d for d in partials) + (None,)


def _fast_iv_impl(given_price, forward, strike, ttm, discfactor, sgn,
                  nb_bisect: int, nb_newton: int) -> torch.Tensor:
    """a short bisection on [0.01, 5.0] and a Newton polish, NaN where the
    price is not bracketed (the JAX package's ``_fast_iv_impl``)."""
    def price_at(vol):
        s_ttm = vol * torch.sqrt(ttm)
        d1 = (torch.log(forward / strike) + 0.5 * s_ttm * s_ttm) / s_ttm
        d2 = d1 - s_ttm
        return discfactor * sgn * (forward * ncdf(sgn * d1) - strike * ncdf(sgn * d2))

    lo = torch.full_like(given_price, IV_LOWER)
    hi = torch.full_like(given_price, IV_UPPER)
    bracketed = (price_at(lo) - given_price) * (price_at(hi) - given_price) < 0.0
    # unbracketed (or NaN) quotes are replaced by a solvable dummy before the
    # solver, so no NaN circulates; their output is NaN all the same
    given_price = torch.where(bracketed, given_price, price_at(torch.ones_like(lo)))
    f_lo = price_at(lo) - given_price
    for _ in range(nb_bisect):
        mid = 0.5 * (lo + hi)
        go_up = (price_at(mid) - given_price) * f_lo > 0.0   # same sign as lo: root above
        lo, hi = torch.where(go_up, mid, lo), torch.where(go_up, hi, mid)
    vol = 0.5 * (lo + hi)
    for _ in range(nb_newton):
        s_ttm = vol * torch.sqrt(ttm)
        d1 = torch.log(forward / strike) / s_ttm + 0.5 * s_ttm
        vega = discfactor * forward * npdf(d1) * torch.sqrt(ttm)
        step = (price_at(vol) - given_price) / torch.clamp(vega, min=1e-12)
        vol = torch.clamp(vol - step, IV_LOWER, IV_UPPER)
    return torch.where(bracketed, vol, torch.nan)


def _implicit_tangent(inv_vega, partials, d_price, d_inputs):
    """the rule's forward mode: (dP - sum dP/dx dx) / vega over the inputs
    (F, K, T, df) that carry a tangent."""
    dvol = d_price if d_price is not None else torch.zeros_like(inv_vega)
    for d, partial in zip(d_inputs, partials):
        if d is not None:
            dvol = dvol - partial * d
    return inv_vega * dvol


def _implicit_cotangents(inv_vega, partials, grad):
    """the rule's reverse mode: the cotangents of (price, F, K, T, df)."""
    gv = grad * inv_vega
    return (gv,) + tuple(-gv * d for d in partials)


class _FastIVCore(torch.autograd.Function):
    """the fast implied vol with the implicit-function tangent rule

        dvol = (dP - dP/dF dF - dP/dK dK - dP/dT dT - dP/d df d df) / vega,

    vega floored at 1e-12 x forward (0 where the vol is NaN), in forward mode
    (``jvp``) and transposed in reverse mode (``backward``).  Differentiating
    through the Newton polish instead would compound 1/vega four times.  The
    plain version, for CPU panels: the rule's inputs are computed from the
    saved vol in each pass."""
    generate_vmap_rule = True

    @staticmethod
    def forward(given_price, forward, strike, ttm, discfactor, sgn, nb_bisect, nb_newton):
        return _fast_iv_impl(given_price, forward, strike, ttm, discfactor, sgn,
                             nb_bisect, nb_newton)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, forward, strike, ttm, discfactor, sgn, _, _ = inputs
        ctx.save_for_forward(output, forward, strike, ttm, discfactor, sgn)
        ctx.save_for_backward(output, forward, strike, ttm, discfactor, sgn)

    @staticmethod
    def _rule(ctx):
        vol, forward, strike, ttm, discfactor, sgn = ctx.saved_tensors
        return _inverse_vega_and_partials(vol, forward, strike, ttm, discfactor, sgn,
                                          1e-12 * forward)

    @staticmethod
    def jvp(ctx, d_price, d_forward, d_strike, d_ttm, d_disc, _d_sgn, _nb_bisect, _nb_newton):
        inv_vega, partials = _FastIVCore._rule(ctx)
        return _implicit_tangent(inv_vega, partials, d_price, (d_forward, d_strike, d_ttm, d_disc))

    @staticmethod
    def backward(ctx, grad):
        inv_vega, partials = _FastIVCore._rule(ctx)
        return _implicit_cotangents(inv_vega, partials, grad) + (None, None, None)


def fast_iv_cuda(given_price, forward, strike, ttm, discfactor, sgn, nb_bisect: int = 24,
                 nb_newton: int = 4):
    """:func:`_fast_iv_impl` by ``csrc/fast_iv.cu``: (vol, 1 / vega, dP/dF,
    dP/dK, dP/dT, dP/d df), float64 CUDA tensors of the inputs' shape without
    gradient; the last five are :func:`_inverse_vega_and_partials` at the vol
    with the vega floor 1e-12 x forward, the tangent rule's inputs.

    Six float64 tensors of one shape, contiguous, on one CUDA device (``sgn``
    1.0 for a call, -1.0 for a put).  Launches one kernel on the current
    stream without synchronising (none for an empty panel); anything else, or
    a refused launch, raises.  Counts: ``fast_iv_cuda.launches``.
    """
    inputs = (given_price, forward, strike, ttm, discfactor, sgn)
    if any(x.dtype != torch.float64 for x in inputs):
        raise TypeError(f"the fast IV kernel takes float64 tensors, got "
                        f"{[str(x.dtype) for x in inputs]}")
    shape = given_price.shape
    if any(x.shape != shape for x in inputs):
        raise ValueError(f"the fast IV kernel takes tensors of one shape, got "
                         f"{[tuple(x.shape) for x in inputs]}")
    if not all(x.is_contiguous() for x in inputs):
        raise ValueError("the fast IV kernel takes contiguous tensors")
    nb_slots = given_price.numel()
    if not (nb_slots < 2 ** 31 and all(isinstance(k, int) and 0 <= k < 2 ** 31
                                       for k in (nb_bisect, nb_newton))):
        raise ValueError(f"the fast IV kernel takes under 2^31 slots and stage counts, got "
                         f"{nb_slots} slots, {nb_bisect} and {nb_newton} stages")
    if given_price.device.type != "cuda":
        raise ValueError(f"the fast IV kernel needs CUDA tensors, got {given_price.device}")
    if any(x.device != given_price.device for x in inputs):
        raise ValueError("the fast IV kernel's inputs must be on one device")
    outputs = tuple(torch.empty_like(given_price) for _ in range(6))
    if nb_slots == 0:
        return outputs
    launch = _launcher("fast_iv", FAST_IV_ARGTYPES)
    with torch.cuda.device(given_price.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(*(x.data_ptr() for x in inputs + outputs), nb_slots, nb_bisect, nb_newton,
                     stream)
    _raise_on_error("fast_iv", err)
    fast_iv_cuda.launches += 1
    return outputs


fast_iv_cuda.launches = 0


class _FastIVKernel(torch.autograd.Function):
    """:class:`_FastIVCore` on a CUDA panel: one kernel launch gives the vol
    and the tangent rule's inputs (1/vega and the four price partials), which
    the ``jvp`` and ``backward`` rules combine with the input tangents or the
    output's cotangent; the ``vmap`` rule folds a vmapped batch into the
    kernel's slot axis (one launch a batch).  Outputs (vol, 1/vega, dP/dF,
    dP/dK, dP/dT, dP/d df); only the vol is differentiable."""

    @staticmethod
    def forward(given_price, forward, strike, ttm, discfactor, sgn, nb_bisect, nb_newton):
        return fast_iv_cuda(*(x.contiguous() for x in (given_price, forward, strike, ttm,
                                                       discfactor, sgn)),
                            nb_bisect, nb_newton)

    @staticmethod
    def setup_context(ctx, inputs, output):
        rule = output[1:]
        ctx.mark_non_differentiable(*rule)
        ctx.save_for_forward(*rule)
        ctx.save_for_backward(*rule)

    @staticmethod
    def jvp(ctx, d_price, d_forward, d_strike, d_ttm, d_disc, _d_sgn, _nb_bisect, _nb_newton):
        inv_vega, *partials = ctx.saved_tensors
        dvol = _implicit_tangent(inv_vega, partials, d_price, (d_forward, d_strike, d_ttm, d_disc))
        return (dvol,) + (None,) * 5

    @staticmethod
    def backward(ctx, grad, *_rule_grads):
        inv_vega, *partials = ctx.saved_tensors
        return _implicit_cotangents(inv_vega, partials, grad) + (None, None, None)

    @staticmethod
    def vmap(info, in_dims, given_price, forward, strike, ttm, discfactor, sgn, nb_bisect,
             nb_newton):
        tensors = (given_price, forward, strike, ttm, discfactor, sgn)
        out = _FastIVKernel.apply(*(_batch_first(x, d, info.batch_size)
                                    for x, d in zip(tensors, in_dims)), nb_bisect, nb_newton)
        return out, (0,) * len(out)


def _takes_kernel(given_price: torch.Tensor) -> bool:
    return given_price.is_cuda


def _broadcast_inputs(forward, ttm, strike, given_price, discfactor, optiontype):
    """the inputs as float64 tensors of one broadcast shape on one device,
    and the option signs (1.0 for calls, -1.0 for puts)."""
    device = _device_of(given_price, forward, strike, ttm, discfactor)
    given_price, forward, strike, ttm, discfactor = (
        _f64(a, device) for a in (given_price, forward, strike, ttm, discfactor))
    is_call = _is_call(optiontype, device)
    shape = torch.broadcast_shapes(given_price.shape, forward.shape, strike.shape,
                                   ttm.shape, discfactor.shape, is_call.shape)
    b = lambda x: x.to(torch.float64).expand(shape)
    sgn = torch.where(is_call, 1.0, -1.0).to(torch.float64).expand(shape)
    return tuple(b(a) for a in (given_price, forward, strike, ttm, discfactor)) + (sgn,)


def _implicit_newton(vol, given_price, forward, strike, ttm, discfactor, sgn) -> torch.Tensor:
    """two Newton steps on P(vol) = price from the solved ``vol``, with the
    exact vega of the erfcc price; NaN where ``vol`` is NaN, and no step
    where |vega| < 1e-12 x forward.  The value is ``vol`` to rounding; its
    first and second derivatives in every input are those of the implicit
    function (a Newton step's derivative in its start vanishes at the root,
    so two steps carry both orders), which is what nested ``torch.func.jvp``
    needs: torch does not differentiate a custom Function's ``jvp`` rule
    again, as JAX differentiates its ``custom_jvp`` rule."""
    nan = torch.isnan(vol)
    v = torch.where(nan, 1.0, vol)
    floor = 1e-12 * forward
    for _ in range(2):
        s_ttm = v * torch.sqrt(ttm)
        d1 = (torch.log(forward / strike) + 0.5 * s_ttm * s_ttm) / s_ttm
        price = discfactor * sgn * (forward * ncdf(sgn * d1) - strike * ncdf(sgn * (d1 - s_ttm)))
        vega = _price_partials(forward, strike, ttm, discfactor, v, sgn)[4]
        flat = torch.abs(vega) < floor
        v = v - torch.where(flat, 0.0, (price - given_price) / torch.where(flat, 1.0, vega))
    return torch.where(nan, torch.nan, v)


def infer_bsm_implied_vol_fast(forward, ttm, strike, given_price, discfactor=1.0,
                               optiontype='C', nb_bisect: int = 24,
                               nb_newton: int = 4, higher_order: bool = False) -> torch.Tensor:
    """fast implied vol: a 24-step bisection bracket and a 4-step Newton polish.

    ~7x fewer sequential stages than :func:`infer_bsm_implied_vol`, for
    calibration objectives; NaN where the price is not bracketed.  Its
    derivatives come from the implicit function theorem (1/vega), in forward
    and reverse mode, so ``torch.func.jacfwd``, ``vmap`` and ``backward`` go
    through it.  ``higher_order=True`` (for nested forward-mode, e.g. gamma
    in vol space) takes the derivatives of :func:`_implicit_newton` from the
    solved vol instead, which are exact to second order.  A CUDA panel is
    solved by one launch of ``csrc/fast_iv.cu`` (:class:`_FastIVKernel`), a
    CPU one by the torch ops (:class:`_FastIVCore`).
    """
    inputs = _broadcast_inputs(forward, ttm, strike, given_price, discfactor, optiontype)
    stages = (int(nb_bisect), int(nb_newton))
    if _takes_kernel(inputs[0]):
        vol = _FastIVKernel.apply(*inputs, *stages)[0]
        # the Newton steps below carry both orders from any start at the root
        return _implicit_newton(vol.detach(), *inputs) if higher_order else vol
    if higher_order:
        return _implicit_newton(_fast_iv_impl(*inputs, *stages), *inputs)
    return _FastIVCore.apply(*inputs, *stages)


def infer_bsm_implied_vol(forward, ttm, strike, given_price, discfactor=1.0,
                          optiontype='C', tol: float = 1e-16,
                          is_bounds_to_nan: bool = True) -> torch.Tensor:
    """Black implied vol by the reference bisection on [0.01, 5.0].

    ``tol`` is accepted for signature parity; the fixed 200 iterations exceed
    any representable tolerance.  With ``is_bounds_to_nan`` (the default)
    out-of-bracket prices give NaN; otherwise they clamp to the violated bound.
    The vol is differentiable in reverse mode in price, forward, strike, ttm
    and discount factor (the implicit-function rule, 0 at NaN vols).
    """
    del tol
    inputs = _broadcast_inputs(forward, ttm, strike, given_price, discfactor, optiontype)
    res = _ImpliedVolCore.apply(*inputs)
    if not is_bounds_to_nan:
        given_price, forward, strike, ttm, discfactor, _ = inputs
        p_low = compute_bsm_vanilla_price(forward=forward, strike=strike, ttm=ttm,
                                          vol=torch.full_like(ttm, 0.01),
                                          optiontype=optiontype, discfactor=discfactor)
        unbracketed = torch.isnan(res) & torch.isfinite(given_price)
        bound = torch.where(given_price <= p_low, torch.full_like(res, IV_LOWER),
                            torch.full_like(res, IV_UPPER))
        res = torch.where(unbracketed, bound, res)
    return res


def infer_bsm_ivols_from_model_slice_prices(ttm, forward, strikes, optiontypes, model_prices,
                                            discfactor) -> torch.Tensor:
    """implied vols of one maturity slice."""
    return infer_bsm_implied_vol(forward=forward, ttm=ttm, strike=strikes,
                                 given_price=model_prices, discfactor=discfactor,
                                 optiontype=optiontypes)


def infer_bsm_ivols_from_slice_prices(ttm, forward, discfactor, strikes, optiontypes,
                                      model_prices) -> torch.Tensor:
    """:func:`infer_bsm_ivols_from_model_slice_prices` with the discount
    factor third, as the reference orders it."""
    return infer_bsm_ivols_from_model_slice_prices(
        ttm=ttm, forward=forward, strikes=strikes, optiontypes=optiontypes,
        model_prices=model_prices, discfactor=discfactor)


def compute_bsm_vanilla_deltas_ttms(ttms, forwards, strikes_ttms, vols_ttms,
                                    optiontypes_ttms, device="cuda") -> list:
    """deltas of a ragged chain, one numpy array per slice."""
    host = lambda a: _f64(a, torch.device(device))
    return [compute_bsm_vanilla_delta(ttm=host(t), forward=host(f), strike=host(s),
                                      vol=host(v), optiontype=o).cpu().numpy()
            for t, f, s, v, o in zip(ttms, forwards, strikes_ttms, vols_ttms, optiontypes_ttms)]


def compute_bsm_vegas_ttms(ttms, forwards, strikes_ttms, vols_ttms, optiontypes_ttms=None,
                           device="cuda") -> list:
    """vegas of a ragged chain, one numpy array per slice."""
    host = lambda a: _f64(a, torch.device(device))
    return [compute_bsm_vanilla_vega(ttm=host(t), forward=host(f), strike=host(s),
                                     vol=host(v)).cpu().numpy()
            for t, f, s, v in zip(ttms, forwards, strikes_ttms, vols_ttms)]


compute_bsm_vanilla_vegas_ttms = compute_bsm_vegas_ttms


def infer_bsm_ivols_from_model_chain_prices(ttms, forwards, discfactors, strikes_ttms,
                                            optiontypes_ttms, model_prices_ttms
                                            ) -> torch.Tensor:
    """chain-level inversion over a padded (n_ttm, max_strikes) panel.

    ttms/forwards/discfactors: (T,); strikes/optiontypes/prices: (T, K).
    Returns a (T, K) panel of implied vols (NaN on unbracketed slots).
    """
    device = _device_of(model_prices_ttms, strikes_ttms, ttms)
    ttms, forwards, discfactors = (_f64(a, device)[:, None]
                                   for a in (ttms, forwards, discfactors))
    return infer_bsm_implied_vol(forward=forwards, ttm=ttms, strike=strikes_ttms,
                                 given_price=model_prices_ttms, discfactor=discfactors,
                                 optiontype=optiontypes_ttms)
