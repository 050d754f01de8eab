"""
Black-Scholes-Merton prices, vegas and implied volatilities on tensors.

PyTorch counterpart of ``stochvolmodels_tpu/ops/bsm.py``.  Every function is
elementwise over broadcastable tensors.  Implied volatility is the reference's
200-iteration bisection on [0.01, 5.0] with NaN at the bounds, run on whole
panels with a frozen-when-done mask.  Float inputs and numpy arrays become
float64 tensors on the device of the first tensor argument (the card if none).
"""
from __future__ import annotations


import numpy as np
import torch

from stochvolmodels_torch.config import encode_optiontypes
from stochvolmodels_torch.ops.gauss import ncdf, npdf

IV_LOWER, IV_UPPER, IV_TOL = 0.01, 5.0, 1e-16


def _device_of(*xs) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cuda")


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
    return torch.as_tensor(arr.astype(np.int8), device=device)


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


def compute_bsm_vanilla_vega(ttm, forward, strike, vol, optiontype=None) -> torch.Tensor:
    """BSM vega = F n(d1) sqrt(T), zero in the intrinsic region."""
    device = _device_of(forward, strike, ttm, vol)
    forward, strike, ttm, vol = (_f64(a, device) for a in (forward, strike, ttm, vol))
    intr = is_intrinsic(ttm, vol)
    safe_vol = torch.where(intr, 1.0, vol)
    safe_ttm = torch.where(ttm <= 0.0, 1.0, ttm)
    s_t = safe_vol * torch.sqrt(safe_ttm)
    d1 = torch.log(forward / strike) / s_t + 0.5 * s_t
    vega = forward * npdf(d1) * torch.sqrt(safe_ttm)
    return torch.where(intr, 0.0, vega)


def _bisection_impl(given_price, forward, strike, ttm, discfactor, is_call_f):
    """the reference bisection on whole tensors (all of one shape).

    ``is_call_f`` is 1.0 for calls and -1.0 for puts.  Each element stops
    moving once its |price error| falls below the tolerance, mirroring the
    reference's early break.
    """
    def price_at(vol):
        sgn = is_call_f
        s_ttm = vol * torch.sqrt(ttm)
        d1 = (torch.log(forward / strike) + 0.5 * s_ttm * s_ttm) / s_ttm
        d2 = d1 - s_ttm
        return discfactor * sgn * (forward * ncdf(sgn * d1) - strike * ncdf(sgn * d2))

    x1 = torch.full_like(given_price, IV_LOWER)
    x2 = torch.full_like(given_price, IV_UPPER)
    f = price_at(x1) - given_price
    fmid = price_at(x2) - given_price
    bracketed = f * fmid < 0.0

    rtb = torch.where(f < 0.0, x1, x2)
    dx = torch.where(f < 0.0, x2 - x1, x1 - x2)
    xmid = rtb
    done = torch.zeros_like(bracketed)
    for _ in range(200):
        dx_new = dx * 0.5
        xmid_new = rtb + dx_new
        fmid_new = price_at(xmid_new) - given_price
        rtb_new = torch.where(fmid_new <= 0.0, xmid_new, rtb)
        upd = ~done
        rtb = torch.where(upd, rtb_new, rtb)
        dx = torch.where(upd, dx_new, dx)
        xmid = torch.where(upd, xmid_new, xmid)
        done = done | (torch.abs(fmid_new) < IV_TOL)

    v1 = torch.where(bracketed, xmid, torch.where(f < 0.0, x1, x2))
    at_bounds = (torch.abs(v1 - x1) < IV_TOL) | (torch.abs(v1 - x2) < IV_TOL)
    return torch.where(at_bounds, torch.nan, v1)


def infer_bsm_implied_vol(forward, ttm, strike, given_price, discfactor=1.0,
                          optiontype='C', tol: float = 1e-16,
                          is_bounds_to_nan: bool = True) -> torch.Tensor:
    """Black implied vol by the reference bisection on [0.01, 5.0].

    ``tol`` is accepted for signature parity; the fixed 200 iterations exceed
    any representable tolerance.  With ``is_bounds_to_nan`` (the default)
    out-of-bracket prices give NaN; otherwise they clamp to the violated bound.
    """
    del tol
    device = _device_of(given_price, forward, strike, ttm, discfactor)
    given_price, forward, strike, ttm, discfactor = (
        _f64(a, device) for a in (given_price, forward, strike, ttm, discfactor))
    is_call = _is_call(optiontype, device)
    shape = torch.broadcast_shapes(given_price.shape, forward.shape, strike.shape,
                                   ttm.shape, discfactor.shape, is_call.shape)
    b = lambda x: x.to(torch.float64).expand(shape)
    is_call_f = torch.where(is_call, 1.0, -1.0).to(torch.float64).expand(shape)
    res = _bisection_impl(b(given_price), b(forward), b(strike), b(ttm),
                          b(discfactor), is_call_f)
    if not is_bounds_to_nan:
        p_low = compute_bsm_vanilla_price(forward=forward, strike=strike, ttm=ttm,
                                          vol=torch.full_like(b(ttm), 0.01),
                                          optiontype=optiontype, discfactor=discfactor)
        unbracketed = torch.isnan(res) & torch.isfinite(b(given_price))
        bound = torch.where(b(given_price) <= p_low, torch.full_like(res, IV_LOWER),
                            torch.full_like(res, IV_UPPER))
        res = torch.where(unbracketed, bound, res)
    return res


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
