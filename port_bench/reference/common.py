"""
Plain reference pieces shared by the models: the chain panels and weights,
Fourier pricing of vanillas against a log-MGF grid, the fast implied vol and
Levenberg-Marquardt.

Written in plain PyTorch from the published methods (Sepp & Rakhmonov 2024,
Sec. 4-5; Marquardt 1963) and kept in the arithmetic order of the original
StochVolModels code, so that in float64 it reads the same numbers as any
faithful implementation up to rounding.  Every function takes its working
precision as ``dtype`` (float64 for the reference, a lower one for the
control), and takes nothing that a program under test derived: it starts
from the quotes as numpy arrays.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.func import jacfwd

OPTION_CODES = {"P": 0, "C": 1, "IP": 2, "IC": 3}
IV_LOWER, IV_UPPER = 0.01, 5.0
PHI_POINTS = 1000
# Numerical Recipes' rational fit of erfc, as the original code evaluates the normal CDF
ERFCC = (-1.26551223, 1.00002368, 0.37409196, 0.09678418, -0.18628806, 0.27886807,
         -1.13520398, 1.48851587, -0.82215223, 0.17087277)


def scalars(pars: torch.Tensor) -> list:
    """the entries of a parameter vector as (1,) tensors: under forward mode
    torch 2.13 gives 0-dim float32 tensors float64 tangents, and a float32
    control would then mix precisions; the values are the same bits."""
    return [pars[i:i + 1] for i in range(pars.shape[0])]


def complex_of(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


# --------------------------------------------------------------------------
# the chain as padded panels
# --------------------------------------------------------------------------

def pad(ragged: List[np.ndarray], fill: float) -> Tuple[np.ndarray, np.ndarray]:
    """(n_ttm, max_strikes) panel of a ragged list, and its mask."""
    width = max(len(a) for a in ragged)
    out = np.full((len(ragged), width), fill, dtype=np.float64)
    mask = np.zeros((len(ragged), width), dtype=bool)
    for i, a in enumerate(ragged):
        out[i, :len(a)] = a
        mask[i, :len(a)] = True
    return out, mask


def ncdf(x: torch.Tensor) -> torch.Tensor:
    u = x / math.sqrt(2.0)
    z = torch.abs(u)
    t = 1.0 / (1.0 + 0.5 * z)
    q = torch.full_like(t, ERFCC[-1])
    for c in reversed(ERFCC[1:-1]):
        q = q * t + c
    r = t * torch.exp(-z * z + ERFCC[0] + t * q)
    return 1.0 - 0.5 * torch.where(u > 0.0, r, 2.0 - r)


def npdf(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * torch.square(x)) / math.sqrt(2.0 * math.pi)


def bsm_vega_np(ttm: float, forward: float, strikes: np.ndarray, vols: np.ndarray) -> np.ndarray:
    """forward * n(d1) * sqrt(T), in float64 on the host."""
    s_t = vols * np.sqrt(ttm)
    d1 = np.log(forward / strikes) / s_t + 0.5 * s_t
    return forward * (np.exp(-0.5 * d1 * d1) / math.sqrt(2.0 * math.pi)) * np.sqrt(ttm)


def chain_panels(quotes: Dict, weights_unit_ttm: bool = False) -> Dict[str, np.ndarray]:
    """the calibration panels of a quote snapshot (numpy, float64): strikes
    padded with the row forward, call flags, mask, mid vols and the
    slice-normalised vega weights (0 on padded slots), and the ATM vols."""
    ttms, fwds = quotes["ttms"], quotes["forwards"]
    mids = [0.5 * (b + a) for b, a in zip(quotes["bid_ivs"], quotes["ask_ivs"])]
    strikes, mask = pad(quotes["strikes"], np.nan)
    strikes = np.where(mask, strikes, fwds[:, None])
    codes, _ = pad([np.array([OPTION_CODES[str(t)] for t in ts], dtype=np.float64)
                    for ts in quotes["types"]], 1.0)
    vega_ttms = np.ones_like(ttms) if weights_unit_ttm else ttms
    vegas = [bsm_vega_np(t, f, k, v) for t, f, k, v in
             zip(vega_ttms, fwds, quotes["strikes"], mids)]
    weights, _ = pad([v / np.sum(v) for v in vegas], 0.0)
    market, _ = pad(mids, 0.0)
    atm = np.array([np.interp(f, k, v) for f, k, v in zip(fwds, quotes["strikes"], mids)])
    return dict(ttms=np.asarray(ttms, float), forwards=np.asarray(fwds, float),
                discfactors=np.asarray(quotes["discfactors"], float), strikes=strikes,
                is_call=(codes.astype(np.int64) & 1).astype(bool), mask=mask,
                market=np.where(mask, market, 0.0), weights=np.where(mask, weights, 0.0),
                atm=atm)


# --------------------------------------------------------------------------
# Fourier pricing of vanillas (capped payoff, Re phi = -1/2)
# --------------------------------------------------------------------------

def phi_grid(vol_scaler, dtype: torch.dtype, device) -> torch.Tensor:
    """phi = -1/2 + i p, p in [0, 5.6 / vol_scaler] on PHI_POINTS points
    (the end point set exactly); ``vol_scaler`` a 0-dim tensor."""
    div = PHI_POINTS - 1
    stop = torch.full((), 5.6, dtype=dtype, device=device) / vol_scaler.to(dtype)
    step = stop / torch.full((), float(div), dtype=dtype, device=device)
    p = torch.cat([torch.arange(div, dtype=dtype, device=device) * step, stop.reshape(1)])
    return torch.complex(torch.full_like(p, -0.5), p)


def simpson(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """composite Simpson pattern [1, 4, 2, ..., 4] (an even n keeps 4 at the end)."""
    k = torch.arange(n, device=device)
    base = torch.where(k % 2 == 1, 4.0, 2.0).to(dtype)
    ends = (k == 0) | ((k == n - 1) & ((n - 1) % 2 == 0))
    return torch.where(ends, 1.0, base)


def vanilla_prices(log_mgf: torch.Tensor, phi: torch.Tensor, forward: torch.Tensor,
                   strikes: torch.Tensor, is_call: torch.Tensor, discfactor: torch.Tensor
                   ) -> torch.Tensor:
    """one slice's prices (K,) by the capped-payoff inversion of the log-MGF
    (N,) on ``phi`` (N,): drops NaN and overflowing terms."""
    p = phi.imag
    dp = ((p[1] - p[0]) / 3.0) * simpson(p.shape[-1], p.dtype, p.device)
    weights = (dp / math.pi) / (p * p + 0.25)
    x = torch.log(forward / strikes)
    re = -x[:, None] * phi.real + log_mgf.real[None, :]
    im = -x[:, None] * phi.imag + log_mgf.imag[None, :]
    cap = 0.98 * math.log(torch.finfo(re.dtype).max)
    bad = torch.isnan(re) | torch.isnan(im) | (re > cap)
    e = torch.exp(torch.where(bad, 0.0, re))
    term = e * (weights * torch.cos(torch.where(bad, 0.0, im)))
    capped = torch.sum(torch.where(bad | torch.isnan(term), 0.0, term), dim=-1)
    call = discfactor * (forward - strikes * capped)
    put = discfactor * (strikes - strikes * capped)
    return torch.where(is_call, call, put)


# --------------------------------------------------------------------------
# the fast implied vol: 24 bisection steps, 4 Newton steps, implicit tangents
# --------------------------------------------------------------------------

def _price(vol, forward, strike, ttm, discfactor, sgn):
    s_ttm = vol * torch.sqrt(ttm)
    d1 = (torch.log(forward / strike) + 0.5 * s_ttm * s_ttm) / s_ttm
    d2 = d1 - s_ttm
    return discfactor * sgn * (forward * ncdf(sgn * d1) - strike * ncdf(sgn * d2))


def _ncdf_slope(x: torch.Tensor) -> torch.Tensor:
    """d ncdf / dx of the erfcc fit itself."""
    u = x / math.sqrt(2.0)
    z = torch.abs(u)
    t = 1.0 / (1.0 + 0.5 * z)
    q, dq = torch.full_like(t, ERFCC[-1]), torch.zeros_like(t)
    for c in reversed(ERFCC[1:-1]):
        dq = dq * t + q
        q = q * t + c
    e = torch.exp(-z * z + ERFCC[0] + t * q)
    dt_dz = -0.5 * t * t
    dr_dz = dt_dz * e + t * e * (-2.0 * z + (q + t * dq) * dt_dz)
    return -0.5 * dr_dz / math.sqrt(2.0)


def _partials(forward, strike, ttm, discfactor, vol, sgn):
    """(dP/dF, dP/dK, dP/dT, dP/d df, vega) of the erfcc price at ``vol``."""
    sq = torch.sqrt(ttm)
    s = vol * sq
    x = torch.log(forward / strike)
    d1 = (x + 0.5 * s * s) / s
    d2 = d1 - s
    n1, n2 = ncdf(sgn * d1), ncdf(sgn * d2)
    g1, g2 = _ncdf_slope(sgn * d1), _ncdf_slope(sgn * d2)
    dp_dx = discfactor * (forward * g1 - strike * g2) / s
    dd1_ds = 0.5 - x / (s * s)
    dp_ds = discfactor * (forward * g1 * dd1_ds - strike * g2 * (dd1_ds - 1.0))
    return (discfactor * sgn * n1 + dp_dx / forward, -discfactor * sgn * n2 - dp_dx / strike,
            dp_ds * vol * 0.5 / sq, sgn * (forward * n1 - strike * n2), dp_ds * sq)


def _fast_iv(price, forward, strike, ttm, discfactor, sgn):
    lo = torch.full_like(price, IV_LOWER)
    hi = torch.full_like(price, IV_UPPER)
    bracketed = (_price(lo, forward, strike, ttm, discfactor, sgn) - price) * \
        (_price(hi, forward, strike, ttm, discfactor, sgn) - price) < 0.0
    price = torch.where(bracketed, price,
                        _price(torch.ones_like(lo), forward, strike, ttm, discfactor, sgn))
    f_lo = _price(lo, forward, strike, ttm, discfactor, sgn) - price
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        up = (_price(mid, forward, strike, ttm, discfactor, sgn) - price) * f_lo > 0.0
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    vol = 0.5 * (lo + hi)
    for _ in range(4):
        s_ttm = vol * torch.sqrt(ttm)
        d1 = torch.log(forward / strike) / s_ttm + 0.5 * s_ttm
        vega = discfactor * forward * npdf(d1) * torch.sqrt(ttm)
        step = (_price(vol, forward, strike, ttm, discfactor, sgn) - price) / \
            torch.clamp(vega, min=1e-12)
        vol = torch.clamp(vol - step, IV_LOWER, IV_UPPER)
    return torch.where(bracketed, vol, torch.nan)


class FastIV(torch.autograd.Function):
    """the fast implied vol, with d vol = (dP - sum dP/dx dx) / vega in
    forward mode (vega floored at 1e-12 forward, 0 where the vol is NaN)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(price, forward, strike, ttm, discfactor, sgn):
        return _fast_iv(price, forward, strike, ttm, discfactor, sgn)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, forward, strike, ttm, discfactor, sgn = inputs
        ctx.save_for_forward(output, forward, strike, ttm, discfactor, sgn)

    @staticmethod
    def jvp(ctx, d_price, d_forward, d_strike, d_ttm, d_disc, _d_sgn):
        vol, forward, strike, ttm, discfactor, sgn = ctx.saved_tensors
        safe = torch.where(torch.isnan(vol), 1.0, vol)
        *partials, vega = _partials(forward, strike, ttm, discfactor, safe, sgn)
        inv_vega = torch.where(torch.isnan(vol) | (torch.abs(vega) < 1e-12 * forward),
                               0.0, 1.0 / vega)
        dvol = d_price if d_price is not None else torch.zeros_like(inv_vega)
        for d, partial in zip((d_forward, d_strike, d_ttm, d_disc), partials):
            if d is not None:
                dvol = dvol - partial * d
        return inv_vega * dvol


def fast_ivols(prices, forwards, strikes, ttms, discfactors, is_call) -> torch.Tensor:
    """implied vols of a (T, K) price panel; forwards, ttms and discfactors (T,)."""
    shape = prices.shape
    dtype = prices.dtype
    b = lambda a: a.to(dtype).expand(shape)
    sgn = torch.where(is_call, 1.0, -1.0).to(dtype).expand(shape)
    return FastIV.apply(prices, b(forwards[:, None]), b(strikes), b(ttms[:, None]),
                        b(discfactors[:, None]), sgn)


# --------------------------------------------------------------------------
# Levenberg-Marquardt: Marquardt damping, CG solve, box projection
# --------------------------------------------------------------------------

def _cg(A: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = r @ r
    for _ in range(iters):
        Ap = A @ p
        alpha = rs / torch.clamp(p @ Ap, min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = r @ r
        beta = rs_new / torch.clamp(rs, min=1e-30)
        p = r + beta * p
        rs = rs_new
    return x


def levenberg_marquardt(residuals: Callable[[torch.Tensor], torch.Tensor], p0: torch.Tensor,
                        lower: torch.Tensor, upper: torch.Tensor, nb_iters: int,
                        lam0: float = 1e-2) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best parameters, best cost) after ``nb_iters`` damped Gauss-Newton
    iterations, the Jacobian by forward mode; a candidate is taken where it
    lowers the cost, and the damping moves /3 on a success and x4 on a miss."""
    n = p0.shape[0]
    eye = torch.eye(n, dtype=p0.dtype, device=p0.device)
    pars, best = p0, p0
    lam = torch.full((), lam0, dtype=p0.dtype, device=p0.device)
    best_cost = torch.sum(torch.square(residuals(p0)))
    for _ in range(nb_iters):
        J, r = jacfwd(lambda p: (lambda res: (res, res))(residuals(p)), has_aux=True)(pars)
        J = J.to(pars.dtype)   # a clamp's tangent comes back in float64 from float32 inputs
        cost = torch.sum(r * r)
        g = J.T @ r
        JTJ = J.T @ J
        D = torch.diag(torch.clamp(torch.diagonal(JTJ), min=1e-10))
        step = _cg(JTJ + lam * D + 1e-12 * eye, -g, n + 3)
        cand = torch.clamp(pars + step, lower, upper)
        new_cost = torch.sum(torch.square(residuals(cand)))
        accept = new_cost < cost
        pars = torch.where(accept, cand, pars)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-8),
                          torch.clamp(lam * 4.0, max=1e6))
        better = new_cost < best_cost
        best = torch.where(better, cand, best)
        best_cost = torch.where(better, new_cost, best_cost)
    return best, best_cost


def vol_residuals(model_vols: torch.Tensor, market: torch.Tensor, sqrtw: torch.Tensor
                  ) -> torch.Tensor:
    """sqrt-weighted vol errors, 0 where the model vol is NaN, flattened."""
    clean = torch.where(torch.isnan(model_vols), market, model_vols)
    return (sqrtw * (clean - market)).reshape(-1)


def panel_tensors(panels: Dict[str, np.ndarray], dtype: torch.dtype, device) -> Dict:
    """the panels as tensors of the working precision on ``device``."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return dict(ttms=t(panels["ttms"]), forwards=t(panels["forwards"]),
                discfactors=t(panels["discfactors"]), strikes=t(panels["strikes"]),
                is_call=torch.as_tensor(panels["is_call"], device=device),
                market=t(panels["market"]), sqrtw=t(np.sqrt(panels["weights"])))
