"""
Closed-form normal-vol smile approximations and delta/strike maps for rates
options (the calibration space of Secs. 7.5 / 7.7).

PyTorch-port copy of ``stochvolmodels_tpu/models/factor_hjm/rate_logsv_ivols.py``:
SABR-style normal implied vols with shift and CEV beta, a parabolic ATM
pre-fit, curve_fit smile fitting, and delta<->strike maps.  Host numpy and
scipy (per-slice fitting utilities, not a hot path), with the JAX package's
arithmetic; pandas, which the card's machine lacks, is imported inside the
one function that returns a Series.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
from scipy.optimize import brenth, curve_fit
from scipy.stats import norm

ALPHA = 'alpha'
BETA = 'beta'
TOTAL_VOL = 'total_vol'
RHO = 'rho'


def get_alpha(f0: float, ttm: float, vol_atm: float, beta: float, rho: float,
              total_vol: float, shift: float) -> float:
    """SABR alpha from the ATM normal vol, as the closest real cubic root."""
    f_pow_beta = np.power(f0 + shift, beta)
    omega = -0.125 * beta * (2.0 - beta) / np.power(f0 + shift, 2.0 - 2.0 * beta)
    p = [ttm * f_pow_beta * omega / 3.0,
         0.0,
         f_pow_beta + ttm * f_pow_beta * total_vol ** 2 * (2.0 - 3.0 * rho ** 2) / 24.0,
         -vol_atm]
    roots = np.roots(p)
    roots_real = np.extract(np.isreal(roots), np.real(roots))
    alpha_first_guess = vol_atm / np.power(f0 + shift, beta)
    return float(roots_real[np.argmin(np.abs(roots_real - alpha_first_guess))])


def calc_logsv_ivols(strikes: Union[float, np.ndarray],
                     f0: float,
                     ttm: float,
                     alpha: float,
                     rho: float,
                     total_vol: float,
                     beta: float,
                     shift: float,
                     is_alpha_atmvol: bool = False) -> np.ndarray:
    """SABR normal implied vols with shift and beta, vectorized over strikes."""
    assert f0 > 0
    strikes = np.atleast_1d(np.asarray(strikes, dtype=float))
    if not np.all(strikes + shift > 0):
        raise ValueError('strike + shift must be positive')
    assert 0.0 <= beta <= 1.0
    tol = 1e-6
    if is_alpha_atmvol:
        alpha = get_alpha(f0=f0, ttm=ttm, vol_atm=alpha, beta=beta, rho=rho,
                          total_vol=total_vol, shift=shift)

    at_atm = np.fabs(strikes - f0) <= tol
    if (1.0 - beta) >= 1e-3:
        pw = np.power(strikes + shift, 1.0 - beta) - np.power(f0 + shift, 1.0 - beta)
        zeta = total_vol / alpha * pw / (1.0 - beta)
        omega = -0.125 * beta * (2.0 - beta) / np.power(f0 + shift, 2.0 - 2.0 * beta)
        m1 = np.where(at_atm, np.power(f0 + shift, beta),
                      (1.0 - beta) * (strikes - f0) / np.where(at_atm, 1.0, pw))
    else:
        lg = np.log((strikes + shift) / (f0 + shift))
        zeta = total_vol / alpha * lg
        omega = -0.125
        m1 = np.where(at_atm, np.power(f0 + shift, beta),
                      (strikes - f0) / np.where(at_atm, 1.0, lg))

    e_zeta = np.sqrt(1.0 + 2.0 * rho * zeta + zeta ** 2)
    y_zeta = np.log((rho + zeta + e_zeta) / (1.0 + rho))
    safe_y = np.where(at_atm, 1.0, y_zeta)
    theta_off = (total_vol ** 2 / 24.0 * (-1.0 + 3.0 * (rho + zeta - rho * e_zeta)
                                          / (safe_y * e_zeta))
                 + omega * alpha ** 2 / 6.0 * (1.0 - rho ** 2
                                               + ((rho + zeta) * e_zeta - rho) / safe_y))
    theta_atm = (total_vol ** 2 / 24.0 * (2.0 - 3.0 * rho ** 2)
                 + omega * alpha ** 2 / 3.0)
    theta_zeta = np.where(at_atm, theta_atm, theta_off)
    zeta_by_yzeta = np.where(at_atm, 1.0, zeta / safe_y)
    mult = np.where(theta_zeta >= 0.0, 1.0 + theta_zeta * ttm,
                    1.0 / (1.0 - theta_zeta * ttm))
    return alpha * m1 * zeta_by_yzeta * mult


def cals_logsv_parab_fit(strikes: np.ndarray, mid_vols: np.ndarray, f0: float,
                         beta: float, shift: float, strike_step: float = 0.001
                         ) -> Dict[str, float]:
    """parabolic ATM pre-fit of (alpha, total_vol, rho)."""
    v0 = np.interp(x=f0, xp=strikes, fp=mid_vols)
    v0_m1 = np.interp(x=f0 - strike_step, xp=strikes, fp=mid_vols)
    v0_p1 = np.interp(x=f0 + strike_step, xp=strikes, fp=mid_vols)
    v1 = (v0_p1 - v0_m1) / (2.0 * strike_step)
    v2 = (v0_p1 - 2.0 * v0 + v0_m1) / strike_step ** 2
    v1 = v1 * (f0 + shift)
    v2 = (f0 + shift) ** 2 * v2 + v1
    alpha = v0 / np.power(f0 + shift, beta)
    total_vol2 = (1.0 / np.power(f0 + shift, 2.0)
                  * (v0 ** 2 * np.power(beta - 1.0, 2.0) + 6.0 * v1 ** 2
                     + 6.0 * v0 * (v1 - beta * v1 + v2)))
    total_vol = np.sqrt(total_vol2)
    rho = (v0 - beta * v0 + 2.0 * v1) / total_vol / (f0 + shift)
    return {ALPHA: alpha, BETA: beta, TOTAL_VOL: total_vol, RHO: rho}


def fit_logsv_ivols(strikes: np.ndarray, mid_vols: np.ndarray, f0: float,
                    beta: float, shift: float, ttm: float) -> Dict[str, float]:
    """fit (alpha, total_vol, rho) to a smile slice in vol space."""
    atm_fit = cals_logsv_parab_fit(strikes=strikes, mid_vols=mid_vols, f0=f0,
                                   beta=beta, shift=shift)
    bounds = ([0.001, 0.01, -0.999], [3.0 * atm_fit[ALPHA], 5.0, 0.999])
    atm_fit[RHO] = (np.clip(atm_fit[RHO], -0.99, 0.99)
                    if not np.isnan(atm_fit[RHO]) else 0.0)
    atm_fit[TOTAL_VOL] = (np.clip(atm_fit[TOTAL_VOL], 0.01, 3.0)
                          if not np.isnan(atm_fit[TOTAL_VOL]) else 0.1)
    p0 = np.array([atm_fit[ALPHA], atm_fit[TOTAL_VOL], atm_fit[RHO]])

    def ivol_func(_, alpha, total_vol, rho):
        return calc_logsv_ivols(strikes=strikes, f0=f0, ttm=ttm, alpha=alpha,
                                rho=rho, total_vol=total_vol, beta=beta,
                                shift=shift)

    popt, _ = curve_fit(f=ivol_func, xdata=strikes, ydata=mid_vols,
                        bounds=bounds, p0=p0)
    return {ALPHA: popt[0], BETA: beta, TOTAL_VOL: popt[1], RHO: popt[2]}


def get_delta_at_strikes(strikes: np.ndarray, f0: float, ttm: float,
                         sigma0: float, rho: float, total_vol: float,
                         beta: float, shift: float,
                         optiontypes: np.ndarray = None) -> np.ndarray:
    """normal deltas at the given strikes."""
    if optiontypes is None:
        optiontypes = np.repeat('C', strikes.size)
    vol_st = np.sqrt(ttm) * calc_logsv_ivols(strikes=strikes, f0=f0, ttm=ttm,
                                             alpha=sigma0, rho=rho,
                                             total_vol=total_vol, beta=beta,
                                             shift=shift)
    d = (f0 - strikes) / vol_st
    return np.where(optiontypes == "C", norm.cdf(d), norm.cdf(d) - 1.0)


def infer_strikes_from_deltas(deltas: np.ndarray, f0: float, ttm: float,
                              sigma0: float, rho: float, total_vol: float,
                              beta: float, shift: float):
    """strikes at the given normal deltas by root finding: a pandas Series
    indexed by delta (a delta whose root is not found maps to ``f0``)."""
    import pandas as pd

    st = np.sqrt(ttm)

    def func(strike: float, given_delta: float) -> float:
        vol_st = st * calc_logsv_ivols(strikes=strike, f0=f0, ttm=ttm,
                                       alpha=sigma0, rho=rho,
                                       total_vol=total_vol, beta=beta,
                                       shift=shift)[0]
        target = norm.ppf(given_delta) if given_delta >= 0.0 else norm.ppf(1.0 + given_delta)
        return (f0 - strike) / vol_st - target

    out = {}
    a, b = -shift + 0.0001, 20 * f0
    for given_delta in deltas:
        try:
            strike = brenth(f=func, a=a, b=b, args=(given_delta,))
        except Exception:
            print(f"can't find strike for delta={given_delta}, ttm={ttm}, forward={f0}")
            strike = f0
        out[given_delta] = strike
    return pd.DataFrame.from_dict(out, orient='index').iloc[:, 0]
