"""
Monte-Carlo driver for the factor HJM model with an SV driver.

PyTorch counterpart of ``stochvolmodels_tpu/models/factor_hjm/factor_hjm_pricer.py``:
simulate the Eq. (9) dynamics on the device (``simulate_logsv_MF``) and
reduce the terminal states to normal implied vols through the annuity-
deflated swaption payoff (host numpy, ``basis.calculate_swap_rate``), the
vols inverted on the device.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

import stochvolmodels_torch.ops.bachelier as bachel
from stochvolmodels_torch.models.factor_hjm.rate_logsv_params import MultiFactRateLogSvParams
from stochvolmodels_torch.models.factor_hjm.rate_logsv_pricer import Measure, simulate_logsv_MF
from stochvolmodels_torch.utils.rate_core import get_default_swap_term_structure


def do_mc_simulation(basis_type: str,
                     ccy: str,
                     ttms: np.ndarray,
                     x0: np.ndarray,
                     y0: np.ndarray,
                     I0: np.ndarray,
                     sigma0: np.ndarray,
                     params: MultiFactRateLogSvParams,
                     nb_path: int,
                     seed: Optional[int] = None,
                     measure_type: Measure = Measure.RISK_NEUTRAL,
                     ts_sw: Optional[np.ndarray] = None,
                     bxs: Optional[np.ndarray] = None,
                     year_days: int = 360,
                     T_fwd: Optional[float] = None,
                     device="cuda",
                     ) -> Tuple[list, list, list, list]:
    """simulate model paths to the requested maturities on ``device``;
    ``bxs`` enables the DLN-skew branch."""
    if basis_type != "NELSON-SIEGEL":
        raise NotImplementedError
    return simulate_logsv_MF(ttms=ttms, x0=x0, y0=y0, I0=I0, sigma0=sigma0,
                             theta=params.theta, kappa1=params.kappa1, kappa2=params.kappa2,
                             ts=params.ts, A=params.A, R=params.R, C=params.C,
                             Omega=params.Omega, betaxs=params.beta.xs,
                             volvolxs=params.volvol.xs, basis=params.basis,
                             measure_type=measure_type, nb_path=nb_path, seed=seed, ccy=ccy,
                             ts_sw=ts_sw, T_fwd=T_fwd, year_days=year_days, bxs=bxs,
                             device=device)


def calc_mc_vols(basis_type: str,
                 params: MultiFactRateLogSvParams,
                 ttm: float,
                 tenors: np.ndarray,
                 forwards: List[np.ndarray],
                 strikes_ttms,
                 optiontypes: np.ndarray,
                 is_annuity_measure: bool,
                 nb_path: int,
                 x0: Optional[np.ndarray] = None,
                 y0: Optional[np.ndarray] = None,
                 sigma0: Optional[np.ndarray] = None,
                 I0: Optional[np.ndarray] = None,
                 seed: Optional[int] = None,
                 bxs: Optional[np.ndarray] = None,
                 device="cuda",
                 **kwargs) -> Tuple[list, list, list, list]:
    """annuity-deflated MC swaption prices inverted to normal implied vols:
    (prices, vols, vols at +1.96 stderr, vols at -1.96 stderr), one entry
    per tenor.  The paths run on ``device`` under the risk-neutral measure
    (``sigma0`` defaults to 1 on every path, as in the JAX package)."""
    assert len(strikes_ttms) == len(tenors)
    assert is_annuity_measure is False
    if x0 is None:
        x0 = np.zeros((nb_path, params.basis.get_nb_factors()))
    if y0 is None:
        y0 = np.zeros((nb_path, params.basis.get_nb_aux_factors()))
    if sigma0 is None:
        sigma0 = np.ones((nb_path, 1))
    if I0 is None:
        I0 = np.zeros(nb_path)

    ttms = np.array([ttm])
    ts_sws, bond0s, ann0s = [], [], []
    for tenor in tenors:
        ts_sw = get_default_swap_term_structure(expiry=ttm, tenor=tenor)
        ann0 = np.asarray(params.basis.annuity(t=ttm, ts_sw=ts_sw, x=x0, y=y0,
                                               ccy=params.ccy, m=0)).ravel()[0]
        bond0 = np.asarray(params.basis.bond(0, ttm, x=x0, y=y0, ccy=params.ccy,
                                             m=0)).ravel()[0]
        ts_sws.append(ts_sw)
        bond0s.append(bond0)
        ann0s.append(ann0)

    x0s, y0s, I0s, _ = do_mc_simulation(basis_type=basis_type, ccy=params.ccy, ttms=ttms,
                                        x0=x0, y0=y0, I0=I0, sigma0=sigma0, params=params,
                                        nb_path=nb_path, seed=seed,
                                        measure_type=Measure.RISK_NEUTRAL, bxs=bxs,
                                        device=device)
    x_T, y_T, I_T = x0s[-1], y0s[-1], I0s[-1]

    mc_vols, mc_prices, mc_vols_ups, mc_vols_downs = [], [], [], []
    std_factor = 1.96
    for idx_tenor, tenor in enumerate(tenors):
        ts_sw = ts_sws[idx_tenor]
        ann0, bond0 = ann0s[idx_tenor], bond0s[idx_tenor]
        strikes_ttm = strikes_ttms[idx_tenor][0]
        swap_mc, ann_mc, numer_mc = params.basis.calculate_swap_rate(
            ttm=ttm, x0=x_T, y0=y_T, I0=I_T, ts_sw=ts_sw, ccy=params.ccy)
        payoffsign = np.where(np.asarray(optiontypes) == 'P', -1.0, 1.0)
        option_mean = np.zeros_like(strikes_ttm)
        option_std = np.zeros_like(strikes_ttm)
        for idx, (strike, sign) in enumerate(zip(strikes_ttm, payoffsign)):
            payoff = (1.0 / numer_mc) * ann_mc * np.maximum(sign * (swap_mc - strike), 0.0)
            option_mean[idx] = np.nanmean(payoff) / ann0 / bond0
            option_std[idx] = np.nanstd(payoff) / ann0 / bond0 / np.sqrt(nb_path)
        option_up = option_mean + std_factor * option_std
        option_down = np.maximum(option_mean - std_factor * option_std, 0.0)

        def invert(prices):
            return bachel.infer_normal_implied_vol(
                forward=torch.as_tensor(float(forwards[idx_tenor][0]), dtype=torch.float64,
                                        device=device),
                ttm=ttm, strike=strikes_ttm, given_price=prices,
                optiontype=optiontypes).cpu().numpy()

        mc_vols.append(invert(option_mean))
        mc_vols_ups.append(invert(option_up))
        mc_vols_downs.append(invert(option_down))
        mc_prices.append(option_mean)
    return mc_prices, mc_vols, mc_vols_ups, mc_vols_downs
