"""
Student-t terminal-distribution pricer.

PyTorch counterpart of ``stochvolmodels_tpu/models/tdist.py``: vanilla
prices in closed form through the incomplete beta (``ops/tdist.py``) on the
pricer's device, the risk-neutral drift by a differentiable Newton solve,
and a per-slice SLSQP over (vol, nu) on the host with a ``torch.autograd``
gradient: through the drift's Newton iterations, the incomplete beta's
derivative in a = nu / 2 (central differences) and the exact implied vol.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
from scipy.optimize import minimize

from stochvolmodels_torch.data.option_chain import OptionChain
from stochvolmodels_torch.models.gmm import _slice_targets, _torch_objective, _vol_fit_loss
from stochvolmodels_torch.models.model_pricer import ModelParams, ModelPricer
from stochvolmodels_torch.ops import bsm
from stochvolmodels_torch.ops import tdist as td


@dataclass
class TdistParams(ModelParams):
    """Student-t model: drift, volatility and degrees of freedom nu > 2;
    ttm fixed, not calibrated."""
    drift: float
    vol: float
    nu: float
    ttm: float


def tdist_vanilla_chain_pricer(vol: float, nu: float, drift: float, ttms: np.ndarray,
                               forwards: np.ndarray, strikes_ttms, optiontypes_ttms,
                               discfactors: np.ndarray, device="cuda") -> List[np.ndarray]:
    """Student-t prices of each slice at the given drift, on ``device``, one
    numpy array a slice."""
    f64 = dict(dtype=torch.float64, device=device)
    return [td.compute_vanilla_price_tdist(
                spot=torch.tensor(float(forward) * float(discfactor), **f64),
                strikes=torch.as_tensor(np.asarray(strikes, dtype=np.float64), **f64),
                ttm=float(ttm), vol=float(vol), nu=float(nu), optiontypes=types,
                rf_rate=float(drift), is_compute_risk_neutral_mu=False).cpu().numpy()
            for ttm, forward, discfactor, strikes, types in zip(ttms, forwards, discfactors,
                                                                strikes_ttms, optiontypes_ttms)]


class TdistPricer(ModelPricer):
    """ModelPricer valuing options under a Student-t terminal distribution."""

    def price_chain(self, option_chain: OptionChain, params: TdistParams,
                    **kwargs) -> List[np.ndarray]:
        return tdist_vanilla_chain_pricer(drift=params.drift, vol=params.vol, nu=params.nu,
                                          ttms=option_chain.ttms, forwards=option_chain.forwards,
                                          strikes_ttms=option_chain.strikes_ttms,
                                          optiontypes_ttms=option_chain.optiontypes_ttms,
                                          discfactors=option_chain.discfactors,
                                          device=self.device)

    def model_mc_price_chain(self, option_chain, params, **kwargs):
        raise NotImplementedError

    def calibrate_model_params_to_chain_slice(self,
                                              option_chain: OptionChain,
                                              params0: Optional[TdistParams] = None,
                                              is_vega_weighted: bool = True,
                                              is_unit_ttm_vega: bool = False,
                                              **kwargs) -> TdistParams:
        """SLSQP fit of (vol, nu) to one slice (bounds [0.05, 10] x [2.01,
        20], ftol 1e-10, 500 iterations), from ``params0`` or (0.2, 3), with
        the drift implied by the martingale condition inside the objective.
        scipy's result is kept as ``self.calibration_result``."""
        ttms = option_chain.ttms
        if len(ttms) > 1:
            raise NotImplementedError("cannot calibrate to multiple slices")
        ttm = float(ttms[0])
        rf_rate = float(option_chain.discount_rates[0])
        p0 = np.array([params0.vol, params0.nu]) if params0 is not None else np.array([0.2, 3.0])
        bounds = ((0.05, 10.0), (2.01, 20.0))

        market_vols, weights = _slice_targets(option_chain, is_vega_weighted, is_unit_ttm_vega)
        f64 = dict(dtype=torch.float64, device=self.device)
        forward = float(option_chain.forwards[0])
        discfactor = float(option_chain.discfactors[0])
        strikes = torch.as_tensor(option_chain.strikes_ttms[0], **f64)
        codes = bsm.as_option_codes(option_chain.optiontypes_ttms[0], self.device)
        market, w = torch.as_tensor(market_vols, **f64), torch.as_tensor(weights, **f64)
        spot = torch.tensor(forward * discfactor, **f64)

        def loss_fn(pars):
            vol, nu = pars[0], pars[1]
            drift = td.imply_drift_tdist(rf_rate=rf_rate, vol=vol, nu=nu, ttm=ttm)
            prices = td.compute_vanilla_price_tdist(spot=spot, strikes=strikes, ttm=ttm, vol=vol,
                                                    nu=nu, optiontypes=codes, rf_rate=drift,
                                                    is_compute_risk_neutral_mu=False)
            model_vols = bsm.infer_bsm_implied_vol(forward=forward, ttm=ttm, strike=strikes,
                                                   given_price=prices, discfactor=discfactor,
                                                   optiontype=codes)
            return _vol_fit_loss(model_vols, market, w)

        res = minimize(_torch_objective(loss_fn, self.device), p0, jac=True, method='SLSQP',
                       bounds=bounds, options={'ftol': 1e-10, 'maxiter': 500})
        self.calibration_result = res
        vol, nu = (float(v) for v in res.x)
        drift = float(td.imply_drift_tdist(rf_rate=rf_rate, vol=torch.tensor(vol, **f64),
                                           nu=nu, ttm=ttm))
        return TdistParams(vol=vol, nu=nu, drift=drift, ttm=ttm)

    def calibrate_model_params_to_chain(self, option_chain: OptionChain,
                                        is_vega_weighted: bool = True,
                                        is_unit_ttm_vega: bool = False,
                                        **kwargs) -> Dict[str, TdistParams]:
        """per-slice fits, each warm-started from the slice before."""
        fit_params: Dict[str, TdistParams] = {}
        params0 = None
        for ids_ in option_chain.ids:
            chain0 = OptionChain.get_slices_as_chain(option_chain, ids=[ids_])
            params0 = self.calibrate_model_params_to_chain_slice(
                option_chain=chain0, params0=params0, is_vega_weighted=is_vega_weighted,
                is_unit_ttm_vega=is_unit_ttm_vega, **kwargs)
            fit_params[ids_] = params0
        return fit_params
