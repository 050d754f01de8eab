"""
Gaussian-mixture terminal-distribution pricer.

PyTorch counterpart of ``stochvolmodels_tpu/models/gmm.py``: a price is the
weighted sum of BSM prices at drift-adjusted forwards, one broadcast over
the (state, strike) panel on the pricer's device.  The per-slice fit is
scipy's SLSQP on the host, as in the JAX package, with the weights-sum and
martingale equality constraints; the objective's gradient is one
``torch.autograd`` backward through the prices and the exact implied vol
(the 200-step bisection, one CUDA graph per panel shape on the card).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from scipy.optimize import minimize

from stochvolmodels_torch.data.option_chain import OptionChain
from stochvolmodels_torch.models.model_pricer import ModelParams, ModelPricer
from stochvolmodels_torch.ops import bsm
from stochvolmodels_torch.ops.gauss import npdf
from stochvolmodels_torch.utils.funcs import to_flat_np_array


@dataclass
class GmmParams(ModelParams):
    """weighted mixture of normals for terminal log-returns; ttm is fixed,
    not calibrated."""
    gmm_weights: np.ndarray
    gmm_mus: np.ndarray
    gmm_vols: np.ndarray
    ttm: float

    def sort_by_mus(self):
        indices = np.argsort(self.gmm_mus)
        self.gmm_weights = self.gmm_weights[indices]
        self.gmm_mus = self.gmm_mus[indices]
        self.gmm_vols = self.gmm_vols[indices]

    def get_get_avg_vol(self) -> float:
        return float(np.sqrt(np.sum(self.gmm_weights * np.square(self.gmm_vols))))

    def compute_state_pdfs(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(each state's density on ``x``, the mixture's); numpy in and out,
        on host tensors."""
        host = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))
        state_pdfs = npdf(host(x)[:, None], mu=host(self.gmm_mus)[None, :] * self.ttm,
                          vol=host(self.gmm_vols)[None, :] * np.sqrt(self.ttm))
        return state_pdfs.numpy(), (state_pdfs @ host(self.gmm_weights)).numpy()

    def compute_pdf(self, x: np.ndarray) -> np.ndarray:
        _, agg = self.compute_state_pdfs(x)
        return agg


def compute_gmm_vanilla_price(gmm_weights, gmm_mus, gmm_vols, ttm, forward, strike, optiontype,
                              discfactor=1.0) -> torch.Tensor:
    """sum_i w_i BSM(F exp((mu_i + vol_i^2 / 2) ttm), vol_i), broadcast over
    (state, strike), on the device of the first tensor argument (the card
    if none)."""
    device = bsm._device_of(gmm_weights, gmm_mus, gmm_vols, strike, forward)
    gmm_weights, gmm_mus, gmm_vols, strike = (bsm._f64(a, device) for a in
                                              (gmm_weights, gmm_mus, gmm_vols, strike))
    forwards_i = forward * torch.exp((gmm_mus + 0.5 * gmm_vols * gmm_vols) * ttm)
    codes = bsm.as_option_codes(optiontype, device)
    prices_i = bsm.compute_bsm_vanilla_price(
        forward=forwards_i[:, None], strike=strike[None, :], ttm=bsm._f64(ttm, device),
        vol=gmm_vols[:, None], optiontype=codes[None, :], discfactor=1.0)
    return discfactor * (gmm_weights @ prices_i)


def compute_gmm_vanilla_slice_prices(gmm_weights, gmm_mus, gmm_vols, ttm, forward, strikes,
                                     optiontypes, discfactor=1.0) -> torch.Tensor:
    """:func:`compute_gmm_vanilla_price` with the reference's plural kwargs."""
    return compute_gmm_vanilla_price(gmm_weights=gmm_weights, gmm_mus=gmm_mus,
                                     gmm_vols=gmm_vols, ttm=ttm, forward=forward,
                                     strike=strikes, optiontype=optiontypes,
                                     discfactor=discfactor)


def gmm_vanilla_chain_pricer(gmm_weights, gmm_mus, gmm_vols, ttms, forwards, strikes_ttms,
                             optiontypes_ttms, discfactors, device="cuda") -> List[np.ndarray]:
    """mixture prices of each slice on ``device``, one numpy array a slice."""
    host = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)
    weights, mus, vols = host(gmm_weights), host(gmm_mus), host(gmm_vols)
    return [compute_gmm_vanilla_price(gmm_weights=weights, gmm_mus=mus, gmm_vols=vols,
                                      ttm=float(ttm), forward=float(forward),
                                      strike=host(strikes), optiontype=types,
                                      discfactor=float(discfactor)).cpu().numpy()
            for ttm, forward, discfactor, strikes, types in zip(ttms, forwards, discfactors,
                                                                strikes_ttms, optiontypes_ttms)]


def _slice_targets(option_chain: OptionChain, is_vega_weighted: bool, is_unit_ttm_vega: bool
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(market mid vols, weights) of a one-slice chain: the slice-normalised
    BSM vegas, or ones."""
    _, y = option_chain.get_chain_data_as_xy()
    market_vols = to_flat_np_array(y)
    if is_vega_weighted:
        vegas_ttms = option_chain.get_chain_vegas(is_unit_ttm_vega=is_unit_ttm_vega)
        weights = to_flat_np_array([v / np.sum(v) for v in vegas_ttms])
    else:
        weights = np.ones_like(market_vols)
    return market_vols, weights


def _vol_fit_loss(model_vols: torch.Tensor, market: torch.Tensor, weights: torch.Tensor
                  ) -> torch.Tensor:
    """sum of w (model vol - market vol)^2 over the quotes with a model vol;
    NaN vols are replaced before squaring, so the backward pass sees no
    0 x NaN."""
    nan_mask = torch.isnan(model_vols)
    clean = torch.where(nan_mask, market, model_vols)
    return torch.sum(torch.where(nan_mask, 0.0, weights * torch.square(clean - market)))


def _torch_objective(loss_fn, device):
    """scipy's (value, gradient) callback for ``loss_fn`` of a float64
    parameter tensor on ``device``: one forward and one backward a call."""
    def objective(pars: np.ndarray):
        tracked = torch.as_tensor(np.asarray(pars, dtype=np.float64),
                                  device=device).requires_grad_(True)
        loss = loss_fn(tracked)
        (grad,) = torch.autograd.grad(loss, tracked)
        return float(loss.detach()), grad.cpu().numpy()
    return objective


class GmmPricer(ModelPricer):
    """ModelPricer valuing options as a weighted sum of BSM prices."""

    def price_chain(self, option_chain: OptionChain, params: GmmParams,
                    **kwargs) -> List[np.ndarray]:
        return gmm_vanilla_chain_pricer(gmm_weights=params.gmm_weights,
                                        gmm_mus=params.gmm_mus, gmm_vols=params.gmm_vols,
                                        ttms=option_chain.ttms, forwards=option_chain.forwards,
                                        strikes_ttms=option_chain.strikes_ttms,
                                        optiontypes_ttms=option_chain.optiontypes_ttms,
                                        discfactors=option_chain.discfactors,
                                        device=self.device)

    def model_mc_price_chain(self, option_chain, params, **kwargs):
        raise NotImplementedError

    def calibrate_model_params_to_chain_slice(self,
                                              option_chain: OptionChain,
                                              params0: Optional[GmmParams] = None,
                                              is_vega_weighted: bool = True,
                                              is_unit_ttm_vega: bool = False,
                                              n_mixtures: int = 4,
                                              **kwargs) -> GmmParams:
        """SLSQP fit of one slice (ftol 1e-10, 500 iterations) under the
        equality constraints sum w = 1 and sum w exp((mu + vol^2 / 2) ttm)
        = 1, from ``params0`` or equal weights, zero mus and vols spread on
        [0.2, 1]; the fit is sorted by mus.  scipy's result is kept as
        ``self.calibration_result``."""
        ttms = option_chain.ttms
        if len(ttms) > 1:
            raise NotImplementedError("cannot calibrate to multiple slices")
        ttm = float(ttms[0])
        if params0 is not None:
            p0 = np.concatenate((params0.gmm_weights, params0.gmm_mus, params0.gmm_vols))
            n_mixtures = len(params0.gmm_weights)
        else:
            p0 = np.concatenate((np.ones(n_mixtures) / n_mixtures, np.zeros(n_mixtures),
                                 np.linspace(0.2, 1.0, n_mixtures)))
        nm = n_mixtures
        bounds = np.concatenate(([(0.0, 1.0)] * nm, [(-10.0, 10.0)] * nm, [(0.01, 4.0)] * nm))

        market_vols, weights = _slice_targets(option_chain, is_vega_weighted, is_unit_ttm_vega)
        f64 = dict(dtype=torch.float64, device=self.device)
        forward = float(option_chain.forwards[0])
        discfactor = float(option_chain.discfactors[0])
        strikes = torch.as_tensor(option_chain.strikes_ttms[0], **f64)
        codes = bsm.as_option_codes(option_chain.optiontypes_ttms[0], self.device)
        market, w = torch.as_tensor(market_vols, **f64), torch.as_tensor(weights, **f64)

        def loss_fn(pars):
            prices = compute_gmm_vanilla_price(gmm_weights=pars[:nm], gmm_mus=pars[nm:2 * nm],
                                               gmm_vols=pars[2 * nm:], ttm=ttm, forward=forward,
                                               strike=strikes, optiontype=codes,
                                               discfactor=discfactor)
            model_vols = bsm.infer_bsm_implied_vol(forward=forward, ttm=ttm, strike=strikes,
                                                   given_price=prices, discfactor=discfactor,
                                                   optiontype=codes)
            return _vol_fit_loss(model_vols, market, w)

        def weights_sum(pars):
            return np.sum(pars[:nm]) - 1.0

        def weights_sum_jac(pars):
            j = np.zeros_like(pars)
            j[:nm] = 1.0
            return j

        def martingale(pars):
            gw, gm, gv = pars[:nm], pars[nm:2 * nm], pars[2 * nm:]
            return np.sum(gw * np.exp((gm + 0.5 * gv * gv) * ttm)) - 1.0

        constraints = ({'type': 'eq', 'fun': weights_sum, 'jac': weights_sum_jac},
                       {'type': 'eq', 'fun': martingale})
        res = minimize(_torch_objective(loss_fn, self.device), p0, jac=True, method='SLSQP',
                       constraints=constraints, bounds=bounds,
                       options={'ftol': 1e-10, 'maxiter': 500})
        self.calibration_result = res
        fit_params = GmmParams(gmm_weights=res.x[:nm], gmm_mus=res.x[nm:2 * nm],
                               gmm_vols=res.x[2 * nm:], ttm=ttm)
        fit_params.sort_by_mus()
        return fit_params

    def calibrate_model_params_to_chain(self, option_chain: OptionChain,
                                        is_vega_weighted: bool = True,
                                        is_unit_ttm_vega: bool = False,
                                        n_mixtures: int = 4,
                                        **kwargs) -> Dict[str, GmmParams]:
        """per-slice fits, each warm-started from the slice before."""
        fit_params: Dict[str, GmmParams] = {}
        params0 = None
        for ids_ in option_chain.ids:
            chain0 = OptionChain.get_slices_as_chain(option_chain, ids=[ids_])
            params0 = self.calibrate_model_params_to_chain_slice(
                option_chain=chain0, params0=params0, is_vega_weighted=is_vega_weighted,
                is_unit_ttm_vega=is_unit_ttm_vega, n_mixtures=n_mixtures, **kwargs)
            fit_params[ids_] = params0
        return fit_params
