"""
ModelPricer: the interface every model implements.

PyTorch counterpart of ``stochvolmodels_tpu/models/model_pricer.py``.  A
concrete pricer supplies ``price_chain`` (analytic transform pricing) and
may supply ``model_mc_price_chain`` and ``calibrate_model_params_to_chain``
(both raise here); this base class builds slice and vanilla pricing, implied
vols and MC confidence bands on top.  Results at the API boundary are
ragged numpy lists; the tensor work runs on the pricer's ``device``: the card
(``"cuda"``) unless the caller asks for ``"cpu"``.  Without a card a pricer on
the default device raises at its first tensor; it never falls back to the CPU.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import asdict, dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
from scipy import stats

from stochvolmodels_torch.config import VariableType
from stochvolmodels_torch.data.option_chain import OptionChain


@dataclass
class ModelParams:
    """abstract container for model parameters."""

    @classmethod
    def copy(cls, obj: "ModelParams") -> "ModelParams":
        return cls(**asdict(obj))

    def to_dict(self) -> Dict:
        return asdict(self)


class ModelPricer(ABC):
    """pricer interface shared by every model; tensors live on ``device``."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    @abstractmethod
    def price_chain(self, option_chain: OptionChain, params: ModelParams,
                    **kwargs) -> List[np.ndarray]:
        """price chain data analytically; returns ragged list of price arrays."""

    def compute_chain_prices_with_vols(self,
                                       option_chain: OptionChain,
                                       params: ModelParams,
                                       variable_type: VariableType = VariableType.LOG_RETURN,
                                       **kwargs
                                       ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """price chain and invert to model implied vols."""
        model_prices = self.price_chain(option_chain=option_chain, params=params,
                                        variable_type=variable_type, **kwargs)
        model_ivols = option_chain.compute_model_ivols_from_chain_data(
            model_prices=model_prices, device=self.device)
        return model_prices, model_ivols

    def compute_model_ivols_for_chain(self, option_chain: OptionChain,
                                      params: ModelParams, **kwargs) -> List[np.ndarray]:
        """model implied vols for the chain."""
        _, model_ivols = self.compute_chain_prices_with_vols(
            option_chain=option_chain, params=params, **kwargs)
        return model_ivols

    def model_mc_price_chain(self, option_chain: OptionChain, params: ModelParams,
                             variable_type: VariableType = VariableType.LOG_RETURN,
                             **kwargs) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """price chain by simulating model dynamics; (prices, stderrs)."""
        raise NotImplementedError("must be implemented in parent class")

    def calibrate_model_params_to_chain(self, option_chain: OptionChain, **kwargs):
        """fit model params to chain quotes."""
        raise NotImplementedError("must be implemented in parent class")

    def price_slice(self, params: ModelParams, ttm: float, forward: float,
                    strikes: np.ndarray, optiontypes: np.ndarray,
                    discfactor: float = 1.0, **kwargs
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """price one maturity slice; returns (prices, ivols)."""
        option_chain = OptionChain.slice_to_chain(ttm=ttm, forward=forward,
                                                  strikes=strikes,
                                                  optiontypes=optiontypes,
                                                  discfactor=discfactor)
        model_prices = self.price_chain(option_chain=option_chain, params=params, **kwargs)
        model_ivols = option_chain.compute_model_ivols_from_chain_data(
            model_prices=model_prices, device=self.device)
        return model_prices[0], model_ivols[0]

    def price_vanilla(self, params: ModelParams, ttm: float, forward: float,
                      strike: float, optiontype: str, discfactor: float = 1.0,
                      **kwargs) -> Tuple[float, float]:
        """price one option; returns (price, ivol)."""
        model_prices, model_ivols = self.price_slice(
            params=params, ttm=ttm, forward=forward,
            strikes=np.array([strike]), optiontypes=np.array([optiontype]),
            discfactor=discfactor, **kwargs)
        return model_prices[0], model_ivols[0]

    def simulate_vol_paths(self, params: ModelParams, **kwargs):
        """grid of vol paths."""
        raise NotImplementedError("must be implemented in parent class")

    def simulate_terminal_values(self, params: ModelParams, **kwargs):
        """terminal realizations of (x, vol-state, qvar)."""
        raise NotImplementedError("must be implemented in parent class")

    def compute_mc_chain_implied_vols(self,
                                      option_chain: OptionChain,
                                      params: ModelParams,
                                      variable_type: VariableType = VariableType.LOG_RETURN,
                                      nb_path: int = 100000,
                                      **kwargs
                                      ) -> Tuple[List[np.ndarray], ...]:
        """MC prices and implied vols with 1.96-sigma confidence bands."""
        model_prices_ttms, option_std_ttms = self.model_mc_price_chain(
            option_chain=option_chain, params=params,
            variable_type=variable_type, nb_path=nb_path, **kwargs)
        std_factor = 1.96
        ups = [p + std_factor * s for p, s in zip(model_prices_ttms, option_std_ttms)]
        downs = [np.maximum(p - std_factor * s, 1e-10)
                 for p, s in zip(model_prices_ttms, option_std_ttms)]
        ivols = lambda prices: option_chain.compute_model_ivols_from_chain_data(
            model_prices=prices, device=self.device)
        return (model_prices_ttms, ups, downs, ivols(model_prices_ttms), ivols(ups),
                ivols(downs), option_std_ttms)

    def get_log_return_mc_pdf(self, ttm: float, params: ModelParams, x_grid: np.ndarray,
                              nb_path: int = 100000) -> np.ndarray:
        """a Gaussian KDE (scipy, on the host) of the simulated terminal
        values on ``x_grid``, normalised to unit sum, with NaN and |value| >
        1e16 dropped.  As in the JAX package, every array that
        ``simulate_terminal_values`` returns enters the KDE."""
        t_values = np.asarray(self.simulate_terminal_values(ttm=ttm, params=params,
                                                            nb_path=nb_path))
        cut_off = 1e16
        inf_nans = np.isnan(t_values)
        inf_pos = np.greater(t_values, cut_off, where=~inf_nans)
        inf_neg = np.less(t_values, -cut_off, where=~inf_nans)
        print(f"in mc: num -inf = {np.sum(inf_neg)}, num +inf = {np.sum(inf_pos)}, "
              f"num nans = {np.sum(inf_nans)}")
        t_values = t_values[~inf_neg & ~inf_pos & ~inf_nans]
        z = stats.gaussian_kde(t_values)(x_grid)
        return z / np.nansum(z)

    def compute_logreturn_pdf(self, params: ModelParams, **kwargs) -> np.ndarray:
        """analytic log-return density."""
        raise NotImplementedError("must be implemented in parent class")

    # ------------------------------------------------------------------
    # visualization (stochvolmodels_torch.plotting; needs matplotlib,
    # seaborn and pandas, imported there at the call)
    # ------------------------------------------------------------------
    def plot_model_ivols(self, option_chain: OptionChain, params: ModelParams, **kwargs):
        from stochvolmodels_torch.plotting import pricer_plots
        return pricer_plots.plot_model_ivols(self, option_chain, params, **kwargs)

    def plot_model_ivols_vs_bid_ask(self, option_chain: OptionChain,
                                    params: ModelParams, **kwargs):
        from stochvolmodels_torch.plotting import pricer_plots
        return pricer_plots.plot_model_ivols_vs_bid_ask(self, option_chain, params, **kwargs)

    def plot_model_ivols_vs_mc(self, option_chain: OptionChain,
                               params: ModelParams, **kwargs):
        from stochvolmodels_torch.plotting import pricer_plots
        return pricer_plots.plot_model_ivols_vs_mc(self, option_chain, params, **kwargs)

    def plot_comp_mma_inverse_options_with_mc(self, option_chain: OptionChain,
                                              params: ModelParams, **kwargs):
        from stochvolmodels_torch.plotting import pricer_plots
        return pricer_plots.plot_comp_mma_inverse_options_with_mc(
            self, option_chain, params, **kwargs)

    def plot_model_slices_in_params(self, option_slice, params_dict, **kwargs):
        from stochvolmodels_torch.plotting import pricer_plots
        return pricer_plots.plot_model_slices_in_params(
            self, option_slice, params_dict, **kwargs)
