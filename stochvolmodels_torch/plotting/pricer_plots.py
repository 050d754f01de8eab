"""
ModelPricer visualization entry points.

PyTorch port's copy of ``stochvolmodels_tpu/plotting/pricer_plots.py``: the
five plotting methods of the reference's ModelPricer as module-level
functions taking the pricer first, called through thin method wrappers on
:class:`stochvolmodels_torch.models.model_pricer.ModelPricer`.  The port's
pricers return numpy at their boundary; anything still a tensor is taken as
``.cpu().numpy()`` (:func:`_np`).  matplotlib, seaborn and pandas are
imported inside the functions.
"""
from __future__ import annotations

import string
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np
import torch

from stochvolmodels_torch.config import VariableType
from stochvolmodels_torch.plotting import plots as plot

if TYPE_CHECKING:
    import matplotlib.pyplot as plt


def _np(x) -> np.ndarray:
    """a tensor's values on the host, or ``np.asarray`` of anything else."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _slice_axes(num_slices: int, figsize, axs=None):
    """1/2/3/2x2 subplot layouts keyed on the slice count."""
    import matplotlib.pyplot as plt
    import seaborn as sns
    if axs is not None:
        return None, axs
    with sns.axes_style('darkgrid'):
        if num_slices == 1:
            fig, ax = plt.subplots(1, 1, figsize=figsize, tight_layout=True)
            return fig, [ax]
        if num_slices in (2, 3):
            fig, axs = plt.subplots(1, num_slices, figsize=figsize, tight_layout=True)
            return fig, list(axs)
        if num_slices == 4:
            fig, axs = plt.subplots(2, 2, figsize=figsize, tight_layout=True)
            return fig, plot.to_flat_list(axs)
    raise NotImplementedError(f"{num_slices} slices")


def _slice_title(option_chain, idx: int, ttm: float,
                 headers: Optional[List[str]] = None) -> str:
    if option_chain.ids is not None:
        if headers is not None:
            return f"{headers[idx]} slice - {option_chain.ids[idx]}"
        return f"Slice - {option_chain.ids[idx]}"
    return f"{ttm=:0.2f}"


def plot_model_ivols(pricer, option_chain, params,
                     is_log_strike_xaxis: bool = False,
                     headers: Optional[List[str]] = None,
                     ax=None, **kwargs) -> Optional[plt.Figure]:
    """model vols per slice on one axis (model_pricer.py:244-288)."""
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns
    model_ivols = pricer.compute_model_ivols_for_chain(option_chain=option_chain,
                                                       params=params, **kwargs)
    fig = None
    if ax is None:
        with sns.axes_style('darkgrid'):
            fig, ax = plt.subplots(1, 1, figsize=plot.FIGSIZE, tight_layout=True)

    series = []
    for idx, ttm in enumerate(option_chain.ttms):
        strikes = (np.log(option_chain.strikes_ttms[idx] / option_chain.forwards[idx])
                   if is_log_strike_xaxis else option_chain.strikes_ttms[idx])
        series.append(pd.Series(_np(model_ivols[idx]), index=strikes,
                                name=_slice_title(option_chain, idx, ttm, headers)))
    plot.model_vols_ts(model_vols=pd.concat(series, axis=1),
                       title='Model Implied Black Volatilities',
                       xlabel='log-strike' if is_log_strike_xaxis else 'strike',
                       xvar_format='{:0.2f}' if is_log_strike_xaxis else '{:0,.0f}',
                       ax=ax, **kwargs)
    return fig


def plot_model_slices_in_params(pricer, option_slice, params_dict: Dict,
                                is_log_strike_xaxis: bool = False,
                                title: str = 'Model Vols',
                                xlabel: Optional[str] = None,
                                xvar_format: Optional[str] = None,
                                ax=None, **kwargs) -> Optional[plt.Figure]:
    """one slice priced under several parameter sets (model_pricer.py:290-333)."""
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns
    series = []
    for key, params in params_dict.items():
        _, model_ivols = pricer.price_slice(ttm=option_slice.ttm,
                                            forward=option_slice.forward,
                                            strikes=option_slice.strikes,
                                            optiontypes=option_slice.optiontypes,
                                            params=params, **kwargs)
        series.append(pd.Series(_np(model_ivols), index=option_slice.strikes,
                                name=key))
    fig = None
    if ax is None:
        with sns.axes_style('darkgrid'):
            fig, ax = plt.subplots(1, 1, figsize=plot.FIGSIZE, tight_layout=True)
    plot.model_vols_ts(model_vols=pd.concat(series, axis=1), title=title,
                       xlabel=xlabel or ('log-strike' if is_log_strike_xaxis else 'strike'),
                       xvar_format=xvar_format or ('{:0.2f}' if is_log_strike_xaxis
                                                   else '{:0,.0f}'),
                       ax=ax, **kwargs)
    return fig


def plot_model_ivols_vs_bid_ask(pricer, option_chain, params,
                                is_log_strike_xaxis: bool = False,
                                headers: Optional[List[str]] = None,
                                xvar_format: Optional[str] = None,
                                figsize: Tuple[float, float] = plot.FIGSIZE,
                                axs=None, **kwargs) -> Optional[plt.Figure]:
    """per-slice smile fit vs market bid/ask (model_pricer.py:335-413)."""
    import pandas as pd
    if kwargs.get('mode') == 'mc':
        model_ivols = pricer.compute_mc_chain_implied_vols(
            option_chain=option_chain, params=params, **kwargs)[3]
    else:
        model_ivols = pricer.compute_model_ivols_for_chain(
            option_chain=option_chain, params=params, **kwargs)

    fig, axs = _slice_axes(len(option_chain.ttms), figsize, axs)
    atm_vols = option_chain.get_chain_atm_vols()
    for idx, ttm in enumerate(option_chain.ttms):
        if is_log_strike_xaxis:
            strikes = np.log(option_chain.strikes_ttms[idx] / option_chain.forwards[idx])
            atm_forward = 0.0
            fmt = xvar_format or '{:0.2f}'
            strike_name = 'log-strike'
        else:
            strikes = option_chain.strikes_ttms[idx]
            atm_forward = option_chain.forwards[idx]
            fmt = xvar_format or '{:0,.0f}'
            strike_name = 'strike'
        midvols = 0.5 * (option_chain.bid_ivs[idx] + option_chain.ask_ivs[idx])
        mse = np.sqrt(np.nanmean(np.square(_np(model_ivols[idx]) - midvols)))
        plot.vol_slice_fit(
            bid_vol=pd.Series(option_chain.bid_ivs[idx], index=strikes),
            ask_vol=pd.Series(option_chain.ask_ivs[idx], index=strikes),
            model_vols=pd.Series(_np(model_ivols[idx]), index=strikes,
                                 name=f"Model Fit: mse={mse:0.2%}"),
            title=_slice_title(option_chain, idx, ttm, headers),
            atm_points={'ATM': (atm_forward, atm_vols[idx])},
            strike_name=strike_name, xvar_format=fmt, ax=axs[idx], **kwargs)
    return fig


def plot_model_ivols_vs_mc(pricer, option_chain, params,
                           is_log_strike_xaxis: bool = False,
                           variable_type: VariableType = VariableType.LOG_RETURN,
                           nb_path: int = 100000,
                           figsize: Tuple[float, float] = plot.FIGSIZE,
                           **kwargs) -> Optional[plt.Figure]:
    """analytic vs MC implied vols with 95% bands (model_pricer.py:415-484)."""
    import pandas as pd
    model_ivols = pricer.compute_model_ivols_for_chain(option_chain=option_chain,
                                                       params=params, **kwargs)
    (_, _, _, mc_ivols, mc_ivols_up, mc_ivols_down, _) = \
        pricer.compute_mc_chain_implied_vols(option_chain=option_chain,
                                             params=params, nb_path=nb_path,
                                             variable_type=variable_type, **kwargs)
    fig, axs = _slice_axes(len(option_chain.ttms), figsize)
    for idx, ttm in enumerate(option_chain.ttms):
        if is_log_strike_xaxis:
            strikes = np.log(option_chain.strikes_ttms[idx] / option_chain.forwards[idx])
            fmt, strike_name = '{:0.2f}', 'log-strike'
        else:
            strikes = option_chain.strikes_ttms[idx]
            if variable_type == VariableType.LOG_RETURN:
                fmt, strike_name = '{:0,.0f}', 'strike'
            else:
                fmt, strike_name = '{:0.2f}', 'QVAR strike'
        mse = np.sqrt(np.nanmean(np.square(_np(model_ivols[idx])
                                           - _np(mc_ivols[idx]))))
        title = (f"{option_chain.ids[idx]}, {ttm=:0.2f}"
                 if option_chain.ids is not None else f"{ttm=:0.2f}")
        plot.vol_slice_fit(
            bid_vol=pd.Series(_np(mc_ivols_down[idx]), index=strikes),
            ask_vol=pd.Series(_np(mc_ivols_up[idx]), index=strikes),
            model_vols=pd.Series(_np(model_ivols[idx]), index=strikes,
                                 name=f"Model: mse={mse:0.2%}"),
            title=title, bid_name='MC: -0.95ci', ask_name='MC: +0.95ci',
            strike_name=strike_name, xvar_format=fmt, ax=axs[idx], **kwargs)
    return fig


def plot_comp_mma_inverse_options_with_mc(pricer, option_chain, params,
                                          variable_type: VariableType = VariableType.LOG_RETURN,
                                          nb_path: int = 100000,
                                          is_log_strike_xaxis: bool = False,
                                          is_plot_vols: bool = True,
                                          figsize: Tuple[float, float] = plot.FIGSIZE,
                                          xvar_format: str = '{:0,.2f}',
                                          **kwargs) -> Optional[plt.Figure]:
    """MMA vs inverse-measure analytic vols against MMA MC bands
    (model_pricer.py:486-596)."""
    import pandas as pd
    _, ivols_mma = pricer.compute_chain_prices_with_vols(
        option_chain=option_chain, params=params, is_spot_measure=True,
        variable_type=variable_type, **kwargs)
    _, ivols_inv = pricer.compute_chain_prices_with_vols(
        option_chain=option_chain, params=params, is_spot_measure=False,
        variable_type=variable_type, **kwargs)
    (mc_prices, mc_up_p, mc_down_p, mc_ivols, mc_ivols_up, mc_ivols_down, _) = \
        pricer.compute_mc_chain_implied_vols(
            option_chain=option_chain, params=params, nb_path=nb_path,
            variable_type=variable_type, is_spot_measure=True, **kwargs)

    if is_plot_vols:
        model_datas = {'MMA': ivols_mma, 'Inverse': ivols_inv}
        mc_mid, mc_lo, mc_hi = mc_ivols, mc_ivols_down, mc_ivols_up
    else:
        model_datas = {'MMA': ivols_mma, 'Inverse': ivols_inv}
        mc_mid, mc_lo, mc_hi = mc_prices, mc_down_p, mc_up_p

    fig, axs = _slice_axes(len(option_chain.ttms), figsize)
    for idx, ttm in enumerate(option_chain.ttms):
        if is_log_strike_xaxis:
            strikes = np.log(option_chain.strikes_ttms[idx] / option_chain.forwards[idx])
            strike_name = 'log-strike'
        elif variable_type == VariableType.Q_VAR:
            strikes = option_chain.strikes_ttms[idx] / option_chain.forwards[idx]
            strike_name = 'QVAR strike %'
        else:
            strikes = option_chain.strikes_ttms[idx]
            strike_name = 'strike'

        model_vols = {}
        for key, data in model_datas.items():
            mse = np.sqrt(np.nanmean(np.square(_np(data[idx])
                                               - _np(mc_mid[idx]))))
            model_vols[f"{key}: mse={mse:0.2%}"] = pd.Series(_np(data[idx]),
                                                             index=strikes)
        title = (f"{string.ascii_uppercase[idx]}) slice - {option_chain.ids[idx]}"
                 if option_chain.ids is not None else f"{ttm=:0.2f}")
        atm_vol = np.interp(x=option_chain.forwards[idx],
                            xp=option_chain.strikes_ttms[idx],
                            fp=0.5 * (_np(mc_lo[idx]) + _np(mc_hi[idx])))
        if is_log_strike_xaxis:
            atm_points = {'ATM': (0.0, atm_vol)}
        elif variable_type == VariableType.Q_VAR:
            atm_points = {'ATM': (1.0, atm_vol)}
        else:
            atm_points = {'ATM': (option_chain.forwards[idx], atm_vol)}
        plot.vol_slice_fit(
            bid_vol=pd.Series(_np(mc_lo[idx]), index=strikes),
            ask_vol=pd.Series(_np(mc_hi[idx]), index=strikes),
            model_vols=pd.DataFrame.from_dict(model_vols, orient='columns'),
            title=title, bid_name='MC: -0.95ci', ask_name='MC: +0.95ci',
            strike_name=strike_name, xvar_format=xvar_format,
            atm_points=atm_points,
            ylabel='Implied vols' if is_plot_vols else 'Model prices',
            yvar_format='{:.0%}' if is_plot_vols else '{:.2f}',
            ax=axs[idx], **kwargs)
    return fig


