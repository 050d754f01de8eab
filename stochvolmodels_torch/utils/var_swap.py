"""
Model-free variance-swap strike from an OTM option strip.

PyTorch-package counterpart of ``stochvolmodels_tpu/utils/var_swap.py``:
host numpy, run once per chain, on plain arrays instead of pandas Series.
"""
from __future__ import annotations

import numpy as np


def compute_var_swap_strike(put_strikes: np.ndarray, put_prices: np.ndarray,
                            call_strikes: np.ndarray, call_prices: np.ndarray,
                            forward: float, ttm: float) -> float:
    """variance-swap strike (as a volatility) by static replication:

    K_var = (2/ttm) sum_i dk_i O(K_i)/K_i^2 - (F/K_atm - 1)^2 / ttm,

    over the put and call quotes joined on strike and sorted (the outer
    join of the JAX package's two Series: a strike quoted as both a put and
    a call is one row with both prices), O the put below the forward and the
    call at or above it, dk the centred strike spacings and K_atm the first
    strike at or above the forward.
    """
    put_strikes, call_strikes = np.asarray(put_strikes, float), np.asarray(call_strikes, float)
    strikes = np.union1d(put_strikes, call_strikes)

    def on_strikes(at, prices):
        out = np.full(strikes.shape, np.nan)
        out[np.searchsorted(strikes, at)] = np.asarray(prices, float)
        return out

    puts, calls = on_strikes(put_strikes, put_prices), on_strikes(call_strikes, call_prices)
    otm = strikes < forward
    n = strikes.shape[0]
    dk = np.empty(n)
    dk[0] = strikes[1] - strikes[0]
    dk[-1] = strikes[-1] - strikes[-2]
    if n > 2:
        dk[1:-1] = 0.5 * (strikes[2:] - strikes[:-2])
    option_strip = np.where(otm, puts, calls)
    var_swap_strike = 2.0 * np.nansum(dk * option_strip / np.square(strikes))
    atm_strike = strikes[~otm][0]
    correction = np.square(forward / atm_strike - 1.0)
    return float(np.sqrt((var_swap_strike - correction) / ttm))
