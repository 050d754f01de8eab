"""
Interest-rate conventions: discount factors, bonds, swap and Libor rates.

The port's own copy of ``stochvolmodels_tpu/utils/rate_core.py`` (host
numpy, the same arithmetic in the same order): a leaf module consumed by the
factor-HJM pricers and the swaption chain container.  Discount factors come
from :func:`df_fast`, a hardcoded flat-curve stub.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np


def bracket(ts: np.ndarray, t: float, throw_if_not_found: bool = False) -> int:
    """index of the first element of ``ts`` at or above ``t``, or -1."""
    idxs = np.nonzero(t <= np.asarray(ts))[0]
    if idxs.size == 0:
        if throw_if_not_found:
            raise ValueError('t is not bracketed')
        return -1
    return int(idxs[0])


def pw_const(ts: np.ndarray, vs: np.ndarray, t: float,
             flat_extrapol: bool = False, shift: int = 0
             ) -> Union[float, np.ndarray]:
    """piecewise-constant interpolation of ``vs`` on knots ``ts`` at ``t``."""
    assert shift in (0, 1)
    ts = np.asarray(ts)
    vs = np.asarray(vs)
    if ts.shape[0] - shift != vs.shape[0]:
        raise ValueError('abscissas and ordinates must have same shape')
    idx0 = bracket(ts[shift:], t, False)
    value = vs[idx0]
    if flat_extrapol and t >= ts[-1]:
        value = vs[-1]
    return value


def get_default_swap_term_structure(expiry: float, tenor: float) -> np.ndarray:
    """annual payment dates of a swap starting at expiry over the tenor."""
    freq = 1.0
    return np.arange(expiry, expiry + tenor + freq, freq)


def get_futures_start_and_pmt(t0: float, lag: float,
                              libor_tenor: float = 0.25) -> Tuple[float, float]:
    """accrual start and end of the Libor period under a futures contract."""
    start = t0 + lag
    return start, start + libor_tenor


def df_fast(t: Union[float, np.ndarray], ccy: str = "USD"):
    """discount factor from a hardcoded flat (or Nelson-Siegel) zero rate —
    a stub, not a market curve (rate_core.py:86-112)."""
    if ccy == "USD":
        r = 0.043
    elif ccy == "JPY":
        r = 0.008
    elif ccy == "USD_NS":
        lamda = 0.55 / 12
        beta1, beta2, beta3 = 0.0436, 0.013, -0.01
        t = np.maximum(t, 1e-4)
        lt = lamda * t
        r = (beta1 + beta2 * (1.0 - np.exp(-lt)) / lt
             + beta3 * ((1.0 - np.exp(-lt)) / lt - np.exp(-lt)))
    else:
        raise NotImplementedError
    return np.exp(-r * t)


def generate_ttms_grid(ttms: np.ndarray, nb_pts: int = 11) -> np.ndarray:
    """union of uniform sub-grids spanning consecutive maturities, from zero."""
    t0 = 0.0
    t_grid = np.array([0.0])
    for ttm in ttms:
        sub = np.linspace(t0, ttm, nb_pts)
        t_grid = np.concatenate((t_grid, sub[1:]), axis=None)
        t0 = ttm
    return t_grid


def to_yearfrac(d1, d2):
    """year fraction between two dates already expressed in years."""
    return d2 - d1


def bond_grad(bond_value, B_PX):
    """dB/dx_i = B * b_i across states."""
    return bond_value[:, None] * B_PX[None, :]


def swap_grad(numer0, numer1, denumer0, denumer1) -> np.ndarray:
    """quotient rule d(N/D) = dN/D - N dD / D^2, scalar or per-state."""
    numer0, numer1 = np.asarray(numer0), np.asarray(numer1)
    denumer0, denumer1 = np.asarray(denumer0), np.asarray(denumer1)
    if numer0.ndim == numer1.ndim == denumer0.ndim == denumer1.ndim:
        return numer1 / denumer0 - (numer0 * denumer1) / np.square(denumer0)
    assert numer0.ndim == 1 and denumer0.ndim == 1
    assert numer1.ndim == 2 and denumer1.ndim == 2
    return (numer1 / denumer0[:, None]
            - (numer0[:, None] * denumer1) / np.square(denumer0)[:, None])


def divide_mc(arr2d, arr1d):
    """divide each column of a (path, state) array by a per-path vector."""
    return np.asarray(arr2d) / np.asarray(arr1d)[:, None]


def prod_mc(arr2d, arr1d):
    """multiply each column of a (path, state) array by a per-path vector."""
    return np.asarray(arr2d) * np.asarray(arr1d)[:, None]


def bond(t: float, T: float, x, y, B_PX: np.ndarray, B_PY: np.ndarray,
         ccy: str, m: int = 0):
    """bond value (m=0) or gradient dB/dx_i (m=1) from the integrated bases
    (rate_core.py:185-208)."""
    assert t <= T
    x, y = np.asarray(x), np.asarray(y)
    assert m in (0, 1)
    bond_value = np.atleast_1d(df_fast(T, ccy) / df_fast(t, ccy)
                               * np.exp(-B_PX.dot(np.transpose(x))
                                        - B_PY.dot(np.transpose(y))))
    if m == 0:
        return bond_value
    return bond_grad(bond_value, -B_PX)


def swap_rate(ccy: str, t: float, ts_sw: np.ndarray):
    """par swap rate for the schedule ``ts_sw`` at time t off the stub curve."""
    denumer0 = 0.0
    for i in range(1, ts_sw.size):
        denumer0 += (ts_sw[i] - ts_sw[i - 1]) * df_fast(ts_sw[i], ccy) / df_fast(t, ccy)
    numer0 = df_fast(ts_sw[0], ccy) / df_fast(t, ccy) - df_fast(ts_sw[-1], ccy) / df_fast(t, ccy)
    return numer0 / denumer0


def libor_rate(ccy: str, t: float, tenor: float):
    """simply compounded forward rate over [t, t+tenor] off the stub curve."""
    return (df_fast(t, ccy=ccy) / df_fast(t + tenor, ccy=ccy) - 1.0) / tenor


def G(k, t, T):
    """Hull-White factor G(t, T) = (1 - exp(-k (T - t))) / k."""
    return (1.0 - np.exp(-k * (T - t))) / k
