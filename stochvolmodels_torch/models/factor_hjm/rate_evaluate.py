"""
Standalone Cheyette curve evaluation: bonds, annuities, par rates and their
derivatives up to fourth order.

PyTorch-port copy of ``stochvolmodels_tpu/models/factor_hjm/rate_evaluate.py``
(single-factor exponential basis on a flat discount curve), host numpy.
"""
from __future__ import annotations

import numpy as np

from stochvolmodels_torch.utils.rate_core import to_yearfrac


def init_mean_rev() -> float:
    """module-level mean reversion used by the curve helpers."""
    return 0.025


class Discount:
    """flat deterministic discount curve."""

    def __init__(self, currency: str = "USD"):
        self.today = 0
        if currency == "USD":
            self.r = 0.043
        elif currency == "JPY":
            self.r = 0.008
        else:
            raise NotImplementedError

    def df(self, d) -> float:
        return np.exp(-self.r * to_yearfrac(self.today, d))


def G(t, T):
    """G(t, T) = (1 - exp(-k (T - t))) / k at the module mean reversion."""
    k = init_mean_rev()
    return (1.0 - np.exp(-k * (T - t))) / k


def bond(t, T, x, y, m: int, is_mc_mode: bool, discount: Discount = None):
    """bond price times (-G)^m, the m-th state derivative."""
    if discount is None:
        discount = Discount()
    if m < 0 or m > 4:
        raise ValueError('parameter m must be 0,1,2,3,4')
    k = init_mean_rev()
    G_ = (1.0 - np.exp(-k * (T - t))) / k
    bond_value = (discount.df(T) / discount.df(t)
                  * np.exp(-G_ * x - 0.5 * G_ ** 2 * y))
    return bond_value * np.power(-G_, m)


def annuity(t, ts_sw: np.ndarray, x, y, m, discount: Discount = None,
            is_mc_mode: bool = False):
    """swap annuity and its state derivatives."""
    if discount is None:
        discount = Discount()
    ann = 0.0
    for i in range(1, ts_sw.size):
        ann = ann + (ts_sw[i] - ts_sw[i - 1]) * bond(t, ts_sw[i], x, y, m,
                                                     discount=discount,
                                                     is_mc_mode=is_mc_mode)
    return ann


def swap_rate(t, ts_sw: np.ndarray, x, y, discount: Discount = None,
              is_mc_mode: bool = False):
    """par swap rate and its first four state derivatives."""
    if discount is None:
        discount = Discount()
    den = [annuity(t, ts_sw, x, y, m, discount=discount, is_mc_mode=is_mc_mode)
           for m in range(5)]
    num = [bond(t, ts_sw[0], x, y, m, discount=discount, is_mc_mode=is_mc_mode)
           - bond(t, ts_sw[-1], x, y, m, discount=discount, is_mc_mode=is_mc_mode)
           for m in range(5)]
    d0, d1, d2, d3, d4 = den
    n0, n1, n2, n3, n4 = num

    value0 = n0 / d0
    value1 = n1 / d0 - (n0 * d1) / d0 ** 2
    value2 = (-2 * n1 * d1) / d0 ** 2 + n2 / d0 + n0 * ((2 * d1 ** 2) / d0 ** 3 - d2 / d0 ** 2)
    value3 = ((-3 * d1 * n2) / d0 ** 2
              + 3 * n1 * ((2 * d1 ** 2) / d0 ** 3 - d2 / d0 ** 2)
              + n3 / d0
              + n0 * ((-6 * d1 ** 3) / d0 ** 4 + (6 * d1 * d2) / d0 ** 3 - d3 / d0 ** 2))
    value4 = ((24 * n0 * d1 ** 4
               - 12 * d0 * d1 ** 2 * (2 * n1 * d1 + 3 * n0 * d2)
               + 2 * d0 ** 2 * (6 * d1 ** 2 * n2 + 3 * n0 * d2 ** 2
                                + 4 * d1 * (3 * n1 * d2 + n0 * d3))
               + d0 ** 4 * n4
               - d0 ** 3 * (6 * n2 * d2 + 4 * d1 * n3 + 4 * n1 * d3 + n0 * d4))
              / d0 ** 5)
    return value0, value1, value2, value3, value4


def libor_rate(t, t_start: float, t_end: float, x, y,
               discount: Discount = None, is_mc_mode: bool = False):
    """simply compounded forward rate over the accrual period."""
    if discount is None:
        discount = Discount()
    zcb_start = bond(t, t_start, x, y, 0, discount=discount, is_mc_mode=is_mc_mode)
    zcb_end = bond(t, t_end, x, y, 0, discount=discount, is_mc_mode=is_mc_mode)
    return (zcb_start / zcb_end - 1.0) / (t_end - t_start)
