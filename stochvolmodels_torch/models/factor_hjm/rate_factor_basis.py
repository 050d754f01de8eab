"""
Yield-curve factor bases for the factor HJM framework (Sec. 2 of Sepp &
Rakhmonov 2025, RDR 28:12).

PyTorch port's copy of ``stochvolmodels_tpu/models/factor_hjm/rate_factor_basis.py``.
The forward curve decomposes as f_t(tau) = B(tau) X_t + B~(tau) Y_t + f0;
bonds follow P = P0 ratio * exp(-B_P X - B~_P Y) with the integrated bases.
Three bases: single-factor Cheyette, 3-factor Nelson-Siegel (production), and
piecewise-exponential CheyettePEND.

All basis evaluations are plain host numpy, as in the JAX package (they
produce the constant coefficient panels that the pricers move to the device
once); the per-path bond/annuity/swap formulas broadcast over (path, factor)
panels.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from stochvolmodels_torch.utils.rate_core import bond, swap_grad


class BasisHJM(ABC):
    """abstract yield-curve basis (rate_factor_basis.py:32-163)."""

    @abstractmethod
    def get_basis(self, tau: float) -> np.ndarray:
        """main basis B(tau)."""

    @abstractmethod
    def get_aux_basis(self, tau: float) -> np.ndarray:
        """auxiliary basis B~(tau)."""

    @abstractmethod
    def bond_coeffs(self, tau: float) -> Tuple[np.ndarray, np.ndarray]:
        """integrated coefficients (B_P(tau), B~_P(tau))."""

    @abstractmethod
    def calc_Omega(self, M: np.ndarray) -> np.ndarray:
        """auxiliary drift Omega for the factor covariance M."""

    def _bond(self, nb_factors: int, nb_aux_factors: int, t: float, T: float,
              x: np.ndarray, y: np.ndarray, ccy: str, m: int = 0) -> np.ndarray:
        assert t <= T
        assert x.shape[-1] == nb_factors and y.shape[-1] == nb_aux_factors
        B_PX, B_PY = self.bond_coeffs(T - t)
        return bond(t, T, x, y, B_PX, B_PY, ccy, m)

    def _get_matrix_B(self, nb_factors: int, key_terms: np.ndarray) -> np.ndarray:
        """matrix of average basis values across the key tenors."""
        B = np.zeros((key_terms.size, nb_factors))
        for idx, tau in enumerate(key_terms):
            B[idx, :] = self.bond_coeffs(tau)[0] / tau
        return B

    def annuity(self, t: float, ts_sw: np.ndarray, x: np.ndarray, y: np.ndarray,
                ccy: str, m: int = 0) -> np.ndarray:
        """swap annuity — the Q^A numeraire."""
        ann = 0.0
        for i in range(1, ts_sw.size):
            ann = ann + (ts_sw[i] - ts_sw[i - 1]) * self.bond(t, ts_sw[i], x, y, ccy, m)
        return ann

    def swap_rate(self, t: float, ts_sw: np.ndarray, x: np.ndarray,
                  y: np.ndarray, ccy: str) -> Tuple[np.ndarray, np.ndarray]:
        """par swap rate and its gradient w.r.t. the factor state (Eq. 28)."""
        denumer0, denumer1 = 0.0, 0.0
        for i in range(1, ts_sw.size):
            dcf = ts_sw[i] - ts_sw[i - 1]
            denumer0 = denumer0 + dcf * self.bond(t, ts_sw[i], x, y, ccy=ccy, m=0)
            denumer1 = denumer1 + dcf * self.bond(t, ts_sw[i], x, y, ccy=ccy, m=1)
        numer0 = self.bond(t, ts_sw[0], x, y, ccy=ccy, m=0) - self.bond(t, ts_sw[-1], x, y, ccy=ccy, m=0)
        numer1 = self.bond(t, ts_sw[0], x, y, ccy=ccy, m=1) - self.bond(t, ts_sw[-1], x, y, ccy=ccy, m=1)
        value0 = numer0 / denumer0
        value1 = swap_grad(numer0=numer0, numer1=numer1, denumer0=denumer0,
                           denumer1=denumer1)
        return value0, value1

    def libor_rate(self, t: float, t_start: float, t_end: float, x: np.ndarray,
                   y: np.ndarray, ccy: str) -> np.ndarray:
        """simply compounded forward rate over the accrual period."""
        zcb_start = self.bond(t, t_start, x, y, ccy=ccy, m=0)
        zcb_end = self.bond(t, t_end, x, y, ccy=ccy, m=0)
        return (zcb_start / zcb_end - 1.0) / (t_end - t_start)

    def calculate_swap_rate(self, ttm: float, x0: np.ndarray, y0: np.ndarray,
                            I0: np.ndarray, ts_sw: np.ndarray, ccy: str):
        """(swap rate, annuity, numeraire) across simulated paths
        (rate_factor_basis.py:150-163)."""
        s_mc = self.swap_rate(t=ttm, ts_sw=ts_sw, x=x0, y=y0, ccy=ccy)[0]
        ann_mc = self.annuity(t=ttm, ts_sw=ts_sw, x=x0, y=y0, m=0, ccy=ccy)
        numer = (1.0 / self.bond(t=0, T=ttm, x=np.zeros((1, x0.shape[1])),
                                 y=np.zeros((1, y0.shape[1])), m=0, ccy=ccy)
                 * np.exp(I0))
        return s_mc, ann_mc, numer


@dataclass
class Cheyette1D(BasisHJM):
    """single-factor exponential basis (rate_factor_basis.py:169-264)."""
    meanrev: float

    def __post_init__(self):
        assert self.meanrev > 0
        self.nb_factors = Cheyette1D.get_nb_factors()
        self.nb_aux_factors = Cheyette1D.get_nb_aux_factors()

    @classmethod
    def get_nb_factors(cls) -> int:
        return 1

    @classmethod
    def get_nb_aux_factors(cls) -> int:
        return 1

    def get_basis(self, tau: float) -> np.ndarray:
        raise NotImplementedError("not supported for Cheyette1D")

    def get_aux_basis(self, tau: float) -> np.ndarray:
        raise NotImplementedError("not supported for Cheyette1D")

    def get_generating_matrix(self) -> np.ndarray:
        raise NotImplementedError("not supported for Cheyette1D")

    def get_aux_generating_matrix(self) -> np.ndarray:
        raise NotImplementedError("not supported for Cheyette1D")

    def calc_Omega(self, M: np.ndarray) -> np.ndarray:
        raise NotImplementedError("not supported for Cheyette1D")

    def bond_coeffs(self, tau: float) -> Tuple[np.ndarray, np.ndarray]:
        G_tau = (1.0 - np.exp(-self.meanrev * tau)) / self.meanrev
        return np.array([G_tau]), np.array([0.5 * G_tau * G_tau])

    def bond(self, t: float, T: float, x, y, ccy: str, m: int = 0) -> np.ndarray:
        assert t <= T
        x, y = np.atleast_1d(np.asarray(x, dtype=float)), np.atleast_1d(np.asarray(y, dtype=float))
        B_PX, B_PY = self.bond_coeffs(T - t)
        return bond(t, T, x, y, B_PX, B_PY, ccy, m)


@dataclass
class NelsonSiegel(BasisHJM):
    """3-factor Nelson-Siegel basis [1, e^{-l tau}, tau e^{-l tau}]
    (rate_factor_basis.py:270-380) — the production basis."""
    meanrev: float
    key_terms: np.ndarray

    def __post_init__(self):
        assert self.meanrev > 0
        self.nb_factors = NelsonSiegel.get_nb_factors()
        self.nb_aux_factors = NelsonSiegel.get_nb_aux_factors()
        assert self.key_terms.size == self.nb_factors

    @classmethod
    def get_nb_factors(cls) -> int:
        return 3

    @classmethod
    def get_nb_aux_factors(cls) -> int:
        return 8

    def get_basis(self, tau: float) -> np.ndarray:
        e = np.exp(-self.meanrev * tau)
        return np.array([1.0, e, tau * e])

    def get_aux_basis(self, tau: float) -> np.ndarray:
        e = np.exp(-self.meanrev * tau)
        e2 = np.exp(-2.0 * self.meanrev * tau)
        return np.array([1.0, tau, e, tau * e, 0.5 * tau * tau * e,
                         e2, tau * e2, 0.5 * tau * tau * e2])

    def get_generating_matrix(self) -> np.ndarray:
        D = np.zeros((self.nb_factors, self.nb_factors))
        D[1, 1] = D[2, 2] = -self.meanrev
        D[1, 2] = 1.0
        return D

    def get_aux_generating_matrix(self) -> np.ndarray:
        D = np.zeros((self.nb_aux_factors, self.nb_aux_factors))
        D[0, 1] = 1.0
        D[2, 2] = D[3, 3] = D[4, 4] = -self.meanrev
        D[2, 3] = D[3, 4] = 1.0
        D[5, 5] = D[6, 6] = D[7, 7] = -2.0 * self.meanrev
        D[5, 6] = D[6, 7] = 1.0
        return D

    def get_matrix_B(self) -> np.ndarray:
        return self._get_matrix_B(self.nb_factors, self.key_terms)

    def calc_Omega(self, M: np.ndarray) -> np.ndarray:
        """auxiliary drift (Eq. 5) for the given factor covariance
        (rate_factor_basis.py:339-355)."""
        assert M.shape == (self.nb_factors, self.nb_factors)
        mrv = self.meanrev
        mrv2 = mrv * mrv
        Omega = np.zeros(self.nb_aux_factors)
        Omega[0] = M[0, 1] / mrv + M[0, 2] / mrv2
        Omega[1] = M[0, 0]
        Omega[2] = -M[0, 1] / mrv - M[0, 2] / mrv2 + M[1, 1] / mrv + M[1, 2] / mrv2
        Omega[3] = M[0, 1] - M[0, 2] / mrv + M[1, 2] / mrv + M[2, 2] / mrv2
        Omega[4] = 2.0 * M[0, 2]
        Omega[5] = -M[1, 1] / mrv - M[1, 2] / mrv2
        Omega[6] = -2.0 / mrv * M[1, 2] - 1.0 / mrv2 * M[2, 2]
        Omega[7] = -2.0 / mrv * M[2, 2]
        return Omega

    def bond(self, t: float, T: float, x, y, ccy: str, m: int = 0) -> np.ndarray:
        return self._bond(self.nb_factors, self.nb_aux_factors, t, T,
                          np.asarray(x, dtype=float), np.asarray(y, dtype=float),
                          ccy, m)

    def bond_coeffs(self, tau: float) -> Tuple[np.ndarray, np.ndarray]:
        mrv = self.meanrev
        mrv2, mrv3 = mrv * mrv, mrv ** 3
        mt = mrv * tau
        mt2 = mt * mt
        e = np.exp(-mt)
        e2 = np.exp(-2.0 * mt)
        B_PX = np.array([tau, (1.0 - e) / mrv, (1.0 - e * (1.0 + mt)) / mrv2])
        B_PY = np.array([tau, 0.5 * tau * tau,
                         (1.0 - e) / mrv, (1.0 - e * (1.0 + mt)) / mrv2,
                         (1.0 - e * (1.0 + mt + 0.5 * mt2)) / mrv3,
                         0.5 * (1.0 - e2) / mrv,
                         0.25 * (1.0 - e2 * (1.0 + 2.0 * mt)) / mrv2,
                         0.125 * (1.0 - e2 * (1.0 + 2.0 * mt + 2.0 * mt2)) / mrv3])
        return B_PX, B_PY


@dataclass
class CheyettePEND(BasisHJM):
    """piecewise-exponential multi-factor basis (rate_factor_basis.py:387-493)."""
    mrv0: float
    mrv_delta: float
    key_terms: np.ndarray

    def __post_init__(self):
        assert self.mrv0 > 0 and self.mrv_delta > 0
        self.nb_factors = CheyettePEND.get_nb_factors()
        self.nb_aux_factors = CheyettePEND.get_nb_aux_factors()
        assert self.key_terms.size == self.nb_factors

    @classmethod
    def get_nb_factors(cls) -> int:
        return 3

    @classmethod
    def get_nb_aux_factors(cls) -> int:
        d = cls.get_nb_factors()
        return d + 2 * d - 1

    def calc_mrvs(self) -> np.ndarray:
        return np.arange(self.mrv0, self.mrv0 + self.mrv_delta * self.nb_factors - 1e-6,
                         self.mrv_delta)

    def calc_mrvs_extra(self) -> np.ndarray:
        return np.arange(2.0 * self.mrv0,
                         2.0 * self.mrv0 + self.mrv_delta * (2.0 * self.nb_factors - 2.0) + 1e-6,
                         self.mrv_delta)

    def get_basis(self, tau: float) -> np.ndarray:
        return np.exp(-self.calc_mrvs() * tau)

    def get_aux_basis(self, tau: float) -> np.ndarray:
        return np.concatenate((np.exp(-self.calc_mrvs() * tau),
                               np.exp(-self.calc_mrvs_extra() * tau)))

    def get_generating_matrix(self) -> np.ndarray:
        return -np.diag(self.calc_mrvs())

    def get_aux_generating_matrix(self) -> np.ndarray:
        return -np.diag(np.concatenate((self.calc_mrvs(), self.calc_mrvs_extra())))

    def get_matrix_B(self) -> np.ndarray:
        return self._get_matrix_B(self.nb_factors, self.key_terms)

    def calc_Omega(self, M: np.ndarray) -> np.ndarray:
        assert M.shape == (self.nb_factors, self.nb_factors)
        mrvs = self.calc_mrvs()
        mrvs_extra = self.calc_mrvs_extra()
        Omega = np.zeros(self.nb_aux_factors)
        for i in range(mrvs.size):
            Omega[i] = np.dot(M[i, :], 1.0 / mrvs)
        for k in range(mrvs_extra.size):
            sum_fix_k = 0.0
            for i, j in zip(range(k, -1, -1), range(0, k + 1, 1)):
                if 0 <= i < self.nb_factors and 0 <= j < self.nb_factors:
                    sum_fix_k -= M[i, j] / mrvs[j]
            Omega[mrvs.size + k] = sum_fix_k
        return Omega

    def bond(self, t: float, T: float, x, y, ccy: str, m: int = 0) -> np.ndarray:
        return self._bond(self.nb_factors, self.nb_aux_factors, t, T,
                          np.asarray(x, dtype=float), np.asarray(y, dtype=float),
                          ccy, m)

    def bond_coeffs(self, tau: float) -> Tuple[np.ndarray, np.ndarray]:
        mrvs = self.calc_mrvs()
        mrvs_extra = self.calc_mrvs_extra()
        B_PX = (1.0 - np.exp(-mrvs * tau)) / mrvs
        B_PY = np.concatenate((B_PX, (1.0 - np.exp(-mrvs_extra * tau)) / mrvs_extra))
        return B_PX, B_PY
