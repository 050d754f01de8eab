"""
Parameters of the factor HJM model with a log-normal SV driver.

PyTorch port's copy of ``stochvolmodels_tpu/models/factor_hjm/rate_logsv_params.py``:
piecewise-constant term structures, the single-factor Cheyette parameter set,
and the multi-factor (Nelson-Siegel) parameter set with the annuity-measure
(Theorem 3.1, drift freezing Eq. 37) and T-forward measure transforms.

Measure transforms run on the host (scipy ODEs over small state vectors,
once per expiry during setup), with the right-hand sides in the JAX
package's arithmetic order so that scipy takes the same adaptive steps, and
emit the coefficient time series that the transform-grid ODE solver moves
to the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
from scipy.integrate import solve_ivp

from stochvolmodels_torch.models.factor_hjm.rate_factor_basis import (
    Cheyette1D,
    CheyettePEND,
    NelsonSiegel,
)
from stochvolmodels_torch.models.model_pricer import ModelParams
from stochvolmodels_torch.utils.rate_core import (
    G,
    bracket,
    generate_ttms_grid,
    get_default_swap_term_structure,
    pw_const,
)


@dataclass
class TermStructure:
    """piecewise-constant term structure on a tenor grid
    (rate_logsv_params.py:32-83)."""
    ts: np.ndarray
    xs: np.ndarray
    flat_extrapol: bool = False

    def __post_init__(self):
        if self.ts.ndim != 1:
            raise ValueError('ts must have 1 dimension')
        if self.xs.ndim not in (1, 2):
            raise ValueError('xs must have dimension of one or two')
        if self.ts.shape[0] - 1 != self.xs.shape[0]:
            raise ValueError('abscissas and ordinates must have same shape')

    def pw_const(self, t: float):
        return pw_const(self.ts, self.xs, t, self.flat_extrapol, shift=1)

    def interpolate(self, times: np.ndarray) -> np.ndarray:
        return np.array([self.pw_const(t) for t in times])

    @classmethod
    def create_from_scalar(cls, ts: np.ndarray, xs: float,
                           flat_extrapol: bool = False) -> "TermStructure":
        return TermStructure(ts=ts, xs=np.ones_like(ts[1:]) * xs,
                             flat_extrapol=flat_extrapol)

    @classmethod
    def create_multi_fact_from_vec(cls, ts: np.ndarray, xs: np.ndarray,
                                   flat_extrapol: bool = False) -> "TermStructure":
        assert xs.ndim == 1
        xs_ = np.tile(xs, (ts[1:].size, 1))
        return TermStructure(ts=ts, xs=xs_, flat_extrapol=flat_extrapol)


@dataclass
class RateLogSvParams(ModelParams):
    """single-factor (Cheyette) FHJM parameters with a LogSV driver
    (rate_logsv_params.py:87-258)."""
    sigma0: float
    theta: float
    kappa1: float
    kappa2: float
    alpha: TermStructure
    b: TermStructure
    beta: TermStructure
    volvol: TermStructure
    ccy: str
    basis: Cheyette1D
    term: float
    q: Optional[float] = None

    def calc_mean_states(self, expiry: float, t_grid: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """deterministic annuity-measure means of (x, y), Eq. (37)."""
        mrv_r = self.basis.meanrev
        ts_sw = get_default_swap_term_structure(expiry=expiry, tenor=self.term)

        def rhs(t, arg):
            x, y, sigma = arg
            a_t = self.alpha.pw_const(t)
            beta_t = self.beta.pw_const(t)
            ann0 = self.basis.annuity(t, ts_sw, x, y, ccy=self.ccy, m=0)
            ann1 = self.basis.annuity(t, ts_sw, x, y, ccy=self.ccy, m=1)
            loga_der = float(np.asarray(ann1).ravel()[0] / np.asarray(ann0).ravel()[0])
            return np.array([
                y - mrv_r * x + loga_der * a_t ** 2 * sigma ** 2,
                a_t ** 2 * sigma ** 2 - 2.0 * mrv_r * y,
                (self.kappa1 + self.kappa2 * sigma) * (self.theta - sigma)
                + a_t * beta_t * loga_der * sigma ** 2])

        sol = solve_ivp(fun=rhs, t_span=(0, expiry), t_eval=t_grid,
                        y0=np.array([0.0, 0.0, self.sigma0]))
        return sol.y[0, :], sol.y[1, :]

    def transform_QA_params(self, expiry: float, tenor: float,
                            t_grid: np.ndarray):
        """annuity-measure coefficient time series (Theorem 3.1)."""
        if self.q is None:
            self.q = self.theta
        q = self.q
        assert tenor == self.term
        ts_sw = get_default_swap_term_structure(expiry=expiry, tenor=tenor)
        if expiry not in t_grid:
            raise ValueError("expiry must be in grid")
        idx_ttm = np.where(t_grid == expiry)[0][0]
        t_grid = t_grid[:idx_ttm + 1]

        mx_grid, my_grid = self.calc_mean_states(expiry, t_grid)
        swap_der1 = np.ones_like(t_grid)
        ann = np.ones_like(t_grid)
        ann_der1 = np.ones_like(t_grid)
        for idx, (t, mx, my) in enumerate(zip(t_grid, mx_grid, my_grid)):
            swap_der1[idx] = np.asarray(self.basis.swap_rate(t, ts_sw, mx, my, ccy=self.ccy)[1]).ravel()[0]
            ann[idx] = np.asarray(self.basis.annuity(t, ts_sw, mx, my, ccy=self.ccy, m=0)).ravel()[0]
            ann_der1[idx] = np.asarray(self.basis.annuity(t, ts_sw, mx, my, ccy=self.ccy, m=1)).ravel()[0]
        loga_der = ann_der1 / ann

        alpha_interp = self.alpha.interpolate(t_grid)
        beta_interp = self.beta.interpolate(t_grid)
        volvol_interp = self.volvol.interpolate(t_grid)

        a = alpha_interp * swap_der1
        beta2 = beta_interp * loga_der
        term0 = (alpha_interp * beta2 * q ** 2 + (self.theta - q) * self.kappa1
                 + (self.theta - q) * self.kappa2 * q)
        term1 = (self.kappa1 - self.kappa2 * q
                 + 2.0 * (self.kappa2 - alpha_interp * beta2) * q
                 - (self.theta - q) * self.kappa2)
        term2 = self.kappa2 - alpha_interp * beta2
        return a, term0, term1, term2, beta_interp, volvol_interp, ts_sw

    def transform_QT_params(self, expiry: float, t_start: float, t_end: float,
                            t_grid: np.ndarray):
        """T-forward measure coefficients for futures options."""
        self.q = self.theta
        q = self.q
        alpha_interp = self.alpha.interpolate(t_grid)
        beta_interp = self.beta.interpolate(t_grid)
        volvol_interp = self.volvol.interpolate(t_grid)
        k = self.basis.meanrev
        G_t_T = G(k, t_grid, expiry)
        G_start_end = G(k, t_start, t_end)
        a = alpha_interp * G_start_end * np.exp(-k * (t_start - t_grid))
        eta = alpha_interp * G_t_T
        beta2 = beta_interp * G_t_T
        delta = a * eta
        term0 = alpha_interp * beta2 * q ** 2
        term1 = self.kappa1 - self.kappa2 * q + 2.0 * (self.kappa2 + alpha_interp * beta2) * q
        term2 = self.kappa2 + alpha_interp * beta2
        return a, delta, term0, term1, term2, beta_interp, volvol_interp

    def reduce(self, idx: int) -> "RateLogSvParams":
        return RateLogSvParams(
            sigma0=self.sigma0, theta=self.theta, kappa1=self.kappa1,
            kappa2=self.kappa2,
            alpha=TermStructure(self.alpha.ts[:idx + 1], self.alpha.xs[:idx]),
            b=TermStructure(self.b.ts[:idx + 1], self.b.xs[:idx]),
            beta=TermStructure(self.beta.ts[:idx + 1], self.beta.xs[:idx]),
            volvol=TermStructure(self.volvol.ts[:idx + 1], self.volvol.xs[:idx]),
            ccy=self.ccy, basis=self.basis, term=self.term)


TENOR_IDS = {'3m': 0.25, '6m': 0.5, '1y': 1.0, '2y': 2.0, '3y': 3.0, '4y': 4.0,
             '5y': 5.0, '7y': 7.0, '10y': 10.0, '31d': 31.0 / 365.0,
             '40d': 40.0 / 365.0, '66d': 66.0 / 365, '75d': 75.0 / 365,
             '84d': 84.0 / 365, '87d': 87.0 / 365, '103d': 103.0 / 365,
             '156d': 156.0 / 365, '194d': 194.0 / 365}


@dataclass
class MultiFactRateLogSvParams(ModelParams):
    """multi-factor FHJM parameters (rate_logsv_params.py:261-649)."""
    sigma0: float
    theta: float
    kappa1: float
    kappa2: float
    beta: TermStructure
    volvol: TermStructure
    A: np.ndarray
    R: np.ndarray
    basis: Union[NelsonSiegel, CheyettePEND]
    ccy: str
    vol_interpolation: str = "BY_YIELD"
    q: Optional[float] = None

    @classmethod
    def make_A_2d(cls, A: np.ndarray, ts: np.ndarray) -> np.ndarray:
        if A.ndim == 1:
            return np.tile(A, (ts.size - 1, 1))
        if A.ndim == 2:
            return A
        raise NotImplementedError

    def __post_init__(self):
        self.key_terms = self.basis.key_terms
        assert np.all(self.beta.ts == self.volvol.ts)
        self.A = MultiFactRateLogSvParams.make_A_2d(self.A, self.beta.ts)
        assert self.A.shape[0] == self.beta.ts.size - 1
        assert len(self.key_terms) == self.basis.nb_factors
        assert self.beta.xs.shape[1] == self.basis.nb_factors
        assert self.A.shape[1] == self.basis.nb_factors
        if self.vol_interpolation not in ("BY_YIELD", "DIRECT"):
            raise NotImplementedError("Wrong vol interpolation type")

        n_t, d = self.A.shape
        C = np.zeros((n_t, d, d))
        M = np.zeros((n_t, d, d))
        Omega = np.zeros((n_t, self.basis.nb_aux_factors))
        for idx, Ai in enumerate(self.A):
            Ci = self.calc_factor_vols(Ai)
            Mi = Ci @ Ci.T
            C[idx], M[idx], Omega[idx] = Ci, Mi, self.basis.calc_Omega(Mi)
        self.C, self.M, self.Omega = C, M, Omega
        self.ts = self.beta.ts

    def calc_factor_vols(self, yield_vols: np.ndarray) -> np.ndarray:
        """factor volatility matrix C(t) = B^-1 diag(vols) chol(R) (Eq. 7)."""
        assert yield_vols.ndim == 1 and yield_vols.shape[0] == self.basis.get_nb_factors()
        B = self.basis.get_matrix_B()
        R_chol = np.linalg.cholesky(self.R)
        return np.linalg.inv(B) @ np.diag(yield_vols) @ R_chol

    def calc_factor_vols_dln(self, yield_vols: np.ndarray, yields: np.ndarray,
                             b_dln: np.ndarray, nb_path: int) -> np.ndarray:
        """per-path factor vols under the displaced-log-normal skew."""
        d = self.basis.get_nb_factors()
        assert yield_vols.shape == (d,) and b_dln.shape == (d,)
        assert yields.shape == (nb_path, d)
        inv_B = np.linalg.inv(self.basis.get_matrix_B())
        R_chol = np.linalg.cholesky(self.R)
        vols = yield_vols[None, :] + yields * b_dln[None, :]
        out = np.einsum('ij,pj,jk->pik', inv_B, vols, R_chol)
        return out

    # ------------------------------------------------------------------
    # annuity-measure analytics (swaptions)
    # ------------------------------------------------------------------
    def calc_QA_mean_states(self, expiry: float, tenor: float,
                            t_grid: np.ndarray, x0: np.ndarray, y0: np.ndarray,
                            rtol: float = 1e-3, atol: float = 1e-6,
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """annuity-measure means of (X, Y) by the frozen-drift ODE.

        ``rtol``/``atol`` default to scipy's solve_ivp defaults; tighten
        them to build high-accuracy oracles."""
        ts_sw = get_default_swap_term_structure(expiry=expiry, tenor=tenor)
        sz_X = self.basis.nb_factors
        sz_Y = self.basis.nb_aux_factors
        D_X = self.basis.get_generating_matrix()
        D_Y = self.basis.get_aux_generating_matrix()

        def rhs(t, arg):
            x, y, sigma = arg[:sz_X], arg[sz_X:sz_X + sz_Y], arg[-1]
            idx_t = bracket(self.ts[1:], t, False)
            M_t, Omega_t, C_t = self.M[idx_t], self.Omega[idx_t], self.C[idx_t]
            beta_t = self.beta.pw_const(t)
            ann0 = np.asarray(self.basis.annuity(t, ts_sw, x, y, self.ccy, 0)).ravel()[0]
            ann1 = np.asarray(self.basis.annuity(t, ts_sw, x, y, self.ccy, 1))[0, :]
            loga_der = ann1 / ann0
            res = np.zeros(sz_X + sz_Y + 1)
            res[:sz_X] = D_X @ x + sigma ** 2 * (M_t @ loga_der)
            res[sz_X:sz_X + sz_Y] = D_Y @ y + sigma ** 2 * Omega_t
            vol_adj = beta_t @ C_t.T @ loga_der
            res[-1] = ((self.kappa1 + self.kappa2 * sigma) * (self.theta - sigma)
                       + sigma ** 2 * vol_adj)
            return res

        init = np.concatenate((x0, y0, np.array([self.sigma0])))
        sol = solve_ivp(fun=rhs, t_span=(0, expiry), t_eval=t_grid, y0=init,
                        rtol=rtol, atol=atol)
        return sol.y[:sz_X, :].T, sol.y[sz_X:sz_X + sz_Y, :].T

    def qa_structural_panels(self, expiry: float, tenor: float,
                             t_grid: np.ndarray,
                             x0: Optional[np.ndarray] = None,
                             y0: Optional[np.ndarray] = None,
                             rtol: float = 1e-3, atol: float = 1e-6):
        """frozen structural panels of the annuity-measure transform.

        Everything here depends on the basis, the factor-vol matrices C and
        the mean states — NOT on the calibratable (sigma0, beta, volvol)
        up to the standard frozen-coefficient approximation — so it can be
        precomputed on host once and reused across gradient iterations.

        Returns (t_grid_cut, ts_sw, idx_t, swap_gr (T,d), loga_der (T,d),
        C_panel (T,d,d)).
        """
        if x0 is None:
            x0 = np.zeros(self.basis.get_nb_factors())
        if y0 is None:
            y0 = np.zeros(self.basis.get_nb_aux_factors())
        ts_sw = get_default_swap_term_structure(expiry=expiry, tenor=tenor)
        if expiry not in t_grid:
            raise ValueError("expiry must be in grid")
        idx_ttm = np.where(t_grid == expiry)[0][0]
        t_grid = t_grid[:idx_ttm + 1]

        mx_grid, my_grid = self.calc_QA_mean_states(expiry=expiry, tenor=tenor,
                                                    t_grid=t_grid, x0=x0, y0=y0,
                                                    rtol=rtol, atol=atol)
        d = self.basis.nb_factors
        swap_gr = np.full((t_grid.size, d), np.nan)
        loga_der = np.full((t_grid.size, d), np.nan)
        for idx, (t, mx, my) in enumerate(zip(t_grid, mx_grid, my_grid)):
            swap_gr[idx, :] = np.asarray(self.basis.swap_rate(t, ts_sw, mx, my, ccy=self.ccy)[1]).ravel()
            ann0 = np.asarray(self.basis.annuity(t, ts_sw, mx, my, m=0, ccy=self.ccy)).ravel()[0]
            ann1 = np.asarray(self.basis.annuity(t, ts_sw, mx, my, m=1, ccy=self.ccy)).ravel()
            loga_der[idx, :] = ann1 / ann0
        idx_t = np.array([bracket(self.ts[1:], t, throw_if_not_found=True)
                          for t in t_grid])
        return t_grid, ts_sw, idx_t, swap_gr, loga_der, self.C[idx_t]

    def transform_QA_params(self, expiry: float, tenor: float,
                            t_grid: np.ndarray,
                            x0: Optional[np.ndarray] = None,
                            y0: Optional[np.ndarray] = None,
                            rtol: float = 1e-3, atol: float = 1e-6):
        """annuity-measure coefficient time series for the MGF ODE."""
        self.q = self.theta
        t_grid, ts_sw, idx_t, swap_gr, loga_der, C_panel = \
            self.qa_structural_panels(expiry=expiry, tenor=tenor,
                                      t_grid=t_grid, x0=x0, y0=y0,
                                      rtol=rtol, atol=atol)
        beta_interp = self.beta.xs[idx_t]
        volvol_interp = self.volvol.xs[idx_t]
        a_interp = np.einsum('td,tde->te', swap_gr, C_panel)
        beta2_interp = np.einsum('td,td->t', beta_interp,
                                 np.einsum('tde,td->te', C_panel, loga_der))

        term0 = beta2_interp * self.theta * self.theta
        term1 = (self.kappa1 - self.kappa2 * self.theta
                 + 2.0 * (self.kappa2 - beta2_interp) * self.theta)
        term2 = self.kappa2 - beta2_interp
        return a_interp, term0, term1, term2, beta_interp, volvol_interp, ts_sw

    # ------------------------------------------------------------------
    # T-forward measure analytics (futures)
    # ------------------------------------------------------------------
    def transform_QT_params(self, expiry: float, t_start: float, t_end: float,
                            t_grid: np.ndarray):
        """T-forward measure coefficient time series for futures options."""
        assert expiry <= t_start < t_end
        q = self.theta if self.q is None else self.q
        if expiry not in t_grid:
            raise ValueError("expiry must be in grid")
        idx_ttm = np.where(t_grid == expiry)[0][0]
        t_grid = t_grid[:idx_ttm + 1]
        d = self.basis.nb_factors
        a_interp = np.full((t_grid.size, d), np.nan)
        beta_interp = np.full((t_grid.size, d), np.nan)
        eta_interp = np.full((t_grid.size, d), np.nan)
        volvol_interp = np.full_like(t_grid, np.nan)
        term0 = np.full_like(t_grid, np.nan)
        term1 = np.full_like(t_grid, np.nan)
        term2 = np.full_like(t_grid, np.nan)
        for idx, t in enumerate(t_grid):
            idx_t = bracket(self.ts[1:], t, throw_if_not_found=True)
            beta_interp[idx, :] = self.beta.xs[idx_t]
            volvol_interp[idx] = self.volvol.xs[idx_t]
            B_P_end = self.basis.bond_coeffs(t_end - t)[0]
            B_P_start = self.basis.bond_coeffs(t_start - t)[0]
            B_P_exp = self.basis.bond_coeffs(expiry - t)[0]
            a_interp[idx, :] = self.C[idx_t].T @ (B_P_end - B_P_start)
            eta_interp[idx, :] = self.C[idx_t].T @ B_P_exp
            beta_x_eta = beta_interp[idx, :] @ eta_interp[idx, :]
            term0[idx] = -beta_x_eta * q ** 2
            term1[idx] = self.kappa1 - self.kappa2 * q + 2.0 * (self.kappa2 + beta_x_eta)
            term2[idx] = self.kappa2 + beta_x_eta
        return a_interp, eta_interp, term0, term1, term2, beta_interp, volvol_interp

    def check_QT_kappa2(self, t_start: float, t_end: Optional[float] = None) -> bool:
        if t_end is None:
            t_end = t_start + 0.25
        t_grid = generate_ttms_grid(np.array([t_start]))
        out = self.transform_QT_params(expiry=t_start, t_start=t_start,
                                       t_end=t_end, t_grid=t_grid)
        return bool(np.all(out[4] > 0.0))

    def check_QA_kappa2(self, expiry: float, tenor: float) -> bool:
        t_grid = generate_ttms_grid(np.array([expiry]))
        out = self.transform_QA_params(expiry=expiry, tenor=tenor, t_grid=t_grid)
        return bool(np.all(out[3] > 0.0))

    @classmethod
    def get_frac(cls, id: str) -> float:
        if id not in TENOR_IDS:
            raise NotImplementedError("id not found")
        return TENOR_IDS[id]

    def reduce(self, ids: List[str]) -> "MultiFactRateLogSvParams":
        ttms = [MultiFactRateLogSvParams.get_frac(id) for id in ids]
        assert set(ttms) <= set(self.ts)
        indices = np.isin(self.ts, ttms).nonzero()[0] - 1
        ts_indices = np.concatenate(([0], indices + 1))
        assert np.all(indices >= 0)
        return MultiFactRateLogSvParams(
            sigma0=self.sigma0, theta=self.theta, kappa1=self.kappa1,
            kappa2=self.kappa2,
            beta=TermStructure(self.beta.ts[ts_indices], self.beta.xs[indices]),
            volvol=TermStructure(self.volvol.ts[ts_indices], self.volvol.xs[indices]),
            A=self.A[indices, :], R=self.R, basis=self.basis, ccy=self.ccy,
            vol_interpolation=self.vol_interpolation, q=self.q)

    def update_params(self, idx: int, A_idx: Optional[np.ndarray] = None,
                      beta_idx: Optional[np.ndarray] = None,
                      volvol_idx: Optional[float] = None,
                      kappa1: Optional[float] = None,
                      kappa2: Optional[float] = None,
                      sigma0: Optional[float] = None) -> None:
        d = self.basis.get_nb_factors()
        if A_idx is not None:
            assert A_idx.shape == (d,)
            self.A[idx, :] = A_idx
        if beta_idx is not None:
            assert beta_idx.shape == (d,)
            self.beta.xs[idx, :] = beta_idx
        if volvol_idx is not None:
            self.volvol.xs[idx] = volvol_idx
        if kappa1 is not None:
            self.kappa1 = kappa1
        if kappa2 is not None:
            self.kappa2 = kappa2
        if sigma0 is not None:
            self.sigma0 = sigma0
        self.__post_init__()
