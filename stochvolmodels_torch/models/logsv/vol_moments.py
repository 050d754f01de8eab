"""
Volatility moments and expected quadratic variance of the LogSV model
(Proposition 3.3 and Corollary 3.4 of Sepp & Rakhmonov 2024).

PyTorch counterpart of ``stochvolmodels_tpu/models/logsv/vol_moments.py``.
The truncated moment system d_tau M = Lambda M + C is solved in closed form
by matrix exponentials.  The host functions run numpy and scipy on the small
k* x k* system, as the JAX package does.  :func:`compute_analytic_qvar_torch`
takes float or tensor parameters and is differentiable: its three blocks
come from one ``torch.linalg.matrix_exp`` of the Van Loan augmented matrix
in float64 (the JAX package sums a Taylor series instead, because a TPU has
no float64 LU).  The backbone fit returns the etas indexed by ttm, a pandas
Series as in the JAX package (a :class:`SeriesLike` where pandas is not
installed), that ``LogSvParams.set_vol_backbone`` reads.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from stochvolmodels_torch.models.logsv.affine import f64_scalars
from stochvolmodels_torch.models.logsv.params import LogSvParams
from stochvolmodels_torch.utils.funcs import to_series


def compute_analytic_vol_moments(params: LogSvParams, t: float = 1.0, n_terms: int = 4,
                                 is_qvar: bool = False) -> np.ndarray:
    """moments of Y_tau = sigma_tau - theta (or their integrals over [0,
    tau]) by the closed form of Eqs. (3.49) and (3.54)."""
    import scipy.linalg as ssla
    lambda_m = params.get_vol_moments_lambda(n_terms=n_terms)
    y = params.sigma0 - params.theta
    y0 = np.power(y, np.arange(1, n_terms + 1, dtype=np.float64))
    if np.isclose(np.abs(t), 0.0):
        return y0

    rhs = np.zeros(n_terms)
    rhs[1] = params.vartheta2 * params.theta2
    # closure of Eq. (3.51): the (k*+1)-th moment frozen at its initial value
    rhs[-1] = -n_terms * params.kappa2 * np.power(y, n_terms + 1)

    i_m = np.linalg.inv(lambda_m)
    e_m = ssla.expm(lambda_m * t)
    m_rhs = i_m @ (e_m - np.eye(n_terms))

    if is_qvar:
        sol1 = m_rhs @ y0
        intm2 = i_m @ (m_rhs - t * np.eye(n_terms))
        sol2 = intm2 @ rhs
    else:
        sol1 = e_m @ y0
        sol2 = m_rhs @ rhs
    return sol1 + sol2


def compute_analytic_qvar(params: LogSvParams, ttm: float = 1.0, n_terms: int = 4) -> float:
    """annualised expected quadratic variance, Eq. (3.53): the model's fair
    variance-swap strike squared."""
    if np.isclose(ttm, 0.0):
        return float(np.square(params.sigma0))
    int_moments = compute_analytic_vol_moments(params=params, t=ttm, n_terms=n_terms,
                                               is_qvar=True)
    return float((int_moments[1] + 2.0 * params.theta * int_moments[0]) / ttm + params.theta2)


def compute_vol_moments_t(params: LogSvParams, ttm: np.ndarray, n_terms: int = 4,
                          is_print: bool = False) -> np.ndarray:
    """moments over an array of maturities."""
    moments = np.zeros((len(ttm), n_terms))
    for idx, t_ in enumerate(ttm):
        moments[idx, :] = compute_analytic_vol_moments(t=float(t_), params=params,
                                                       n_terms=n_terms)
        if is_print:
            print(f"t={t_}: {moments[idx]}")
    return moments


def compute_expected_vol_t(params: LogSvParams, t: np.ndarray, n_terms: int = 4) -> np.ndarray:
    """E[sigma_tau] = E[Y_tau] + theta over maturities."""
    return np.array([compute_analytic_vol_moments(t=float(t_), params=params,
                                                  n_terms=n_terms)[0] + params.theta
                     for t_ in t])


def compute_sqrt_qvar_t(params: LogSvParams, t: np.ndarray, n_terms: int = 4) -> np.ndarray:
    """the model's variance-swap rate sqrt(E[QV]) over maturities."""
    return np.array([np.sqrt(compute_analytic_qvar(ttm=float(t_), params=params,
                                                   n_terms=n_terms)) for t_ in t])


def compute_analytic_qvar_torch(sigma0, theta, kappa1, kappa2, beta, volvol, ttm: float,
                                n_terms: int = 4, device="cuda") -> torch.Tensor:
    """differentiable :func:`compute_analytic_qvar` (a 0-dim float64 tensor).

    Van Loan: expm([[L, I, 0], [0, 0, I], [0, 0, 0]] t) holds in its first
    block row [e^{Lt}, Phi1, Phi2] with Phi1 = int_0^t e^{Ls} ds and Phi2 =
    int_0^t int_0^s e^{Lu} du ds.  Parameters are floats or 0-dim tensors;
    the result lies on the first tensor parameter's device, else on ``device``.
    """
    params = (sigma0, theta, kappa1, kappa2, beta, volvol)
    device = next((p.device for p in params if isinstance(p, torch.Tensor)), device)
    sigma0, theta, kappa1, kappa2, beta, volvol = f64_scalars(device, *params)
    vartheta2 = beta * beta + volvol * volvol
    kappa = kappa1 + kappa2 * theta
    theta2 = theta * theta
    zero = torch.zeros((), dtype=torch.float64, device=device)
    entries = {(0, 0): -kappa, (0, 1): -kappa2, (1, 0): 2.0 * vartheta2 * theta,
               (1, 1): vartheta2 - 2.0 * kappa, (1, 2): -2.0 * kappa2}
    for n_ in range(2, n_terms):
        n = n_ + 1
        c_n = 0.5 * vartheta2 * n * (n - 1.0)
        entries[(n_, n_ - 2)] = c_n * theta2
        entries[(n_, n_ - 1)] = 2.0 * c_n * theta
        entries[(n_, n_)] = c_n - n * kappa
        if n_ + 1 < n_terms:
            entries[(n_, n_ + 1)] = -n * kappa2
    lambda_m = torch.stack([entries.get((i, j), zero) for i in range(n_terms)
                            for j in range(n_terms)]).reshape(n_terms, n_terms)
    y = sigma0 - theta
    y0 = torch.stack([y ** k for k in range(1, n_terms + 1)])
    rhs = torch.stack([zero, vartheta2 * theta2] + [zero] * (n_terms - 3)
                      + [-n_terms * kappa2 * y ** (n_terms + 1)])
    n = n_terms
    eye = torch.eye(n, dtype=torch.float64, device=device)
    blank = torch.zeros((n, n), dtype=torch.float64, device=device)
    aug = torch.cat([torch.cat([lambda_m, eye, blank], dim=1),
                     torch.cat([blank, blank, eye], dim=1),
                     torch.cat([blank, blank, blank], dim=1)], dim=0)
    e = torch.linalg.matrix_exp(aug * ttm)
    int_moments = e[:n, n:2 * n] @ y0 + e[:n, 2 * n:] @ rhs
    return (int_moments[1] + 2.0 * theta * int_moments[0]) / ttm + theta2


def fit_model_vol_backbone_to_varswaps(log_sv_params: LogSvParams, varswap_strikes,
                                       n_terms: int = 4, verbose: bool = False):
    """the backbone etas with which the model reprices the market varswap
    strikes (etas indexed by ttm, :func:`to_series`):
    :func:`backbone_etas_torch` on the host."""
    ttms = np.asarray(varswap_strikes.index, dtype=float)
    p = log_sv_params
    args = (p.sigma0, p.theta, p.kappa1, p.kappa2, p.beta, p.volvol, ttms,
            torch.as_tensor(np.array(varswap_strikes.to_numpy(), dtype=np.float64)), n_terms)
    model_eta = to_series(backbone_etas_torch(*args).numpy(), ttms)
    if verbose:
        market_qvar_dt, model_qvar_dt = (t.numpy() for t in _qvar_dts(*args))
        print(f"market_qvar_dt={market_qvar_dt}\nmodel_qvar_dt={model_qvar_dt}\n"
              f"model_eta={model_eta}")
    return model_eta


def _qvar_dts(sigma0, theta, kappa1, kappa2, beta, volvol, ttms: np.ndarray,
              varswap_strikes: torch.Tensor, n_terms: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(market, model) QV over each maturity: ttm x varswap strike^2 and
    ttm x the model's expected QV."""
    ttms_t = torch.as_tensor(np.asarray(ttms, dtype=np.float64), device=varswap_strikes.device)
    model_qvar_dt = torch.stack([
        compute_analytic_qvar_torch(sigma0, theta, kappa1, kappa2, beta, volvol, ttm=float(t),
                                    n_terms=n_terms, device=varswap_strikes.device) * float(t)
        for t in ttms])
    return ttms_t * torch.square(varswap_strikes), model_qvar_dt


def backbone_etas_torch(sigma0, theta, kappa1, kappa2, beta, volvol, ttms: np.ndarray,
                        varswap_strikes: torch.Tensor, n_terms: int = 4) -> torch.Tensor:
    """the backbone etas by the forward-difference bootstrap of the market
    against the model QV (etas <= 0 set to 1, the square root taken below
    ttm 0.06), a (T,) float64 tensor on ``varswap_strikes``' device,
    differentiable in the parameters (the varswap-fit calibration's etas)."""
    ttms_t = torch.as_tensor(np.asarray(ttms, dtype=np.float64), device=varswap_strikes.device)
    market_qvar_dt, model_qvar_dt = _qvar_dts(sigma0, theta, kappa1, kappa2, beta, volvol, ttms,
                                              varswap_strikes, n_terms)
    zero = market_qvar_dt.new_zeros(1)
    d_market = torch.diff(market_qvar_dt, prepend=zero)
    d_model = torch.diff(model_qvar_dt, prepend=zero)
    etas = d_market / d_model
    etas = torch.where(etas > 0.0, etas, 1.0)
    return torch.where(ttms_t < 0.06, torch.sqrt(etas), etas)
