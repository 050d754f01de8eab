"""
Plain reference of the Heston model: the closed-form log-MGF (Sepp 2007,
formula 14) with the Riccati state (a, b) chained across maturities, the
Fourier prices, the Levenberg-Marquardt fit of (v0, theta, kappa, rho,
volvol) to vega-weighted mid vols with a sqrt(10)-scaled Feller penalty,
and the full-truncation Euler scheme of its Monte Carlo.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from . import common, mc

BOUNDS = ((0.01, 2.0), (0.01, 2.0), (0.1, 30.0), (-0.99, 0.99), (0.1, 5.0))
FIT_LOWER = np.array([b[0] for b in BOUNDS])
FIT_UPPER = np.array([b[1] for b in BOUNDS])
VAR_FLOOR = 1e-4


def _mgf(v0, theta, kappa, volvol, rho, ttm: float, phi, psi, a_t0, b_t0):
    volvol2 = volvol * volvol
    b1 = phi * (rho * volvol) + kappa
    b0 = phi * (phi + 1.0) * 0.5 - psi
    zeta = torch.sqrt(b1 * b1 - b0 * (2.0 * volvol2))
    exp_zeta = torch.exp(-zeta * ttm)
    psi_p = -b1 + zeta
    psi_m = b1 + zeta
    two_zeta = zeta * 2.0
    if b_t0 is None:
        c_p, c_m = psi_p / two_zeta, psi_m / two_zeta
    else:
        c_p = (psi_p + b_t0 * volvol2) / two_zeta
        c_m = (psi_m - b_t0 * volvol2) / two_zeta
    denom = c_p * exp_zeta + c_m
    b_t1 = -(psi_m * c_p * exp_zeta * (-1.0) + psi_p * c_m) / (denom * volvol2)
    a_t1 = (psi_p * ttm + torch.log(denom) * 2.0) * (-(theta * kappa / volvol2))
    if a_t0 is not None:
        a_t1 = a_t1 + a_t0
    return a_t1 + b_t1 * v0, a_t1, b_t1


def chain_prices(pars: torch.Tensor, p: Dict, vol_scaler: torch.Tensor) -> torch.Tensor:
    """(T, K) prices of the padded panel at (v0, theta, kappa, rho, volvol)."""
    v0, theta, kappa, rho, volvol = common.scalars(pars)
    phi = common.phi_grid(vol_scaler, pars.dtype, pars.device)
    psi = torch.zeros_like(phi)
    a_t, b_t, ttm0, prices = None, None, 0.0, []
    for i, ttm in enumerate(p["ttms_host"]):
        log_mgf, a_t, b_t = _mgf(v0, theta, kappa, volvol, rho, ttm - ttm0, phi, psi, a_t, b_t)
        prices.append(common.vanilla_prices(log_mgf, phi, p["forwards"][i], p["strikes"][i],
                                            p["is_call"][i], p["discfactors"][i]))
        ttm0 = ttm
    return torch.stack(prices, dim=0)


def fit(quotes: Dict, params0: Dict[str, float], nb_iters: int, year_steps: int = 0,
        dtype: torch.dtype = torch.float64, device="cuda") -> Tuple[np.ndarray, float]:
    """((v0, theta, kappa, rho, volvol) fit, cost) from ``params0``; the
    transform grid is frozen at min(0.3, sqrt(v0 ttm0)) of the start point.
    ``year_steps`` is unused: the MGF is closed-form."""
    panels = common.chain_panels(quotes)
    p = common.panel_tensors(panels, dtype, device)
    p["ttms_host"] = tuple(float(t) for t in panels["ttms"])
    start = np.array([params0[k] for k in ("v0", "theta", "kappa", "rho", "volvol")])
    vs = torch.tensor(float(np.minimum(0.3, np.sqrt(start[0] * panels["ttms"][0]))),
                      dtype=dtype, device=device)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)
    sqrt10 = math.sqrt(10.0)

    def residuals(pars):
        prices = chain_prices(pars, p, vs)
        vols = common.fast_ivols(prices, p["forwards"], p["strikes"], p["ttms"],
                                 p["discfactors"], p["is_call"])
        r = common.vol_residuals(vols, p["market"], p["sqrtw"])
        _, theta, kappa, _, volvol = common.scalars(pars)
        feller = torch.clamp(volvol * volvol - 2.0 * kappa * theta, min=0.0)
        return torch.cat([r, sqrt10 * feller])

    best, cost = common.levenberg_marquardt(residuals, t(start), t(FIT_LOWER), t(FIT_UPPER),
                                            nb_iters)
    return best.double().cpu().numpy(), float(cost)


def mc_prices(quotes: Dict, params: Dict[str, float], nb_path: int, seed: int, year_steps: int,
              dtype: torch.dtype = torch.float32, payoff_dtype: torch.dtype = torch.float64,
              device="cuda"):
    """MC chain prices and standard errors: the full-truncation Euler step in
    ``dtype`` (float32 scalars rounded from float64) on the counter stream."""
    f32 = np.float32

    def advance(seed_i, state, nb_steps, dt):
        x, var, qvar = state
        a = np.array([dt, np.sqrt(dt), params["theta"], params["kappa"], params["rho"],
                      params["volvol"]], dtype=np.float32)
        rho_1 = float(np.sqrt(f32(1.0) - a[4] * a[4]))
        dt32, sdt, theta, kappa, rho, volvol = (float(v) for v in a)
        normals = mc.Normals(seed_i, x.shape[0], x.device)
        for step in range(nb_steps):
            z0, z1 = normals.step(step)
            w0, w1 = (z0 * sdt).to(dtype), (z1 * sdt).to(dtype)
            sigma = torch.sqrt(var)
            var_dt = var * dt32
            x = (x - 0.5 * var_dt) + sigma * w0
            qvar = qvar + var_dt
            var = (var + (kappa * (theta - var)) * dt32) + (sigma * volvol) * (rho * w0 + rho_1 * w1)
            var = torch.clamp(var, min=VAR_FLOOR)
        return x, var, qvar

    def state0(n):
        return (torch.zeros(n, dtype=dtype, device=device),
                torch.full((n,), float(f32(params["v0"])), dtype=dtype, device=device),
                torch.zeros(n, dtype=dtype, device=device))

    return mc.mc_chain(advance, state0, quotes, nb_path, seed, year_steps, payoff_dtype)
