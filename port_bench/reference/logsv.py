"""
Plain reference of the log-normal stochastic volatility model (Sepp &
Rakhmonov, "Log-normal stochastic volatility model with quadratic drift",
IJTAF 2024): the second-order affine expansion of its MGF (Eq. 4.14) by
fixed-step RK4 with the state chained across maturities, the Fourier prices,
the PARAMS5 Levenberg-Marquardt fit to vega-weighted mid vols, and the
float32 Euler scheme of its Monte Carlo (log-sigma, spot measure).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import common, mc

# PARAMS5 [sigma0, theta, kappa1, beta, volvol] box of the LM fit (kappa2 = kappa1 / theta)
LOWER = np.array([0.1, 0.1, 0.25, -3.0, 0.2])
UPPER = np.array([1.5, 1.5, 10.0, 3.0, 3.0])
FIT_LOWER, FIT_UPPER = LOWER, UPPER
N_TERMS = 5
FREEZE_CAP = 1e6


def _terms(theta, kappa1, kappa2, beta, volvol):
    """the nonzero entries of (M, L0, L1, h) of the second-order expansion
    under the spot measure, vol backbone 1, as {index: value}."""
    theta2 = theta * theta
    vartheta2 = beta * beta + volvol * volvol
    qv = theta * vartheta2
    qv2 = theta2 * vartheta2
    bb = beta * 1.0
    lamda = 0.0 * theta
    kappa2_p = kappa2
    kappa_p = kappa1 + kappa2 * theta
    M = {(0, 1, 1): 0.5 * qv2, (1, 1, 1): qv, (1, 1, 2): qv2, (1, 2, 1): qv2,
         (2, 1, 1): 0.5 * vartheta2, (2, 2, 2): 2.0 * qv2,
         (2, 2, 1): 2.0 * qv, (2, 1, 2): 2.0 * qv,
         (2, 1, 3): 1.5 * qv2, (2, 3, 1): 1.5 * qv2, (3, 2, 2): 4.0 * qv,
         (3, 1, 2): vartheta2, (3, 2, 1): vartheta2,
         (3, 1, 3): 3.0 * qv, (3, 3, 1): 3.0 * qv,
         (3, 1, 4): 2.0 * qv2, (3, 4, 1): 2.0 * qv2,
         (3, 2, 3): 3.0 * qv2, (3, 3, 2): 3.0 * qv2,
         (4, 2, 2): 2.0 * vartheta2, (4, 3, 3): 4.5 * qv2,
         (4, 1, 3): 1.5 * vartheta2, (4, 3, 1): 1.5 * vartheta2,
         (4, 1, 4): 4.0 * qv, (4, 4, 1): 4.0 * qv,
         (4, 2, 3): 6.0 * qv, (4, 3, 2): 6.0 * qv,
         (4, 2, 4): 4.0 * qv2, (4, 4, 2): 4.0 * qv2}
    L0 = {(0, 1): lamda, (0, 2): qv2, (1, 1): -kappa_p, (1, 2): 2.0 * (lamda + qv),
          (2, 1): -kappa2_p, (2, 2): vartheta2 - 2.0 * kappa_p,
          (1, 3): 3.0 * qv2, (2, 3): 6.0 * qv, (2, 4): 6.0 * qv2,
          (3, 2): -2.0 * kappa2_p, (3, 3): 3.0 * (vartheta2 - kappa_p),
          (3, 4): 12.0 * qv, (4, 3): -3.0 * kappa2_p,
          (4, 4): 2.0 * (vartheta2 - 2.0 * kappa_p)}
    L1 = {(0, 1): -theta2 * bb, (1, 1): -2.0 * theta * bb, (1, 2): -2.0 * theta2 * bb,
          (2, 1): -bb, (2, 2): -4.0 * theta * bb,
          (2, 3): -3.0 * theta2 * bb, (3, 2): -2.0 * bb, (3, 3): -6.0 * theta * bb,
          (3, 4): -4.0 * theta2 * bb, (4, 3): -3.0 * bb, (4, 4): -8.0 * theta * bb}
    h = {(0,): 0.5 * theta2, (1,): theta * 1.0, (2,): 0.5 * 1.0}
    return M, L0, L1, h


def _dense(entries: dict, ndim: int, like: torch.Tensor) -> torch.Tensor:
    """the entries as a dense (5,) * ndim tensor; constants are built as
    ``like * 0 + c`` (the same bits) so that every entry carries a tangent
    of ``like``'s precision under forward mode."""
    zero = like * 0.0
    flat = [(entries[idx] if isinstance(entries[idx], torch.Tensor)
             else zero + entries[idx]) if idx in entries else zero
            for idx in np.ndindex(*(N_TERMS,) * ndim)]
    return torch.stack(flat).reshape((N_TERMS,) * ndim)


def _rhs(A, M_flat, L, H):
    outer = (A[:, :, None] * A[:, None, :]).flatten(1)
    return outer @ M_flat.T + torch.matmul(L, A[:, :, None])[..., 0] + H


def chain_prices(pars: torch.Tensor, p: Dict, vol_scaler: torch.Tensor,
                 year_steps: int) -> torch.Tensor:
    """(T, K) prices of the padded panel at PARAMS5 ``pars``: the ODE state A
    advances slice by slice, max(ceil(year_steps dtau), 16) RK4 steps each,
    a lane frozen at (cap, 0) once |Re A| or |Im A| passes the cap or is NaN."""
    sigma0, theta, kappa1, beta, volvol = common.scalars(pars)
    kappa2 = kappa1 / theta
    dtype, device = pars.dtype, pars.device
    cdtype = common.complex_of(dtype)
    phi = common.phi_grid(vol_scaler, dtype, device)
    M, L0, L1, h = (_dense(e, nd, theta) for e, nd in
                    zip(_terms(theta, kappa1, kappa2, beta, volvol), (3, 2, 2, 1)))
    M_flat = M.reshape(N_TERMS, N_TERMS * N_TERMS).to(cdtype)
    L = torch.complex(L0[None] + phi.real[:, None, None] * L1[None],
                      phi.imag[:, None, None] * L1[None])
    H = h.to(cdtype)[None, :] * (phi * (phi + 1.0) - torch.zeros_like(phi) * 2.0)[:, None]
    frozen = torch.complex(theta * 0.0 + FREEZE_CAP, theta * 0.0)
    A = torch.zeros((phi.shape[0], N_TERMS), dtype=cdtype, device=device)
    dead = torch.zeros(A.shape, dtype=torch.bool, device=device)
    y = sigma0 - theta
    y2 = y * y
    ys = torch.cat([y * 0.0 + 1.0, y, y2, y2 * y, y2 * y2])
    ttm0 = 0.0
    prices = []
    for i, ttm in enumerate(p["ttms_host"]):
        nb_steps = max(int(np.ceil(year_steps * float(ttm - ttm0))), 16)
        dt = float(ttm - ttm0) / nb_steps
        for _ in range(nb_steps):
            k1 = _rhs(A, M_flat, L, H)
            k2 = _rhs(A + k1 * (0.5 * dt), M_flat, L, H)
            k3 = _rhs(A + k2 * (0.5 * dt), M_flat, L, H)
            k4 = _rhs(A + k3 * dt, M_flat, L, H)
            A1 = A + (k1 + k2 * 2.0 + k3 * 2.0 + k4) * (dt / 6.0)
            dead = dead | ~(torch.abs(A1.real) < FREEZE_CAP) | ~(torch.abs(A1.imag) < FREEZE_CAP)
            A = torch.where(dead, frozen, A1)
        log_mgf = torch.complex(A.real @ ys, A.imag @ ys)
        prices.append(common.vanilla_prices(log_mgf, phi, p["forwards"][i], p["strikes"][i],
                                            p["is_call"][i], p["discfactors"][i]))
        ttm0 = float(ttm)
    return torch.stack(prices, dim=0)


def vol_scaler_of(panels: Dict[str, np.ndarray]) -> float:
    """the transform grid's scaler: first ATM vol times sqrt(min(ttm0, two weeks))."""
    return float(panels["atm"][0] * np.sqrt(np.minimum(panels["ttms"][0], 0.5 / 12.0)))


def fit(quotes: Dict, params0: Dict[str, float], nb_iters: int, year_steps: int,
        dtype: torch.dtype = torch.float64, device="cuda") -> Tuple[np.ndarray, float]:
    """(PARAMS5 fit [sigma0, theta, kappa1, beta, volvol], cost) from ``params0``."""
    panels = common.chain_panels(quotes)
    p = common.panel_tensors(panels, dtype, device)
    p["ttms_host"] = tuple(float(t) for t in panels["ttms"])
    vs = torch.tensor(vol_scaler_of(panels), dtype=dtype, device=device)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

    def residuals(pars):
        prices = chain_prices(pars, p, vs, year_steps)
        vols = common.fast_ivols(prices, p["forwards"], p["strikes"], p["ttms"],
                                 p["discfactors"], p["is_call"])
        return common.vol_residuals(vols, p["market"], p["sqrtw"])

    p0 = t([params0["sigma0"], params0["theta"], params0["kappa1"], params0["beta"],
            params0["volvol"]])
    best, cost = common.levenberg_marquardt(residuals, p0, t(LOWER), t(UPPER), nb_iters)
    return best.double().cpu().numpy(), float(cost)


def mc_prices(quotes: Dict, params: Dict[str, float], nb_path: int, seed: int, year_steps: int,
              dtype: torch.dtype = torch.float32, payoff_dtype: torch.dtype = torch.float64,
              device="cuda"):
    """MC chain prices and standard errors: the log-sigma Euler step in
    ``dtype`` (float32 scalars rounded from float64) on the counter stream."""
    f32 = np.float32
    a = {k: float(f32(params[k])) for k in ("theta", "kappa1", "kappa2", "beta", "volvol")}
    eta2 = float(f32(1.0) * f32(1.0))
    half_vt2 = float(f32(0.5) * (f32(a["beta"]) * f32(a["beta"])
                                 + f32(a["volvol"]) * f32(a["volvol"])))
    alpha_half = float(f32(-1.0) * f32(0.5))
    k1theta = float(f32(a["kappa1"]) * f32(a["theta"]))

    def advance(seed_i, state, nb_steps, dt):
        x, sigma0, qvar = state
        dt32, sdt = float(f32(dt)), float(f32(np.sqrt(dt)))
        normals = mc.Normals(seed_i, x.shape[0], x.device)
        lns = torch.log(sigma0)
        sigma = torch.exp(lns)
        for step in range(nb_steps):
            z0, z1 = normals.step(step)
            w0, w1 = (z0 * sdt).to(dtype), (z1 * sdt).to(dtype)
            sig2dt = ((eta2 * sigma) * sigma) * dt32
            x = (x + alpha_half * sig2dt) + (1.0 * sigma) * w0
            drift = (((k1theta * torch.reciprocal(sigma) - a["kappa1"])
                      + a["kappa2"] * (a["theta"] - sigma)) + 0.0 * sigma) - half_vt2
            lns = ((lns + drift * dt32) + a["beta"] * w0) + a["volvol"] * w1
            sigma_new = torch.exp(lns)
            qvar = qvar + 0.5 * (sig2dt + ((eta2 * sigma_new) * sigma_new) * dt32)
            sigma = sigma_new
        return x, sigma, qvar

    def state0(n):
        return (torch.zeros(n, dtype=dtype, device=device),
                torch.full((n,), float(f32(params["sigma0"])), dtype=dtype, device=device),
                torch.zeros(n, dtype=dtype, device=device))

    return mc.mc_chain(advance, state0, quotes, nb_path, seed, year_steps, payoff_dtype)
