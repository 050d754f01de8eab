"""
Futures convexity adjustment for the factor-HJM LogSV model (Theorems 3.3 and
3.5 of Sepp & Rakhmonov 2025).

PyTorch counterpart of ``stochvolmodels_tpu/models/factor_hjm/conv_adj.py``.
The bond-coefficient blocks (B1, B2) of the Theorem-3.3 ODE evolve linearly
with the basis generating matrices and have closed forms through the
bond-coefficient identity ``d/dtau B_P(tau) = B_P(tau) @ D + B(0)``::

    EURODOLLAR:  B1(tau) = B_PX(tau + Delta) - B_PX(tau)
    SOFR:        B1(tau) = B_PX(tau) - B_PX(max(tau - Delta, 0))

(and the same for B2 with the auxiliary coefficients).  Only the 2- or
3-dimensional h-system remains an ODE; its inputs reduce to four scalar time
series — s_MB = B1'M B1, s_CB = B1'C beta, s_OM = B2'Omega and vartheta^2 —
evaluated exactly on the RK4 half-step grid as panels, and the integration
is a fixed-step RK4 loop on the device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from stochvolmodels_torch.models.logsv.affine import ExpansionOrder
from stochvolmodels_torch.ops.bsm import _f64


def ns_bond_coeffs(mrv, tau, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Nelson-Siegel integrated bases (B_PX (..., 3), B_PY (..., 8)),
    vectorized over ``tau`` (the tensor twin of ``NelsonSiegel.bond_coeffs``);
    a numpy ``tau`` goes to ``device``."""
    tau = _f64(tau, device)
    mrv2, mrv3 = mrv * mrv, mrv * mrv * mrv
    mt = mrv * tau
    mt2 = mt * mt
    e = torch.exp(-mt)
    e2 = torch.exp(-2.0 * mt)
    B_PX = torch.stack([tau, (1.0 - e) / mrv, (1.0 - e * (1.0 + mt)) / mrv2], dim=-1)
    B_PY = torch.stack([tau, 0.5 * tau * tau,
                        (1.0 - e) / mrv, (1.0 - e * (1.0 + mt)) / mrv2,
                        (1.0 - e * (1.0 + mt + 0.5 * mt2)) / mrv3,
                        0.5 * (1.0 - e2) / mrv,
                        0.25 * (1.0 - e2 * (1.0 + 2.0 * mt)) / mrv2,
                        0.125 * (1.0 - e2 * (1.0 + 2.0 * mt + 2.0 * mt2)) / mrv3], dim=-1)
    return B_PX, B_PY


def conv_adj_linear_block(mrv: float, tau, Delta: float, is_sofr: bool,
                          device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """closed-form (B1(tau), B2(tau)) of the Theorem-3.3 linear block (see
    the module docstring), vectorized over ``tau``."""
    tau = _f64(tau, device)
    if is_sofr:
        hi, lo = tau, torch.clamp(tau - Delta, min=0.0)
    else:
        hi, lo = tau + Delta, tau
    bx_hi, by_hi = ns_bond_coeffs(mrv, hi)
    bx_lo, by_lo = ns_bond_coeffs(mrv, lo)
    return bx_hi - bx_lo, by_hi - by_lo


def conv_adj_scalar_panels(params, t_start: float, Delta: float, is_sofr: bool,
                           taus: np.ndarray, device="cuda"
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(s_MB, s_CB, s_OM, vartheta2) panels at integration times ``taus``.

    Piecewise-constant model coefficients are looked up at calendar time
    t = t_start - tau; the linear block is closed form, so the panels are
    exact at every stage time.
    """
    taus = np.asarray(taus, dtype=float)
    ts = np.asarray(params.ts, dtype=float)
    t_cal = t_start - taus
    idx = np.clip(np.searchsorted(ts[1:], t_cal, side="left"), 0, ts.size - 2)
    on = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)
    beta_t = on(params.beta.xs[idx])        # (K, d)
    volvol_t = on(params.volvol.xs[idx])    # (K,)
    M_t = on(params.M[idx])                 # (K, d, d)
    C_t = on(params.C[idx])                 # (K, d, d)
    Omega_t = on(params.Omega[idx])         # (K, m)
    B1, B2 = conv_adj_linear_block(params.basis.meanrev, on(taus), Delta, is_sofr)
    s_MB = torch.einsum('kd,kde,ke->k', B1, M_t, B1)
    s_CB = torch.einsum('kd,kde,ke->k', B1, C_t, beta_t)
    s_OM = torch.einsum('km,km->k', B2, Omega_t)
    vartheta2 = torch.einsum('kd,kd->k', beta_t, beta_t) + volvol_t ** 2
    return s_MB, s_CB, s_OM, vartheta2


def _h_rhs(h: torch.Tensor, c: torch.Tensor, q, kappa0, kappa1, kappa2, order_first: bool
           ) -> torch.Tensor:
    """time derivative of h = (h1, h2, h0); c = (s_MB, s_CB, s_OM, vt2)."""
    h1, h2, h0 = h[0], h[1], h[2]
    drive = 0.5 * c[0] + c[2]   # 0.5 B1'M B1 + B2'Omega
    g = c[1]                    # B1'C beta
    v2 = c[3]
    if order_first:
        dh1 = (2.0 * q * drive - kappa1 * h1 + 2.0 * kappa0 * h2
               + v2 * q * (h1 * h1 + 2.0 * h2 + 2.0 * q * h1 * h2)
               + 2.0 * q * g * (h1 + q * h2))
        dh2 = (drive - kappa2 * h1 - 2.0 * kappa1 * h2
               + v2 * (0.5 * h1 * h1 + h2 + 4.0 * q * h1 * h2
                       + 2.0 * q * q * h2 * h2)
               + g * (h1 + 4.0 * q * h2))
        dh0 = (q * q * drive + kappa0 * h1
               + v2 * q * q * (0.5 * h1 * h1 + h2) + q * q * g * h1)
    else:
        core = drive + g * h1 + 0.5 * v2 * h1 * h1
        dh1 = 2.0 * q * core - kappa1 * h1
        dh2 = torch.zeros_like(h2)
        dh0 = q * q * core + kappa0 * h1
    return torch.stack([dh1, dh2, dh0])


def _solve_h_scan(panels_half: torch.Tensor, q, kappa0, kappa1, kappa2, dt,
                  order_first: bool) -> torch.Tensor:
    """RK4 on the h-system with exact stage coefficients.

    ``panels_half``: (4, 2S+1) scalar panels on the half-step grid
    tau_k = k * dt/2.  Returns the trajectory (S+1, 3) including tau=0.
    """
    n_half = panels_half.shape[1]
    nb_steps = (n_half - 1) // 2
    c0 = panels_half[:, 0:2 * nb_steps:2].T       # (S, 4) at tau_k
    ch = panels_half[:, 1:2 * nb_steps + 1:2].T   # (S, 4) at tau_k + dt/2
    c1 = panels_half[:, 2:2 * nb_steps + 2:2].T   # (S, 4) at tau_k + dt
    h = panels_half.new_zeros(3)
    traj = [h]
    for a, b, c in zip(c0, ch, c1):
        k1 = _h_rhs(h, a, q, kappa0, kappa1, kappa2, order_first)
        k2 = _h_rhs(h + 0.5 * dt * k1, b, q, kappa0, kappa1, kappa2, order_first)
        k3 = _h_rhs(h + 0.5 * dt * k2, b, q, kappa0, kappa1, kappa2, order_first)
        k4 = _h_rhs(h + dt * k3, c, q, kappa0, kappa1, kappa2, order_first)
        h = h + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        traj.append(h)
    return torch.stack(traj)


def solve_conv_adj(params, t_start: float, Delta: float, tau_end: float,
                   settlement_is_sofr: bool,
                   expansion_order: ExpansionOrder,
                   steps_per_year: int = 1000,
                   device="cuda") -> Tuple[np.ndarray, torch.Tensor]:
    """integrate the h-system over tau in [0, tau_end] on ``device``.

    Returns (tau grid (S+1,), h trajectory (S+1, 3) = (h1, h2, h0)).
    The effective mean-reversion constants follow Theorem 3.3:
    kappa0 = kappa1 (theta - q) + kappa2 q (theta - q),
    kappa1_eff = kappa1 - kappa2 theta + 2 kappa2 q, kappa2_eff = kappa2.
    """
    q = params.theta if params.q is None else params.q
    kappa0 = params.kappa1 * (params.theta - q) + params.kappa2 * q * (params.theta - q)
    kappa1_eff = params.kappa1 - params.kappa2 * params.theta + 2.0 * params.kappa2 * q
    kappa2_eff = params.kappa2
    nb_steps = max(int(np.ceil(steps_per_year * float(tau_end))), 8)
    dt = float(tau_end) / nb_steps
    taus_half = 0.5 * dt * np.arange(2 * nb_steps + 1)
    panels = torch.stack(conv_adj_scalar_panels(
        params, t_start=t_start, Delta=Delta, is_sofr=settlement_is_sofr,
        taus=taus_half, device=device))                       # (4, 2S+1)
    order_first = expansion_order == ExpansionOrder.FIRST
    traj = _solve_h_scan(panels, q, kappa0, kappa1_eff, kappa2_eff, dt, order_first)
    return dt * np.arange(nb_steps + 1), traj
