"""
Strang-splitting simulation of the rough LogSV model via its Markovian lift.

PyTorch counterpart of ``stochvolmodels_tpu/models/rough/simulation.py``.
The lifted volatility is sigma = sum_i w_i v_i over N
factors; each time step composes a half-step RK4 drift solve, an exact
log-normal diffusion step on the weighted sum and another half drift step,
followed by the log-spot reconstruction.  Factor panels are (n, nb_path)
tensors.  The ``'scan'`` engine runs the steps eagerly in float64 with
normals from a ``torch.Generator``; the ``'cuda'`` engine runs them in the
hand-written CUDA kernel ``csrc/rough_mc.cu`` (its plain version on the
CPU).  The fixed-randoms variant runs the same float64 steps over
pre-drawn normal blocks; its parameters may be 0-dim float64 tensors, so the
rough MC calibration differentiates through it.  The float64 engines take
either drift scheme: the RK4 half-step (``drift_scheme='rk4'``, the
default) or the exact-linear step (``'expm'``, :func:`drift_ode_expm`); the
CUDA kernel keeps the RK4 drift, as the TPU kernel does.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from stochvolmodels_torch.config import VariableType
from stochvolmodels_torch.ops.cuda_mc import ROUGH_VOL_FLOOR as VOL_FLOOR
from stochvolmodels_torch.ops.cuda_mc import engine_setup, simulate_rough_terminal_kernel
from stochvolmodels_torch.ops.payoffs import compute_mc_vars_payoff
from stochvolmodels_torch.ops.random import generator_from_seed, step_normals
from stochvolmodels_torch.utils.funcs import set_time_grid


def drift_ode_rk4(nodes: torch.Tensor, v0: torch.Tensor, theta, kappa1, kappa2,
                  z0: torch.Tensor, weights: torch.Tensor, h) -> torch.Tensor:
    """RK4 on the lifted drift ODE dz_i = -x_i (z_i - v0_i) + g(w.z) with
    g(s) = (kappa1 + kappa2 s)(theta - s); panels are (n, nb_path) or
    broadcast to it."""
    def rhs(z):
        zw = torch.sum(weights * z, dim=0)
        g = (kappa1 + kappa2 * zw) * (theta - zw)
        return -nodes * (z - v0) + g

    s1 = rhs(z0)
    s2 = rhs(z0 + 0.5 * h * s1)
    s3 = rhs(z0 + 0.5 * h * s2)
    s4 = rhs(z0 + h * s3)
    return z0 + (h / 6.0) * (s1 + 2.0 * s2 + 2.0 * s3 + s4)


def drift_ode_expm(nodes: torch.Tensor, v0: torch.Tensor, theta, kappa1, kappa2,
                   z0: torch.Tensor, weights: torch.Tensor, h,
                   n_squarings: int = 6, taylor_terms: int = 8) -> torch.Tensor:
    """exact-linear drift step: the mean-reversion speed lambda = kappa1 +
    kappa2 (w.z0) is frozen at the step start, so the drift ODE is linear,

        dz = A z + b,   A = -(lambda w^T + diag(x)),   b = lambda theta + x v0,

    and advances exactly by z_h = e^{Ah} z0 + h phi1(Ah) b.  e^{Ah} and
    phi1(Ah) come from one batched scaling-and-squaring Taylor over per-path
    (P, n, n) real panels (``taylor_terms`` terms at h / 2^``n_squarings``,
    then phi1(2A) = (e^A + I)/2 phi1(A) at each squaring), so no per-path
    inverse.  Panels are (n, nb_path) or broadcast to it, as in
    :func:`drift_ode_rk4`."""
    n, nb_path = z0.shape
    zw = torch.sum(weights * z0, dim=0)                          # (P,)
    lam = kappa1 + kappa2 * zw                                   # (P,)
    x_p = nodes.T.expand(nb_path, n)
    w_p = weights.T.expand(nb_path, n)
    v0_p, z0_p = v0.T.expand(nb_path, n), z0.T                   # (P, n)
    eye = torch.eye(n, dtype=z0.dtype, device=z0.device)
    A = -(lam[:, None, None] * w_p[:, None, :]) - eye * x_p[:, None, :]
    Ah = A * (h / (2.0 ** n_squarings))
    T = E = P1 = eye.expand(A.shape)
    for k in range(1, taylor_terms + 1):
        T = torch.matmul(T, Ah / k)
        E = E + T
        P1 = P1 + T / (k + 1.0)
    for _ in range(n_squarings):
        P1 = torch.matmul(0.5 * (E + eye), P1)
        E = torch.matmul(E, E)
    b_p = lam[:, None] * theta + x_p * v0_p                      # (P, n)
    z_h = (torch.matmul(E, z0_p[:, :, None])[..., 0]
           + h * torch.matmul(P1, b_p[:, :, None])[..., 0])
    return z_h.T


def _drift(drift_scheme: str):
    """the drift half-step of ``drift_scheme``: 'rk4' or 'expm'."""
    if drift_scheme not in ("rk4", "expm"):
        raise NotImplementedError(f"drift_scheme={drift_scheme}")
    return drift_ode_expm if drift_scheme == "expm" else drift_ode_rk4


def diffus_sde_exact(y0: torch.Tensor, weights: torch.Tensor, volvol, h,
                     z_rand: torch.Tensor) -> torch.Tensor:
    """exact log-normal diffusion step on the weighted sum, with the increment
    distributed equally across factors."""
    weight_sum = torch.sum(weights, dim=0)
    volvol_ = volvol * weight_sum
    yw = torch.sum(weights * y0, dim=0)
    dw = z_rand * float(np.sqrt(h))
    y_h = yw * torch.exp(-0.5 * volvol_ * volvol_ * h + volvol_ * dw)
    q = (y_h - yw) / weight_sum
    return y0 + q[None, :]


def strang_step(nodes: torch.Tensor, weights: torch.Tensor, v0: torch.Tensor,
                theta, kappa1, kappa2, rho, volvol,
                log_s: torch.Tensor, v: torch.Tensor, y: torch.Tensor, h,
                z0: torch.Tensor, z1: torch.Tensor, drift_scheme: str = "rk4"
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """one full step D(h/2) o S(h) o D(h/2) and the log-spot reconstruction;
    returns (vol_h, y_h, log_spot_h).  ``drift_scheme``: 'rk4' (the
    production half-step) or 'expm' (:func:`drift_ode_expm`)."""
    drift = _drift(drift_scheme)
    d_inn = drift(nodes, v0, theta, kappa1, kappa2, v, weights, 0.5 * h)
    s_inn = diffus_sde_exact(d_inn, weights, volvol, h, z0)
    vol_h = drift(nodes, v0, theta, kappa1, kappa2, s_inn, weights, 0.5 * h)

    w_vol_h = torch.sum(weights * vol_h, dim=0)
    bad = torch.isnan(w_vol_h) | (w_vol_h <= 0.0)
    vol_h = torch.where(bad[None, :], VOL_FLOOR, vol_h)

    wlam = weights * nodes
    vw = torch.sum(weights * v, dim=0)
    volw_h = torch.sum(weights * vol_h, dim=0)
    w_inv = 1.0 / torch.sum(weights, dim=0)

    c1 = c2 = 0.5
    rho_comp = (torch.sqrt(1.0 - rho * rho) if isinstance(rho, torch.Tensor)
                else float(np.sqrt(1.0 - rho * rho)))
    sq_vw = torch.square(vw)
    sq_vhw = torch.square(volw_h)
    w_lam_vol = torch.sum(wlam * v, dim=0)
    w_lam_vol_h = torch.sum(wlam * vol_h, dim=0)
    w_lam_v0 = torch.sum(wlam * v0, dim=0)

    term1 = (1.0 / volvol) * (
        ((volw_h - vw) / h + c1 * w_lam_vol + c2 * w_lam_vol_h - w_lam_v0) * w_inv
        - kappa1 * theta + (kappa1 - kappa2 * theta) * (c1 * vw + c2 * volw_h)
        + kappa2 * (c1 * sq_vw + c2 * sq_vhw)) * h
    term2 = c1 * h * sq_vw + c2 * h * sq_vhw
    log_spot_h = log_s - 0.5 * term2 + rho * term1 + rho_comp * torch.sqrt(term2) * z1
    y_h = y + 0.5 * h * (vw * vw + volw_h * volw_h)
    return vol_h, y_h, log_spot_h


def _lifted_panels(nodes, weights, sigma0, nb_path: int, dtype, device):
    """(nodes (n, 1), weights (n, 1), v0 (n, nb_path)) of the lift, v0 the
    factor start sigma0 / sum(weights) (``sigma0`` a float or a 0-dim tensor)."""
    nodes_t = torch.as_tensor(np.asarray(nodes, dtype=np.float64), dtype=dtype,
                              device=device)[:, None]
    weights_t = torch.as_tensor(np.asarray(weights, dtype=np.float64), dtype=dtype,
                                device=device)[:, None]
    start = (sigma0 if isinstance(sigma0, torch.Tensor) else float(sigma0)) / torch.sum(weights_t)
    v0 = torch.full((len(nodes), nb_path), 1.0, dtype=dtype, device=device) * start
    return nodes_t, weights_t, v0


def _strang_steps(nodes_t, weights_t, v0, theta, kappa1, kappa2, rho, volvol, h, normals,
                  drift_scheme: str = "rk4"):
    """Strang steps from (v0, 0, 0) over ``normals``, an iterable of the
    steps' (z0, z1) panels; returns (log-spot, factor vols, integrated
    variance)."""
    v = v0
    y = torch.zeros(v0.shape[1], dtype=v0.dtype, device=v0.device)
    log_s = torch.zeros_like(y)
    for z0, z1 in normals:
        v, y, log_s = strang_step(nodes_t, weights_t, v0, theta, kappa1, kappa2, rho, volvol,
                                  log_s, v, y, h, z0, z1, drift_scheme=drift_scheme)
    return log_s, v, y


def log_spot_full_combined(nodes: np.ndarray,
                           weights: np.ndarray,
                           sigma0: float,
                           theta: float,
                           kappa1: float,
                           kappa2: float,
                           rho: float,
                           volvol: float,
                           ttm: float,
                           nb_path: int,
                           gen: torch.Generator,
                           nb_steps_per_year: int = 360,
                           dtype: torch.dtype = torch.float64,
                           drift_scheme: str = "rk4"
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """simulate (log-spot, factor vols, integrated variance) to the horizon,
    one eager Strang step at a time on the generator's device, with each
    step's two normal panels drawn from ``gen``."""
    nb_steps, dt, _ = set_time_grid(ttm=ttm, nb_steps_per_year=nb_steps_per_year)
    nodes_t, weights_t, v0 = _lifted_panels(nodes, weights, sigma0, nb_path, dtype, gen.device)
    normals = (tuple(step_normals(gen, (2, nb_path), dtype=dtype)) for _ in range(nb_steps))
    return _strang_steps(nodes_t, weights_t, v0, theta, kappa1, kappa2, rho, volvol, dt, normals,
                         drift_scheme=drift_scheme)


def log_spot_full_combined_fixed(nodes: np.ndarray,
                                 weights: np.ndarray,
                                 sigma0,
                                 theta,
                                 kappa1,
                                 kappa2,
                                 rho,
                                 volvol,
                                 timegrid: np.ndarray,
                                 Z0,
                                 Z1,
                                 dtype: torch.dtype = torch.float64,
                                 device="cuda",
                                 drift_scheme: str = "rk4"
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Strang steps over pre-drawn (steps, paths) normal blocks ``Z0``,
    ``Z1`` (numpy arrays or tensors, moved to ``device``) at the step of
    ``timegrid``.  Parameters are floats or 0-dim float64 tensors."""
    z0 = torch.as_tensor(Z0, dtype=dtype, device=device)
    z1 = torch.as_tensor(Z1, dtype=dtype, device=device)
    h = float(timegrid[1] - timegrid[0])
    nodes_t, weights_t, v0 = _lifted_panels(nodes, weights, sigma0, z0.shape[1], dtype, device)
    return _strang_steps(nodes_t, weights_t, v0, theta, kappa1, kappa2, rho, volvol, h,
                         zip(z0, z1), drift_scheme=drift_scheme)


def rough_logsv_mc_chain_pricer(ttms: np.ndarray,
                                forwards: np.ndarray,
                                discfactors: np.ndarray,
                                strikes_ttms,
                                optiontypes_ttms,
                                sigma0: float,
                                theta: float,
                                kappa1: float,
                                kappa2: float,
                                beta: float,
                                volvol: float,
                                weights: np.ndarray,
                                nodes: np.ndarray,
                                nb_path: int = 100000,
                                nb_steps_per_year: int = 360,
                                variable_type: VariableType = VariableType.LOG_RETURN,
                                seed: Optional[int] = None,
                                dtype: torch.dtype = torch.float64,
                                engine: str = "scan",
                                device="cuda",
                                drift_scheme: str = "rk4"
                                ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """rough chain MC: (beta, volvol) is reparametrized to (vartheta,
    rho = beta / vartheta), and every slice restarts from t = 0 on the same
    random stream, so a short slice sees a prefix of a long slice's
    increments.

    ``engine='cuda'`` (alias ``'pallas'``) runs each slice in float32 through
    the hand-written CUDA kernel on a CUDA ``device`` (its plain version on
    the CPU), every slice with the same base seed: one launch per maturity,
    simulating the sum of the slice horizons.  ``engine='scan'`` (default)
    runs the float64 eager engine with a generator reseeded by ``seed`` for
    each slice, with the drift half-step of ``drift_scheme`` ('rk4' or
    'expm'); the kernel's drift is RK4 only.
    """
    if engine == "pallas":
        engine = "cuda"
    if engine not in ("scan", "cuda"):
        raise NotImplementedError(f"engine={engine}")
    if engine == "cuda" and drift_scheme != "rk4":
        raise NotImplementedError("drift_scheme='expm' runs on engine='scan' only: the kernel's "
                                  "drift is the RK4 half-step")
    device = torch.device(device)
    vartheta = float(np.sqrt(beta ** 2 + volvol ** 2))
    rho = float(beta / vartheta)
    if engine == "cuda":
        nb_pad, base_seed = engine_setup(seed, nb_path)
    weights_t = torch.as_tensor(np.asarray(weights, dtype=np.float64), dtype=dtype,
                                device=device)[:, None]
    option_prices_ttm, option_std_ttm = [], []
    for ttm, forward, discfactor, strikes, types in zip(ttms, forwards, discfactors,
                                                        strikes_ttms, optiontypes_ttms):
        kw = dict(sigma0=sigma0, theta=theta, kappa1=kappa1, kappa2=kappa2, rho=rho,
                  volvol=vartheta, nodes=nodes, weights=weights, ttm=float(ttm),
                  nb_steps_per_year=nb_steps_per_year)
        if engine == "cuda":
            log_s, sigma_terminal, y = simulate_rough_terminal_kernel(
                seed=base_seed, nb_path=nb_pad, device=device, **kw)
            log_s, sigma_terminal, y = log_s[:nb_path], sigma_terminal[:nb_path], y[:nb_path]
        else:
            log_s, v, y = log_spot_full_combined(
                nb_path=nb_path, gen=generator_from_seed(seed, device=device), dtype=dtype,
                drift_scheme=drift_scheme, **kw)
            sigma_terminal = torch.sum(weights_t * v, dim=0)
        prices, stds = compute_mc_vars_payoff(
            x0=log_s, sigma0=sigma_terminal, qvar0=y, ttm=ttm, forward=forward,
            strikes_ttm=strikes, optiontypes_ttm=types, discfactor=discfactor,
            variable_type=variable_type)
        option_prices_ttm.append(prices)
        option_std_ttm.append(stds)
    return option_prices_ttm, option_std_ttm
