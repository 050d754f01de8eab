"""
Heston stochastic-volatility model: analytic Fourier pricing and Monte Carlo.

PyTorch counterpart of ``stochvolmodels_tpu/models/heston.py`` for the
serving path.  The closed-form log-MGF (Sepp 2007, formula 14) is elementwise
complex128 math over the whole transform grid, with the Riccati state (a, b)
chained across maturities.  Monte Carlo runs the full-truncation Euler
scheme, either eagerly in float64 (``engine='scan'``) or through the
hand-written CUDA kernel ``csrc/heston_mc.cu`` and its plain version
(``engine='cuda'``).  QMC, antithetic draws, greeks and calibration are not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from stochvolmodels_torch.config import VariableType
from stochvolmodels_torch.data.option_chain import ChainGrid, OptionChain
from stochvolmodels_torch.models.model_pricer import ModelParams, ModelPricer
from stochvolmodels_torch.ops import mgf
from stochvolmodels_torch.ops.cuda_mc import (VAR_FLOOR, engine_setup,
                                              simulate_heston_terminal_kernel)
from stochvolmodels_torch.ops.payoffs import compute_mc_vars_payoff
from stochvolmodels_torch.ops.random import generator_from_seed, step_normals
from stochvolmodels_torch.utils.funcs import set_time_grid, timer


@dataclass
class HestonParams(ModelParams):
    """Heston parameters: dv = kappa (theta - v) dt + volvol sqrt(v) dW,
    rho the return-variance correlation."""
    v0: float = 0.04
    theta: float = 0.04
    kappa: float = 4.0
    rho: float = -0.5
    volvol: float = 0.4

    def to_array(self) -> np.ndarray:
        return np.array([self.v0, self.theta, self.kappa, self.rho, self.volvol])


BTC_HESTON_PARAMS = HestonParams(v0=0.8, theta=1.0, kappa=2.0, rho=0.0, volvol=2.0)


def default_vol_scaler(v0: float, ttm0: float) -> float:
    """transform-grid scaler min(0.3, sqrt(v0 * first maturity))."""
    return float(np.minimum(0.3, np.sqrt(v0 * ttm0)))


def compute_heston_mgf_grid(v0: float,
                            theta: float,
                            kappa: float,
                            volvol: float,
                            rho: float,
                            ttm: float,
                            phi_grid: torch.Tensor,
                            psi_grid: torch.Tensor,
                            a_t0: Optional[torch.Tensor] = None,
                            b_t0: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """closed-form Heston log-MGF on the complex128 transform grid.

    (a_t0, b_t0) chain the Riccati solution across maturities; ``ttm`` is the
    increment from the previous slice.  Returns (log_mgf, a_t1, b_t1).
    ``torch.sqrt`` and ``torch.log`` take the principal branch, as the JAX
    package's polar-form ``csqrt`` and ``clog`` do.
    """
    volvol2 = volvol * volvol
    b1 = phi_grid * (rho * volvol) + kappa
    b0 = phi_grid * (phi_grid + 1.0) * 0.5 - psi_grid
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


def heston_chain_price_grid(grid: ChainGrid,
                            v0: float,
                            theta: float,
                            kappa: float,
                            volvol: float,
                            rho: float,
                            vol_scaler: Optional[float] = None,
                            variable_type: VariableType = VariableType.LOG_RETURN,
                            is_spot_measure: bool = True,
                            is_simpson: bool = True
                            ) -> torch.Tensor:
    """price the padded chain panel on the grid's device; returns (n_ttm,
    max_strikes) float64 prices.  Each slice advances the previous slice's
    Riccati state (a, b) by ``ttm_i - ttm_{i-1}``."""
    if variable_type != VariableType.LOG_RETURN:
        raise NotImplementedError(f"variable_type={variable_type}")
    ttms = [float(t) for t in grid.ttms.cpu().numpy()]
    if vol_scaler is None:
        vol_scaler = default_vol_scaler(v0, ttms[0])
    phi_grid, psi_grid, _ = mgf.get_transform_var_grid(
        variable_type=variable_type, is_spot_measure=is_spot_measure,
        vol_scaler=vol_scaler, device=grid.device)
    a_t, b_t = None, None
    ttm0 = 0.0
    prices = []
    for i, ttm in enumerate(ttms):
        log_mgf, a_t, b_t = compute_heston_mgf_grid(
            v0=v0, theta=theta, kappa=kappa, volvol=volvol, rho=rho, ttm=ttm - ttm0,
            phi_grid=phi_grid, psi_grid=psi_grid, a_t0=a_t, b_t0=b_t)
        prices.append(mgf.vanilla_prices_with_mgf_grid(
            log_mgf_grid=log_mgf, phi_grid=phi_grid, forwards=grid.forwards[i],
            strikes=grid.strikes[i], optiontypes=grid.optioncodes[i],
            discfactors=grid.discfactors[i], is_spot_measure=is_spot_measure,
            is_simpson=is_simpson))
        ttm0 = ttm
    return torch.stack(prices, dim=0)


# ----------------------------------------------------------------------------
# Monte Carlo
# ----------------------------------------------------------------------------

def simulate_heston_terminal(gen: torch.Generator,
                             x0: torch.Tensor,
                             var0: torch.Tensor,
                             qvar0: torch.Tensor,
                             ttm: float,
                             theta: float,
                             kappa: float,
                             rho: float,
                             volvol: float,
                             nb_steps_per_year: int = 360
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """full-truncation Euler to the horizon ``ttm``, one eager step at a time
    in the dtype of ``x0``, with normals drawn from ``gen``."""
    nb_steps, dt, _ = set_time_grid(ttm=ttm, nb_steps_per_year=nb_steps_per_year)
    sqrt_dt = float(np.sqrt(dt))
    rho_1 = float(np.sqrt(1.0 - rho * rho))
    nb_path = x0.shape[0]
    x, var, qvar = x0, var0, qvar0
    for _ in range(nb_steps):
        w = step_normals(gen, (2, nb_path), dtype=x0.dtype) * sqrt_dt
        w0, w1 = w[0], w[1]
        sigma = torch.sqrt(var)
        var_dt = var * dt
        x = x - 0.5 * var_dt + sigma * w0
        qvar = qvar + var_dt
        var = var + kappa * (theta - var) * dt + sigma * volvol * (rho * w0 + rho_1 * w1)
        var = torch.clamp(var, min=VAR_FLOOR)
    return x, var, qvar


def heston_mc_chain_pricer(ttms: np.ndarray,
                           forwards: np.ndarray,
                           discfactors: np.ndarray,
                           strikes_ttms,
                           optiontypes_ttms,
                           v0: float,
                           theta: float,
                           kappa: float,
                           rho: float,
                           volvol: float,
                           nb_path: int = 100000,
                           variable_type: VariableType = VariableType.LOG_RETURN,
                           seed: Optional[int] = None,
                           dtype: torch.dtype = torch.float64,
                           engine: str = "scan",
                           device="cuda"
                           ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """chain MC with the terminal state carried across maturities; returns
    ragged (prices, stderrs).

    ``engine='cuda'`` (alias ``'pallas'``) carries (x, var, qvar) in float32
    through the hand-written CUDA kernel on a CUDA ``device`` and through its
    plain version on the CPU; slice ``i`` takes the seed ``base + 7919*i``.
    ``engine='scan'`` (default) runs the eager Euler loop in ``dtype`` with
    normals from a generator seeded by ``seed``.
    """
    if engine == "pallas":
        engine = "cuda"
    if engine not in ("scan", "cuda"):
        raise NotImplementedError(f"engine={engine}")
    device = torch.device(device)
    if engine == "cuda":
        nb_pad, base_seed = engine_setup(seed, nb_path)
        dtype = torch.float32
    else:
        nb_pad, gen = nb_path, generator_from_seed(seed, device=device)
    x = torch.zeros(nb_pad, dtype=dtype, device=device)
    var = torch.full((nb_pad,), v0, dtype=dtype, device=device)
    qvar = torch.zeros(nb_pad, dtype=dtype, device=device)
    ttm0 = 0.0
    option_prices_ttm, option_std_ttm = [], []
    for i, ttm in enumerate(ttms):
        kw = dict(ttm=float(ttm - ttm0), theta=theta, kappa=kappa, rho=rho, volvol=volvol)
        if engine == "cuda":
            x, var, qvar = simulate_heston_terminal_kernel(
                seed=base_seed + 7919 * i, x0=x, var0=var, qvar0=qvar, **kw)
        else:
            x, var, qvar = simulate_heston_terminal(gen=gen, x0=x, var0=var, qvar0=qvar, **kw)
        ttm0 = float(ttm)
        prices, stds = compute_mc_vars_payoff(
            x0=x[:nb_path], sigma0=torch.sqrt(var[:nb_path]), qvar0=qvar[:nb_path], ttm=ttm,
            forward=forwards[i], strikes_ttm=strikes_ttms[i],
            optiontypes_ttm=optiontypes_ttms[i], discfactor=discfactors[i],
            variable_type=variable_type)
        option_prices_ttm.append(prices)
        option_std_ttm.append(stds)
    return option_prices_ttm, option_std_ttm


# ----------------------------------------------------------------------------
# pricer class
# ----------------------------------------------------------------------------

class HestonPricer(ModelPricer):
    """ModelPricer for Heston, valued by Fourier inversion of the analytic
    MGF; tensors live on ``device``."""

    def price_chain(self, option_chain: OptionChain, params: HestonParams,
                    variable_type: VariableType = VariableType.LOG_RETURN,
                    vol_scaler: Optional[float] = None,
                    precision: str = "exact",
                    **kwargs) -> List[np.ndarray]:
        """analytic chain prices in float64.  ``precision='fast'`` (mixed
        precision in the JAX package) runs the same float64 path: the card
        has native complex128."""
        if precision not in ("exact", "fast"):
            raise NotImplementedError(f"precision={precision}")
        if vol_scaler is None:
            vol_scaler = default_vol_scaler(params.v0, float(option_chain.ttms[0]))
        prices = heston_chain_price_grid(
            option_chain.to_grid(device=self.device), v0=float(params.v0),
            theta=float(params.theta), kappa=float(params.kappa),
            volvol=float(params.volvol), rho=float(params.rho),
            vol_scaler=float(vol_scaler), variable_type=variable_type)
        return option_chain.unpad_panel(prices)

    def model_mc_price_chain(self, option_chain: OptionChain, params: HestonParams,
                             nb_path: int = 100000,
                             variable_type: VariableType = VariableType.LOG_RETURN,
                             seed: Optional[int] = None,
                             **kwargs) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """MC chain prices and standard errors on the pricer's device
        (``engine='scan'`` or ``'cuda'``/``'pallas'``); antithetic draws are
        not ported and raise."""
        if kwargs.get("antithetic"):
            raise NotImplementedError("antithetic Heston MC is not ported")
        return heston_mc_chain_pricer(
            ttms=option_chain.ttms, forwards=option_chain.forwards,
            discfactors=option_chain.discfactors, strikes_ttms=option_chain.strikes_ttms,
            optiontypes_ttms=option_chain.optiontypes_ttms, v0=params.v0,
            theta=params.theta, kappa=params.kappa, rho=params.rho, volvol=params.volvol,
            nb_path=nb_path, variable_type=variable_type, seed=seed,
            engine=kwargs.get("engine", "scan"), device=self.device)

    @timer
    def simulate_terminal_values(self, params: HestonParams, ttm: float = 1.0,
                                 nb_path: int = 100000, seed: Optional[int] = None, **kwargs
                                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """terminal (x, var, qvar) of the float64 eager engine, as numpy."""
        f64 = dict(dtype=torch.float64, device=self.device)
        x, var, qvar = simulate_heston_terminal(
            gen=generator_from_seed(seed, device=self.device), x0=torch.zeros(nb_path, **f64),
            var0=torch.full((nb_path,), float(params.v0), **f64),
            qvar0=torch.zeros(nb_path, **f64), ttm=ttm, theta=params.theta,
            kappa=params.kappa, rho=params.rho, volvol=params.volvol)
        return x.cpu().numpy(), var.cpu().numpy(), qvar.cpu().numpy()
