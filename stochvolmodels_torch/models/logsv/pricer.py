"""
Pricer for the log-normal beta SV model with quadratic drift — the flagship
model (Sepp & Rakhmonov, IJTAF 2024).

PyTorch counterpart of ``stochvolmodels_tpu/models/logsv/pricer.py`` for the
serving path.  Vanillas are valued by Fourier inversion of the affine
expansion (a float64 RK4 over the whole transform grid, with the ODE state
chained across maturities); Monte Carlo runs the Eq. (3.59) Euler scheme,
either eagerly in float64 (``engine='scan'``) or through the hand-written
CUDA kernel and its plain version (``engine='cuda'``); the rough lift
(``use_rough_mc=True``) runs through ``models/rough/simulation.py``.
Calibration is not ported yet.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from stochvolmodels_torch.config import VariableType
from stochvolmodels_torch.data.option_chain import ChainGrid, OptionChain
from stochvolmodels_torch.models.logsv import affine as afe
from stochvolmodels_torch.models.logsv.affine import ExpansionOrder
from stochvolmodels_torch.models.logsv.params import LogSvParams
from stochvolmodels_torch.models.model_pricer import ModelPricer
from stochvolmodels_torch.models.rough.simulation import rough_logsv_mc_chain_pricer
from stochvolmodels_torch.ops import mgf
from stochvolmodels_torch.ops.cuda_mc import engine_setup, simulate_logsv_terminal_kernel
from stochvolmodels_torch.ops.payoffs import compute_mc_vars_payoff
from stochvolmodels_torch.ops.random import generator_from_seed, step_normals
from stochvolmodels_torch.utils.funcs import set_time_grid, timer

LOGSV_BTC_PARAMS = LogSvParams(sigma0=0.8376, theta=1.0413, kappa1=3.1844,
                               kappa2=3.058, beta=0.1514, volvol=1.8458)

# steps per year of the RK4 A(tau) solve for each precision
_YEAR_STEPS = {"exact": 240, "fast": 360}


def set_vol_scaler(sigma0: float, ttm: float) -> float:
    """transform-grid scaler; lower bound two weeks."""
    return sigma0 * np.sqrt(np.minimum(np.min(ttm), 0.5 / 12.0))


# ----------------------------------------------------------------------------
# analytic chain pricing over the padded grid
# ----------------------------------------------------------------------------

def logsv_chain_price_grid(grid: ChainGrid,
                           sigma0: float,
                           theta: float,
                           kappa1: float,
                           kappa2: float,
                           beta: float,
                           volvol: float,
                           vol_backbone_etas: Optional[np.ndarray] = None,
                           vol_scaler: Optional[float] = None,
                           ttms_static: Optional[Tuple[float, ...]] = None,
                           variable_type: VariableType = VariableType.LOG_RETURN,
                           expansion_order: ExpansionOrder = ExpansionOrder.SECOND,
                           is_spot_measure: bool = True,
                           is_simpson: bool = True,
                           year_steps: int = 720
                           ) -> torch.Tensor:
    """price the padded chain panel on the grid's device; returns (n_ttm,
    max_strikes) float64 prices.

    The ODE state A is chained across maturities: each slice advances the
    previous slice's A by ``ttm_i - ttm_{i-1}``.
    """
    if variable_type != VariableType.LOG_RETURN:
        raise NotImplementedError(f"variable_type={variable_type}")
    if ttms_static is None:
        ttms_static = tuple(float(t) for t in grid.ttms.cpu().numpy())
    if vol_backbone_etas is None:
        vol_backbone_etas = np.ones(len(ttms_static))
    phi_grid, psi_grid, theta_grid = mgf.get_transform_var_grid(
        variable_type=variable_type, is_spot_measure=is_spot_measure,
        vol_scaler=vol_scaler if vol_scaler is not None else 0.28, device=grid.device)

    n_terms = afe.get_expansion_n(expansion_order)
    a_t = afe.get_init_conditions_a(phi_grid=phi_grid, psi_grid=psi_grid,
                                    theta_grid=theta_grid, n_terms=n_terms,
                                    variable_type=variable_type)
    y = sigma0 - theta
    y2 = y * y
    ys = [1.0, y, y2] if expansion_order == ExpansionOrder.FIRST else [1.0, y, y2, y2 * y, y2 * y2]
    ys = torch.tensor(ys, dtype=torch.float64, device=grid.device)
    ttm0 = 0.0
    prices = []
    for i, ttm in enumerate(ttms_static):
        a_t = afe.solve_a_ode_grid(
            ttm=ttm - ttm0, theta=theta, kappa1=kappa1, kappa2=kappa2, beta=beta,
            volvol=volvol, phi_grid=phi_grid, psi_grid=psi_grid, a_t0=a_t,
            is_spot_measure=is_spot_measure, expansion_order=expansion_order,
            vol_backbone_eta=float(vol_backbone_etas[i]), year_steps=year_steps)
        log_mgf = torch.complex(a_t.real @ ys, a_t.imag @ ys)
        prices.append(mgf.vanilla_prices_with_mgf_grid(
            log_mgf_grid=log_mgf, phi_grid=phi_grid, forwards=grid.forwards[i],
            strikes=grid.strikes[i], optiontypes=grid.optioncodes[i],
            discfactors=grid.discfactors[i], is_spot_measure=is_spot_measure,
            is_simpson=is_simpson))
        ttm0 = ttm
    return torch.stack(prices, dim=0)


# ----------------------------------------------------------------------------
# Monte Carlo (Eq. 3.59 scheme)
# ----------------------------------------------------------------------------

def simulate_logsv_terminal(gen: torch.Generator,
                            x0: torch.Tensor,
                            sigma0: torch.Tensor,
                            qvar0: torch.Tensor,
                            ttm: float,
                            theta: float,
                            kappa1: float,
                            kappa2: float,
                            beta: float,
                            volvol: float,
                            vol_backbone_eta: float = 1.0,
                            is_spot_measure: bool = True,
                            nb_steps_per_year: int = 360
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """explicit Euler on (X, ln sigma, I) to horizon ttm, one eager step at a
    time in the dtype of ``x0``, with normals drawn from ``gen``.

    The reference discretization: X uses the pre-update sigma, the
    ln-sigma drift is (kappa1 theta/sigma - kappa1) + kappa2(theta - sigma)
    + adj sigma - 0.5 vartheta^2 with adj = beta*eta under the inverse
    measure, and the quadratic variance accumulates trapezoidally.
    """
    nb_steps, dt, _ = set_time_grid(ttm=ttm, nb_steps_per_year=nb_steps_per_year)
    sdt = float(np.sqrt(dt))
    if is_spot_measure:
        alpha, adj = -1.0, 0.0
    else:
        alpha, adj = 1.0, beta * vol_backbone_eta
    vartheta2 = beta * beta + volvol * volvol
    eta2 = vol_backbone_eta * vol_backbone_eta
    nb_path = x0.shape[0]
    x, log_sigma, sigma, qvar = x0, torch.log(sigma0), sigma0, qvar0
    for _ in range(nb_steps):
        w = step_normals(gen, (2, nb_path), dtype=x0.dtype) * sdt
        w0, w1 = w[0], w[1]
        sigma_2dt = eta2 * sigma * sigma * dt
        x = x + alpha * 0.5 * sigma_2dt + vol_backbone_eta * sigma * w0
        log_sigma = log_sigma + ((kappa1 * theta / sigma - kappa1)
                                 + kappa2 * (theta - sigma) + adj * sigma
                                 - 0.5 * vartheta2) * dt + beta * w0 + volvol * w1
        sigma_new = torch.exp(log_sigma)
        qvar = qvar + 0.5 * (sigma_2dt + eta2 * sigma_new * sigma_new * dt)
        sigma = sigma_new
    return x, sigma, qvar


def logsv_mc_chain_pricer(ttms: np.ndarray,
                          forwards: np.ndarray,
                          discfactors: np.ndarray,
                          strikes_ttms,
                          optiontypes_ttms,
                          v0: float,
                          theta: float,
                          kappa1: float,
                          kappa2: float,
                          beta: float,
                          volvol: float,
                          vol_backbone_etas: Optional[np.ndarray] = None,
                          is_spot_measure: bool = True,
                          nb_path: int = 100000,
                          nb_steps_per_year: int = 360,
                          variable_type: VariableType = VariableType.LOG_RETURN,
                          seed: Optional[int] = None,
                          dtype: torch.dtype = torch.float64,
                          engine: str = "scan",
                          device="cuda"
                          ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """chain MC with the terminal state carried across maturities.

    ``engine='cuda'`` (alias ``'pallas'``) runs each slice's path loop in
    float32 through the hand-written CUDA kernel when ``device`` is a CUDA
    device, and through its plain version on the CPU; slice ``i`` takes the
    seed ``base + 7919*i``.  ``engine='scan'`` (default) runs the eager
    Euler loop in ``dtype`` with normals from a generator seeded by ``seed``.
    """
    if vol_backbone_etas is None:
        vol_backbone_etas = np.ones_like(np.asarray(ttms))
    if engine == "pallas":
        engine = "cuda"
    if engine not in ("scan", "cuda"):
        raise NotImplementedError(f"engine={engine}")
    device = torch.device(device)
    if engine == "cuda":
        nb_pad, base_seed = engine_setup(seed, nb_path)
        x = torch.zeros(nb_pad, dtype=torch.float32, device=device)
        sigma = torch.full((nb_pad,), v0, dtype=torch.float32, device=device)
        qvar = torch.zeros(nb_pad, dtype=torch.float32, device=device)
    else:
        gen = generator_from_seed(seed, device=device)
        x = torch.zeros(nb_path, dtype=dtype, device=device)
        sigma = torch.full((nb_path,), v0, dtype=dtype, device=device)
        qvar = torch.zeros(nb_path, dtype=dtype, device=device)
    ttm0 = 0.0
    option_prices_ttm, option_std_ttm = [], []
    for i, ttm in enumerate(ttms):
        kw = dict(ttm=float(ttm - ttm0), theta=theta, kappa1=kappa1, kappa2=kappa2,
                  beta=beta, volvol=volvol, vol_backbone_eta=float(vol_backbone_etas[i]),
                  is_spot_measure=is_spot_measure, nb_steps_per_year=nb_steps_per_year)
        if engine == "cuda":
            x, sigma, qvar = simulate_logsv_terminal_kernel(
                seed=base_seed + 7919 * i, x0=x, sigma0=sigma, qvar0=qvar, **kw)
        else:
            x, sigma, qvar = simulate_logsv_terminal(gen=gen, x0=x, sigma0=sigma,
                                                     qvar0=qvar, **kw)
        ttm0 = float(ttm)
        prices, stds = compute_mc_vars_payoff(
            x0=x[:nb_path], sigma0=sigma[:nb_path], qvar0=qvar[:nb_path], ttm=ttm,
            forward=forwards[i], strikes_ttm=strikes_ttms[i],
            optiontypes_ttm=optiontypes_ttms[i], discfactor=discfactors[i],
            variable_type=variable_type)
        option_prices_ttm.append(prices)
        option_std_ttm.append(stds)
    return option_prices_ttm, option_std_ttm


# ----------------------------------------------------------------------------
# pricer class
# ----------------------------------------------------------------------------

class LogSVPricer(ModelPricer):
    """ModelPricer for the LogSV model of Eq. (3.12); tensors live on ``device``."""

    def price_chain(self, option_chain: OptionChain, params: LogSvParams,
                    is_spot_measure: bool = True,
                    variable_type: VariableType = VariableType.LOG_RETURN,
                    expansion_order: ExpansionOrder = ExpansionOrder.SECOND,
                    vol_scaler: Optional[float] = None,
                    precision: str = "exact",
                    **kwargs) -> List[np.ndarray]:
        """analytic chain prices by the float64 transform engine.

        ``precision='exact'`` (default) runs the RK4 at 240 steps/yr;
        ``'fast'`` runs the same float64 solver at 360 steps/yr (the JAX
        package's fast path is mixed precision; the card has native f64).
        ``year_steps=`` overrides; ``exact_engine=`` is accepted and ignored.
        """
        if precision not in _YEAR_STEPS:
            raise NotImplementedError(f"precision={precision}")
        year_steps = kwargs.pop("year_steps", _YEAR_STEPS[precision])
        kwargs.pop("exact_engine", None)
        if vol_scaler is None:
            vol_scaler = set_vol_scaler(sigma0=params.sigma0, ttm=np.min(option_chain.ttms))
        grid = option_chain.to_grid(device=self.device)
        etas = params.get_vol_backbone_etas(ttms=option_chain.ttms)
        prices = logsv_chain_price_grid(
            grid, sigma0=float(params.sigma0), theta=float(params.theta),
            kappa1=float(params.kappa1), kappa2=float(params.kappa2),
            beta=float(params.beta), volvol=float(params.volvol),
            vol_backbone_etas=etas, vol_scaler=float(vol_scaler),
            ttms_static=tuple(float(t) for t in option_chain.ttms),
            variable_type=variable_type, expansion_order=expansion_order,
            is_spot_measure=is_spot_measure, year_steps=year_steps)
        return option_chain.unpad_panel(prices)

    @timer
    def model_mc_price_chain(self, option_chain: OptionChain, params: LogSvParams,
                             is_spot_measure: bool = True,
                             variable_type: VariableType = VariableType.LOG_RETURN,
                             nb_path: int = 100000,
                             nb_steps: Optional[int] = None,
                             seed: Optional[int] = None,
                             **kwargs) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """MC chain prices and standard errors on the pricer's device.

        ``nb_steps`` is the steps-per-year of the Euler grid; its default is
        ``int(360 * max ttm) + 1``, as in the JAX package.
        ``use_rough_mc=True`` runs the rough lift of ``params.nodes`` and
        ``params.weights`` (set them with ``params.approximate_kernel(T)``)
        through :func:`rough_logsv_mc_chain_pricer` at ``nb_steps or 360``
        steps per year.  Antithetic draws are not ported and raise.
        """
        if kwargs.get("antithetic"):
            raise NotImplementedError("antithetic LogSV MC is not ported")
        if kwargs.get("use_rough_mc"):
            if params.nodes is None or params.weights is None:
                raise ValueError("the rough MC needs params.nodes and params.weights: "
                                 "call params.approximate_kernel(T) first")
            return rough_logsv_mc_chain_pricer(
                ttms=option_chain.ttms, forwards=option_chain.forwards,
                discfactors=option_chain.discfactors, strikes_ttms=option_chain.strikes_ttms,
                optiontypes_ttms=option_chain.optiontypes_ttms, sigma0=params.sigma0,
                theta=params.theta, kappa1=params.kappa1, kappa2=params.kappa2,
                beta=params.beta, volvol=params.volvol, weights=params.weights,
                nodes=params.nodes, nb_path=nb_path, nb_steps_per_year=nb_steps or 360,
                variable_type=variable_type, seed=seed, engine=kwargs.get("engine", "scan"),
                device=self.device)
        return logsv_mc_chain_pricer(
            v0=params.sigma0, theta=params.theta, kappa1=params.kappa1,
            kappa2=params.kappa2, beta=params.beta, volvol=params.volvol,
            vol_backbone_etas=params.get_vol_backbone_etas(ttms=option_chain.ttms),
            ttms=option_chain.ttms, forwards=option_chain.forwards,
            discfactors=option_chain.discfactors,
            strikes_ttms=option_chain.strikes_ttms,
            optiontypes_ttms=option_chain.optiontypes_ttms,
            is_spot_measure=is_spot_measure, variable_type=variable_type,
            nb_path=nb_path, seed=seed,
            nb_steps_per_year=nb_steps or int(360 * np.max(option_chain.ttms)) + 1,
            engine=kwargs.get("engine", "scan"), device=self.device)
