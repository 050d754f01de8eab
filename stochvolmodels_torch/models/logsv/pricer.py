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
Calibration fits the chain's mid vols with the analytic engine: SLSQP through
scipy with the objective's gradient from one ``torch.autograd`` backward
(through the RK4 and the implied-vol inversion), or Levenberg-Marquardt on
the device (``method='lm'``, ``fast_calibration.py``).
"""
from __future__ import annotations

from enum import Enum
from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy.optimize import minimize

from stochvolmodels_torch.config import VariableType
from stochvolmodels_torch.data.option_chain import ChainGrid, OptionChain
from stochvolmodels_torch.models.logsv import affine as afe
from stochvolmodels_torch.models.logsv.affine import ExpansionOrder
from stochvolmodels_torch.models.logsv.params import LogSvParams
from stochvolmodels_torch.models.model_pricer import ModelPricer
from stochvolmodels_torch.models.rough.simulation import rough_logsv_mc_chain_pricer
from stochvolmodels_torch.ops import bsm, mgf
from stochvolmodels_torch.ops.cuda_mc import engine_setup, simulate_logsv_terminal_kernel
from stochvolmodels_torch.ops.payoffs import compute_mc_vars_payoff
from stochvolmodels_torch.ops.random import generator_from_seed, step_normals
from stochvolmodels_torch.utils.funcs import set_time_grid, timer

class LogsvModelCalibrationType(Enum):
    """which parameters the calibration solves for."""
    PARAMS4 = 1               # sigma0, theta, beta, volvol; kappa1/kappa2 fixed
    PARAMS5 = 2               # sigma0, theta, kappa1, beta, volvol; kappa2 = kappa1/theta
    PARAMS6 = 3               # all six
    PARAMS_WITH_VARSWAP_FIT = 4  # beta, volvol; backbone fit to varswap strikes


class ConstraintsType(Enum):
    """martingale/moment constraints of Theorem 3.7."""
    UNCONSTRAINT = 1
    MMA_MARTINGALE = 2           # kappa2 >= beta
    INVERSE_MARTINGALE = 3       # kappa2 >= 2 beta
    MMA_MARTINGALE_MOMENT4 = 4
    INVERSE_MARTINGALE_MOMENT4 = 5


class CalibrationEngine(Enum):
    """model-vol engine inside the calibration objective."""
    ANALYTIC = 1
    MC = 2
    ROUGH_MC = 3


LOGSV_BTC_PARAMS = LogSvParams(sigma0=0.8376, theta=1.0413, kappa1=3.1844,
                               kappa2=3.058, beta=0.1514, volvol=1.8458)

# steps per year of the RK4 A(tau) solve for each precision, and in the
# SLSQP objective (the JAX package's setting there)
_YEAR_STEPS = {"exact": 240, "fast": 360}
_SLSQP_YEAR_STEPS = 720


def set_vol_scaler(sigma0: float, ttm: float) -> float:
    """transform-grid scaler; lower bound two weeks."""
    return sigma0 * np.sqrt(np.minimum(np.min(ttm), 0.5 / 12.0))


def use_float32_default() -> bool:
    """False: the port's calibration objectives run in float64, the card's
    native precision (the JAX package defaults to float32 on a TPU, which
    has no native float64); ``use_float32=`` is accepted and mapped to
    float64."""
    return False


def _pad_panel(ragged, grid: ChainGrid) -> np.ndarray:
    """a ragged list of per-slice arrays as a (n_ttm, max_strikes) numpy panel,
    zero-padded."""
    t, k = grid.mask.shape
    out = np.zeros((t, k))
    for i, a in enumerate(ragged):
        out[i, :len(np.asarray(a))] = np.asarray(a)
    return out


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
    previous slice's A by ``ttm_i - ttm_{i-1}``.  The model parameters and
    ``vol_scaler`` are Python floats or 0-dim float64 tensors on the grid's
    device; with tensors the prices carry their gradients (reverse mode) and
    tangents (``torch.func.jacfwd``), and have the same bits as from floats.
    The maturities (``ttms_static``) fix the step counts on the host.
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
    if isinstance(y, torch.Tensor):
        ys = torch.stack([afe._tensor_of(v, y) for v in ys])
    else:
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
        _, prices = self._price_panel(option_chain, params, is_spot_measure=is_spot_measure,
                                      variable_type=variable_type,
                                      expansion_order=expansion_order, vol_scaler=vol_scaler,
                                      precision=precision, **kwargs)
        return option_chain.unpad_panel(prices)

    def _price_panel(self, option_chain: OptionChain, params: LogSvParams,
                     is_spot_measure: bool = True,
                     variable_type: VariableType = VariableType.LOG_RETURN,
                     expansion_order: ExpansionOrder = ExpansionOrder.SECOND,
                     vol_scaler: Optional[float] = None,
                     precision: str = "exact",
                     **kwargs) -> Tuple[ChainGrid, torch.Tensor]:
        """(grid, padded price panel) of :meth:`price_chain`."""
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
        return grid, prices

    def compute_model_ivols_for_chain(self, option_chain: OptionChain, params: LogSvParams,
                                      precision: str = "exact", **kwargs) -> List[np.ndarray]:
        """model implied vols for the chain.

        ``precision='exact'`` prices at 240 steps/yr and inverts by the
        200-step bisection; ``'fast'`` prices at 360 steps/yr (float64) and
        inverts by the fast implied vol (bisection + Newton), as the JAX
        package's fused fast path does.
        """
        if precision != "fast":
            return super().compute_model_ivols_for_chain(
                option_chain=option_chain, params=params, precision=precision, **kwargs)
        grid, prices = self._price_panel(option_chain, params, precision=precision, **kwargs)
        vols = bsm.infer_bsm_implied_vol_fast(
            forward=grid.forwards[:, None], ttm=grid.ttms[:, None], strike=grid.strikes,
            given_price=prices, discfactor=grid.discfactors[:, None],
            optiontype=grid.optioncodes)
        return option_chain.unpad_panel(vols)

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

    def set_vol_scaler(self, option_chain: OptionChain) -> float:
        """grid scaler from the first ATM vol, frozen across calibration
        iterations."""
        atm0 = option_chain.get_chain_atm_vols()[0]
        return set_vol_scaler(sigma0=atm0, ttm=option_chain.ttms[0])

    @timer
    def calibrate_model_params_to_chain(self,
                                        option_chain: OptionChain,
                                        params0: LogSvParams,
                                        params_min: LogSvParams = LogSvParams(
                                            sigma0=0.1, theta=0.1, kappa1=0.25,
                                            kappa2=0.25, beta=-3.0, volvol=0.2),
                                        params_max: LogSvParams = LogSvParams(
                                            sigma0=1.5, theta=1.5, kappa1=10.0,
                                            kappa2=10.0, beta=3.0, volvol=3.0),
                                        is_vega_weighted: bool = True,
                                        is_unit_ttm_vega: bool = False,
                                        model_calibration_type: LogsvModelCalibrationType = LogsvModelCalibrationType.PARAMS5,
                                        constraints_type: ConstraintsType = ConstraintsType.UNCONSTRAINT,
                                        calibration_engine: CalibrationEngine = CalibrationEngine.ANALYTIC,
                                        nb_path: int = 100000,
                                        nb_steps: int = 360,
                                        seed: int = 10,
                                        use_float32: Optional[bool] = None,
                                        **kwargs) -> LogSvParams:
        """fit the model to the chain's mid vols: the (vega-weighted) implied
        vol MSE of Eq. (6.3), under the Theorem 3.7 constraints.

        ``method='slsqp'`` (default): scipy SLSQP with bounds and the
        constraints as inequality constraints; each evaluation prices the
        chain with tensor parameters (RK4 at 720 steps per year, the
        JAX package's setting), inverts by the 200-step bisection and takes
        the objective's gradient by one ``torch.autograd`` backward on the
        pricer's device.  NaN model vols drop out of the objective before
        squaring.  scipy's result is kept as ``self.calibration_result``.

        ``method='lm'``: :func:`calibrate_logsv_lm_on_device` (PARAMS5 only),
        with ``nb_iters=16`` and ``year_steps=180`` unless given.

        Not ported, and raising ``NotImplementedError``: the ``MC`` and
        ``ROUGH_MC`` engines (with their fixed-randoms MC) and
        ``PARAMS_WITH_VARSWAP_FIT`` (it needs ``vol_moments.py``).
        ``nb_path``, ``nb_steps`` and ``seed`` serve those engines only.
        ``use_float32`` is accepted and mapped to float64.
        """
        del nb_path, nb_steps, seed, use_float32
        method = kwargs.pop("method", "slsqp")
        if method not in ("slsqp", "lm"):
            raise ValueError(f"method must be 'slsqp' or 'lm', got {method!r}")
        if calibration_engine != CalibrationEngine.ANALYTIC:
            raise NotImplementedError(
                f"{calibration_engine}: the MC and ROUGH_MC calibration engines and their "
                f"fixed-randoms Monte Carlo are not ported; use CalibrationEngine.ANALYTIC")
        mct = model_calibration_type
        if mct == LogsvModelCalibrationType.PARAMS_WITH_VARSWAP_FIT:
            raise NotImplementedError(
                "PARAMS_WITH_VARSWAP_FIT needs the varswap backbone fit of vol_moments.py, "
                "which is not ported")
        if method == "lm":
            if mct != LogsvModelCalibrationType.PARAMS5:
                raise NotImplementedError("method='lm' supports the ANALYTIC PARAMS5 calibration")
            from stochvolmodels_torch.models.logsv.fast_calibration import (
                calibrate_logsv_lm_on_device)
            fit, _ = calibrate_logsv_lm_on_device(
                option_chain=option_chain, params0=params0, constraints_type=constraints_type,
                is_vega_weighted=is_vega_weighted, params_min=params_min,
                params_max=params_max, nb_iters=kwargs.pop("nb_iters", 16),
                year_steps=kwargs.pop("year_steps", 180), device=self.device)
            return fit

        objective, p0, bounds, constraints, expand = self._slsqp_problem(
            option_chain, params0, params_min, params_max, is_vega_weighted, is_unit_ttm_vega,
            mct, constraints_type)
        options = {"ftol": 1e-8, "maxiter": 200}
        if constraints:
            res = minimize(objective, p0, jac=True, method="SLSQP", constraints=constraints,
                           bounds=bounds, options=options)
        else:
            res = minimize(objective, p0, jac=True, method="SLSQP", bounds=bounds,
                           options=options)
        self.calibration_result = res
        sigma0, theta, kappa1, kappa2, beta, volvol = (float(v) for v in expand(res.x))
        return LogSvParams(sigma0=sigma0, theta=theta, kappa1=kappa1, kappa2=kappa2,
                           beta=beta, volvol=volvol, H=params0.H, nodes=params0.nodes,
                           weights=params0.weights)

    def _slsqp_problem(self, option_chain: OptionChain, params0: LogSvParams,
                       params_min: LogSvParams, params_max: LogSvParams,
                       is_vega_weighted: bool, is_unit_ttm_vega: bool,
                       mct: LogsvModelCalibrationType, constraints_type: ConstraintsType):
        """(objective, p0, bounds, constraints, expand) of the SLSQP fit.

        ``objective(x)`` returns (loss, gradient) as (float, numpy) from one
        forward and one backward pass on the pricer's device; ``expand(x)``
        maps the optimizer vector to (sigma0, theta, kappa1, kappa2, beta,
        volvol); ``constraints`` are scipy's inequality dicts (empty when
        unconstrained).
        """
        vol_scaler = self.set_vol_scaler(option_chain=option_chain)
        grid = option_chain.to_grid(device=self.device)
        market_panel = _pad_panel(option_chain.get_mid_vols(), grid)
        if is_vega_weighted:
            vegas_ttms = option_chain.get_chain_vegas(is_unit_ttm_vega=is_unit_ttm_vega)
            weights_panel = _pad_panel([v / np.sum(v) for v in vegas_ttms], grid)
        else:
            weights_panel = np.ones_like(market_panel)
        mask = grid.mask.cpu().numpy()
        f64 = dict(dtype=torch.float64, device=self.device)
        weights = torch.as_tensor(np.where(mask, weights_panel, 0.0), **f64)
        market_vols = torch.as_tensor(np.where(mask, market_panel, 0.0), **f64)
        ttms_static = tuple(float(t) for t in option_chain.ttms)

        def expand(pars):
            """(sigma0, theta, kappa1, kappa2, beta, volvol) of the optimizer
            vector (a numpy array or a tensor)."""
            if mct == LogsvModelCalibrationType.PARAMS4:
                return (pars[0], pars[1], params0.kappa1, params0.kappa2, pars[2], pars[3])
            if mct == LogsvModelCalibrationType.PARAMS5:
                return (pars[0], pars[1], pars[2], pars[2] / pars[1], pars[3], pars[4])
            if mct == LogsvModelCalibrationType.PARAMS6:
                return tuple(pars[i] for i in range(6))
            raise NotImplementedError(f"{mct}")

        def loss_fn(pars: torch.Tensor) -> torch.Tensor:
            sigma0, theta, kappa1, kappa2, beta, volvol = expand(pars)
            prices = logsv_chain_price_grid(
                grid, sigma0=sigma0, theta=theta, kappa1=kappa1, kappa2=kappa2, beta=beta,
                volvol=volvol, vol_scaler=vol_scaler, ttms_static=ttms_static,
                year_steps=_SLSQP_YEAR_STEPS)
            model_vols = bsm.infer_bsm_ivols_from_model_chain_prices(
                ttms=grid.ttms, forwards=grid.forwards, discfactors=grid.discfactors,
                strikes_ttms=grid.strikes, optiontypes_ttms=grid.optioncodes,
                model_prices_ttms=prices)
            # mask NaN vols before squaring: where(isnan(r), 0, r) alone would
            # leave a 0 * NaN = NaN in the backward pass
            nan_mask = torch.isnan(model_vols)
            clean = torch.where(nan_mask, market_vols, model_vols)
            resid = weights * torch.square(clean - market_vols)
            return torch.sum(torch.where(nan_mask, 0.0, resid))

        def objective(x: np.ndarray):
            pars = torch.tensor(np.asarray(x, dtype=np.float64), requires_grad=True, **f64)
            loss = loss_fn(pars)
            (grad,) = torch.autograd.grad(loss, pars)
            return float(loss.detach()), grad.cpu().numpy().astype(np.float64)

        names = {LogsvModelCalibrationType.PARAMS4: ("sigma0", "theta", "beta", "volvol"),
                 LogsvModelCalibrationType.PARAMS5: ("sigma0", "theta", "kappa1", "beta",
                                                     "volvol"),
                 LogsvModelCalibrationType.PARAMS6: ("sigma0", "theta", "kappa1", "kappa2",
                                                     "beta", "volvol")}[mct]
        p0 = np.array([getattr(params0, k) for k in names], dtype=np.float64)
        bounds = tuple((getattr(params_min, k), getattr(params_max, k)) for k in names)

        def martingale_measure(x):
            _, _, _, kappa2, beta, _ = expand(x)
            return kappa2 - beta

        def inverse_measure(x):
            _, _, _, kappa2, beta, _ = expand(x)
            return kappa2 - 2.0 * beta

        def vol_4thmoment_finite(x):
            _, theta, kappa1, kappa2, beta, volvol = expand(x)
            kappa = kappa1 + kappa2 * theta
            return kappa - 1.5 * (beta * beta + volvol * volvol)

        funs = {ConstraintsType.UNCONSTRAINT: (),
                ConstraintsType.MMA_MARTINGALE: (martingale_measure,),
                ConstraintsType.INVERSE_MARTINGALE: (inverse_measure,),
                ConstraintsType.MMA_MARTINGALE_MOMENT4: (martingale_measure,
                                                         vol_4thmoment_finite),
                ConstraintsType.INVERSE_MARTINGALE_MOMENT4: (inverse_measure,
                                                             vol_4thmoment_finite)}
        constraints = tuple({"type": "ineq", "fun": f} for f in funs[constraints_type])
        return objective, p0, bounds, constraints, expand
