"""
Heston stochastic-volatility model: analytic Fourier pricing and Monte Carlo.

PyTorch counterpart of ``stochvolmodels_tpu/models/heston.py`` for the
serving path.  The closed-form log-MGF (Sepp 2007, formula 14) is elementwise
complex128 math over the whole transform grid, with the Riccati state (a, b)
chained across maturities.  Monte Carlo runs the full-truncation Euler
scheme, either eagerly in float64 (``engine='scan'``) or through the
hand-written CUDA kernel ``csrc/heston_mc.cu`` and its plain version
(``engine='cuda'``).  Calibration fits the chain's mid vols: SLSQP with the
Feller constraint and torch gradients, or Levenberg-Marquardt as one CUDA
graph on a card.  The eager engine also takes antithetic draws, and
``engine='qmc'`` draws randomized Sobol normals (one CUDA graph a slice on a
card); options on quadratic variance are priced on the Psi grid, and the
chain greeks come from ``models/greeks.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy.optimize import OptimizeResult, minimize

from stochvolmodels_torch.config import VariableType
from stochvolmodels_torch.data.option_chain import ChainGrid, OptionChain
from stochvolmodels_torch.models.logsv.affine import f64_scalars
from stochvolmodels_torch.models.logsv.pricer import _pad_panel
from stochvolmodels_torch.models.model_pricer import ModelParams, ModelPricer
from stochvolmodels_torch.ops import bsm, graphs, mgf, qmc
from stochvolmodels_torch.ops.cuda_mc import (VAR_FLOOR, engine_setup,
                                              simulate_heston_terminal_kernel)
from stochvolmodels_torch.ops.lm import lm_minimize
from stochvolmodels_torch.ops.payoffs import compute_mc_vars_payoff
from stochvolmodels_torch.ops.random import (DEFAULT_SEED, antithetic_step_normals,
                                             generator_from_seed, step_normals)
from stochvolmodels_torch.utils.funcs import set_time_grid
from stochvolmodels_torch.utils.profiling import (
    LM_FIT_SPAN,
    LM_PREPARE_SPAN,
    MC_CHAIN_SPAN,
    annotate,
    to_device,
    to_host,
)


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


def compute_heston_mgf_grid(v0,
                            theta,
                            kappa,
                            volvol,
                            rho,
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
    package's polar-form ``csqrt`` and ``clog`` do.  The parameters are
    Python floats or 0-dim float64 tensors on the grid's device (calibration
    differentiates through them); both give the same bits.
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
                            v0,
                            theta,
                            kappa,
                            volvol,
                            rho,
                            vol_scaler=None,
                            variable_type: VariableType = VariableType.LOG_RETURN,
                            is_spot_measure: bool = True,
                            is_simpson: bool = True,
                            ttms_static: Optional[Tuple[float, ...]] = None
                            ) -> torch.Tensor:
    """price the padded chain panel on the grid's device; returns (n_ttm,
    max_strikes) float64 prices.  Each slice advances the previous slice's
    Riccati state (a, b) by ``ttm_i - ttm_{i-1}``.

    The parameters and ``vol_scaler`` are Python floats or 0-dim float64
    tensors on the grid's device; with tensors the prices carry their
    gradients (reverse mode) and tangents (``torch.func.jacfwd``), and have
    the same bits as from floats.  The maturities (``ttms_static``, read
    from the grid when not given) are host numbers.  ``variable_type=Q_VAR``
    prices calls on the annualised quadratic variance on the 40,000-point
    Psi grid, from the same closed form.
    """
    if variable_type not in (VariableType.LOG_RETURN, VariableType.Q_VAR):
        raise NotImplementedError(f"variable_type={variable_type}")
    if ttms_static is None:
        ttms_static = tuple(float(t) for t in grid.ttms.cpu().numpy())
    if vol_scaler is None:
        vol_scaler = default_vol_scaler(float(v0), ttms_static[0])
    phi_grid, psi_grid, _ = mgf.get_transform_var_grid(
        variable_type=variable_type, is_spot_measure=is_spot_measure,
        vol_scaler=vol_scaler, device=grid.device)
    a_t, b_t = None, None
    ttm0 = 0.0
    prices = []
    for i, ttm in enumerate(ttms_static):
        log_mgf, a_t, b_t = compute_heston_mgf_grid(
            v0=v0, theta=theta, kappa=kappa, volvol=volvol, rho=rho, ttm=ttm - ttm0,
            phi_grid=phi_grid, psi_grid=psi_grid, a_t0=a_t, b_t0=b_t)
        if variable_type == VariableType.LOG_RETURN:
            prices.append(mgf.vanilla_prices_with_mgf_grid(
                log_mgf_grid=log_mgf, phi_grid=phi_grid, forwards=grid.forwards[i],
                strikes=grid.strikes[i], optiontypes=grid.optioncodes[i],
                discfactors=grid.discfactors[i], is_spot_measure=is_spot_measure,
                is_simpson=is_simpson))
        else:
            prices.append(mgf.qvar_prices_with_mgf_grid(
                log_mgf_grid=log_mgf, psi_grid=psi_grid, ttms=grid.ttms[i],
                strikes=grid.strikes[i], optiontypes=grid.optioncodes[i],
                forwards=grid.forwards[i], discfactors=grid.discfactors[i],
                is_simpson=is_simpson, is_spot_measure=is_spot_measure))
        ttm0 = ttm
    return torch.stack(prices, dim=0)


# ----------------------------------------------------------------------------
# Monte Carlo
# ----------------------------------------------------------------------------

def _heston_step(x, var, qvar, w0, w1, dt: float, theta, kappa, rho, rho_1, volvol):
    """one full-truncation Euler step on scaled increments (w0, w1)."""
    sigma = torch.sqrt(var)
    var_dt = var * dt
    x = x - 0.5 * var_dt + sigma * w0
    qvar = qvar + var_dt
    var = var + kappa * (theta - var) * dt + sigma * volvol * (rho * w0 + rho_1 * w1)
    return x, torch.clamp(var, min=VAR_FLOOR), qvar


def simulate_heston_terminal(gen: torch.Generator,
                             x0: torch.Tensor,
                             var0: torch.Tensor,
                             qvar0: torch.Tensor,
                             ttm: float,
                             theta: float,
                             kappa: float,
                             rho: float,
                             volvol: float,
                             nb_steps_per_year: int = 360,
                             antithetic: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """full-truncation Euler to the horizon ``ttm``, one eager step at a time
    in the dtype of ``x0``, with normals drawn from ``gen`` (``antithetic``:
    path i + P/2 takes the negated draws of path i)."""
    nb_steps, dt, _ = set_time_grid(ttm=ttm, nb_steps_per_year=nb_steps_per_year)
    sqrt_dt = float(np.sqrt(dt))
    rho_1 = float(np.sqrt(1.0 - rho * rho))
    nb_path = x0.shape[0]
    draw = antithetic_step_normals if antithetic else step_normals
    x, var, qvar = x0, var0, qvar0
    for _ in range(nb_steps):
        w = draw(gen, (2, nb_path), dtype=x0.dtype) * sqrt_dt
        x, var, qvar = _heston_step(x, var, qvar, w[0], w[1], dt, theta, kappa, rho, rho_1,
                                    volvol)
    return x, var, qvar


def _heston_qmc_core_impl(v_tot, shift_tot, v_steps, shifts, bits, x0, var0, qvar0, pvec, *,
                          dt: float, dtype, nb_replicates: int):
    """the two passes of the Heston QMC Euler: the raw step columns summed,
    then the steps on the increments conditioned on the stratified totals."""
    nb_steps, nb_path = v_steps.shape[0], x0.shape[0]
    sqrt_dt = float(np.sqrt(dt))
    theta, kappa, rho, volvol = pvec.unbind()
    rho_1 = torch.sqrt(1.0 - rho * rho)
    expand = lambda shift: qmc.expand_replicate_shifts(shift, nb_path, nb_replicates)
    s0 = s1 = torch.zeros(x0.shape, dtype=dtype, device=x0.device)
    for t in range(nb_steps):
        z0, z1 = qmc.qmc_step_normals(bits, v_steps[t], expand(shifts[t]), dtype)
        s0, s1 = s0 + z0, s1 + z1
    t0, t1 = qmc.qmc_step_normals(bits, v_tot, expand(shift_tot), dtype)
    c0 = qmc.stratified_increment_shift(t0, s0, nb_steps)
    c1 = qmc.stratified_increment_shift(t1, s1, nb_steps)
    carry = x0.dtype
    x, var, qvar = x0, var0, qvar0
    for t in range(nb_steps):
        z0, z1 = qmc.qmc_step_normals(bits, v_steps[t], expand(shifts[t]), dtype)
        x, var, qvar = (a.to(carry) for a in _heston_step(
            x, var, qvar, (z0 + c0) * sqrt_dt, (z1 + c1) * sqrt_dt, dt, theta, kappa, rho, rho_1,
            volvol))
    return x, var, qvar


def _simulate_heston_terminal_qmc_core(v_tot: torch.Tensor,
                                       shift_tot: torch.Tensor,
                                       v_steps: torch.Tensor,
                                       shifts: torch.Tensor,
                                       x0: torch.Tensor,
                                       var0: torch.Tensor,
                                       qvar0: torch.Tensor,
                                       dt: float,
                                       theta,
                                       kappa,
                                       rho,
                                       volvol,
                                       dtype: torch.dtype = torch.float64,
                                       nb_replicates: int = 0
                                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """the full-truncation Euler of :func:`simulate_heston_terminal` on
    randomized Sobol normals: path i is Sobol point i, each step takes two
    columns, and each Brownian stream's slice total is stratified onto the
    slice's two leading dimensions.  The panels are those of
    :func:`qmc.qmc_scan_panels`; with ``nb_replicates`` R the paths are R
    contiguous groups, each the same point set under its own shifts.  On
    the card the slice runs as one CUDA graph per (paths, steps, dt, R,
    dtype)."""
    nb_path = x0.shape[0]
    bits = qmc.gray_bits(qmc.gray_codes(nb_path, nb_replicates, device=x0.device))
    pvec = torch.stack(f64_scalars(x0.device, theta, kappa, rho, volvol))
    static = dict(dt=float(dt), dtype=dtype, nb_replicates=int(nb_replicates))
    inputs = tuple(a.to(x0.device) for a in (v_tot, shift_tot, v_steps, shifts)) + (
        bits, x0, var0, qvar0, pvec)
    fn = lambda *a: _heston_qmc_core_impl(*a, **static)
    if graphs.use_graph(x0):
        key = (nb_path, v_steps.shape[0]) + tuple(static.values()) + (str(x0.device),)
        return graphs.run_captured("heston_qmc", key, fn, inputs)
    return fn(*inputs)


def simulate_heston_terminal_qmc(seed: Optional[int],
                                 x0: torch.Tensor,
                                 var0: torch.Tensor,
                                 qvar0: torch.Tensor,
                                 ttm: float,
                                 theta,
                                 kappa,
                                 rho,
                                 volvol,
                                 nb_steps_per_year: int = 360,
                                 dtype: torch.dtype = torch.float64,
                                 dim_offset: int = 0,
                                 nb_replicates: int = 0
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """terminal (x, var, qvar) by randomized QMC; ``dim_offset`` counts the
    Sobol dimensions of earlier slices of a chain, so a chain continues one
    sequence.  The digital shifts come from a generator seeded with ``seed``
    (None -> 24)."""
    seed = DEFAULT_SEED if seed is None else int(seed)
    nb_steps, dt, _ = set_time_grid(ttm=ttm, nb_steps_per_year=nb_steps_per_year)
    panels = qmc.qmc_scan_panels(seed, nb_steps, per_step=2, dim_offset=dim_offset,
                                 nb_replicates=nb_replicates, device=x0.device)
    return _simulate_heston_terminal_qmc_core(
        *panels, x0, var0, qvar0, dt=dt, theta=theta, kappa=kappa, rho=rho, volvol=volvol,
        dtype=dtype, nb_replicates=nb_replicates)


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
                           device="cuda",
                           antithetic: bool = False,
                           qmc_replicates: int = 8
                           ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """chain MC with the terminal state carried across maturities; returns
    ragged (prices, stderrs).

    ``engine='cuda'`` (alias ``'pallas'``) carries (x, var, qvar) in float32
    through the hand-written CUDA kernel on a CUDA ``device`` and through its
    plain version on the CPU; slice ``i`` takes the seed ``base + 7919*i``.
    ``engine='scan'`` (default) runs the eager Euler loop in ``dtype`` with
    normals from a generator seeded by ``seed``; ``antithetic=True`` (scan
    only) mirrors path i + P/2 on path i and takes the stderr over the pair
    averages.  ``engine='qmc'`` draws randomized Sobol normals (one sequence
    across the chain) in ``qmc_replicates`` independently shifted copies,
    with the stderr over the replicate means (0 or 1: one unreplicated
    set).  Antithetic and replicated runs pad ``nb_path`` up to a multiple
    of 2 or R.
    """
    if engine == "pallas":
        engine = "cuda"
    if engine not in ("scan", "cuda", "qmc"):
        raise NotImplementedError(f"engine={engine}")
    if antithetic and engine != "scan":
        raise NotImplementedError("antithetic variates require engine='scan' (the kernel "
                                  "draws its normals on the card; Sobol points are "
                                  "stratified already)")
    if antithetic and nb_path % 2:
        nb_path += 1
    qmc_replicates = int(qmc_replicates) if engine == "qmc" else 0
    if qmc_replicates == 1:
        qmc_replicates = 0
    if qmc_replicates and nb_path % qmc_replicates:
        nb_path += qmc_replicates - nb_path % qmc_replicates
    device = torch.device(device)
    if engine == "cuda":
        nb_pad, base_seed = engine_setup(seed, nb_path)
        dtype = torch.float32
    else:
        nb_pad = nb_path
        if engine == "scan":
            gen = generator_from_seed(seed, device=device)
    x = torch.zeros(nb_pad, dtype=dtype, device=device)
    var = torch.full((nb_pad,), v0, dtype=dtype, device=device)
    qvar = torch.zeros(nb_pad, dtype=dtype, device=device)
    ttm0 = 0.0
    dim_offset = 0
    option_prices_ttm, option_std_ttm = [], []
    for i, ttm in enumerate(ttms):
        kw = dict(ttm=float(ttm - ttm0), theta=theta, kappa=kappa, rho=rho, volvol=volvol)
        if engine == "cuda":
            x, var, qvar = simulate_heston_terminal_kernel(
                seed=base_seed + 7919 * i, x0=x, var0=var, qvar0=qvar, **kw)
        elif engine == "qmc":
            x, var, qvar = simulate_heston_terminal_qmc(
                seed, x, var, qvar, dtype=dtype, dim_offset=dim_offset,
                nb_replicates=qmc_replicates, **kw)
            dim_offset += qmc.qmc_dims_per_slice(set_time_grid(ttm=kw["ttm"])[0])
        else:
            x, var, qvar = simulate_heston_terminal(gen=gen, x0=x, var0=var, qvar0=qvar,
                                                    antithetic=antithetic, **kw)
        ttm0 = float(ttm)
        prices, stds = compute_mc_vars_payoff(
            x0=x[:nb_path], sigma0=torch.sqrt(var[:nb_path]), qvar0=qvar[:nb_path], ttm=ttm,
            forward=forwards[i], strikes_ttm=strikes_ttms[i],
            optiontypes_ttm=optiontypes_ttms[i], discfactor=discfactors[i],
            variable_type=variable_type, antithetic=antithetic, nb_replicates=qmc_replicates)
        option_prices_ttm.append(prices)
        option_std_ttm.append(stds)
    return option_prices_ttm, option_std_ttm


# ----------------------------------------------------------------------------
# pricer class
# ----------------------------------------------------------------------------

class HestonPricer(ModelPricer):
    """ModelPricer for Heston, valued by Fourier inversion of the analytic
    MGF; tensors live on ``device``."""

    def compute_chain_greeks(self, option_chain: OptionChain, params: HestonParams,
                             greeks=("delta", "gamma", "vega"), **kwargs):
        """model-consistent chain greeks by forward-mode AD through the
        analytic pricer on the pricer's device (``models/greeks.py``)."""
        from stochvolmodels_torch.models.greeks import heston_chain_greeks
        return heston_chain_greeks(option_chain=option_chain, params=params, greeks=greeks,
                                   device=self.device, **kwargs)

    def price_chain(self, option_chain: OptionChain, params: HestonParams,
                    variable_type: VariableType = VariableType.LOG_RETURN,
                    vol_scaler: Optional[float] = None,
                    precision: str = "exact",
                    **kwargs) -> List[np.ndarray]:
        """analytic chain prices in float64.  ``precision='fast'`` (mixed
        precision in the JAX package) runs the same float64 path: the card
        has native complex128."""
        _, prices = self._price_panel(option_chain, params, variable_type=variable_type,
                                      vol_scaler=vol_scaler, precision=precision)
        return option_chain.unpad_panel(prices)

    def _price_panel(self, option_chain: OptionChain, params: HestonParams,
                     variable_type: VariableType = VariableType.LOG_RETURN,
                     vol_scaler: Optional[float] = None,
                     precision: str = "exact") -> Tuple[ChainGrid, torch.Tensor]:
        """(grid, padded price panel) of :meth:`price_chain`."""
        if precision not in ("exact", "fast"):
            raise NotImplementedError(f"precision={precision}")
        if vol_scaler is None:
            vol_scaler = default_vol_scaler(params.v0, float(option_chain.ttms[0]))
        grid = option_chain.to_grid(device=self.device)
        prices = heston_chain_price_grid(
            grid, v0=float(params.v0), theta=float(params.theta), kappa=float(params.kappa),
            volvol=float(params.volvol), rho=float(params.rho), vol_scaler=float(vol_scaler),
            variable_type=variable_type, ttms_static=tuple(float(t) for t in option_chain.ttms))
        return grid, prices

    def compute_model_ivols_for_chain(self, option_chain: OptionChain, params: HestonParams,
                                      precision: str = "exact", **kwargs) -> List[np.ndarray]:
        """model implied vols for the chain.

        ``precision='exact'`` inverts by the 200-step bisection; ``'fast'``
        inverts the same float64 prices by the fast implied vol (bisection +
        Newton), NaN on padded slots, as the JAX package's fused fast path
        does (whose closed form runs in float32 there).
        """
        if precision != "fast":
            return super().compute_model_ivols_for_chain(
                option_chain=option_chain, params=params, precision=precision, **kwargs)
        grid, prices = self._price_panel(
            option_chain, params, variable_type=kwargs.pop("variable_type", VariableType.LOG_RETURN),
            vol_scaler=kwargs.pop("vol_scaler", None), precision=precision)
        vols = bsm.infer_bsm_implied_vol_fast(
            forward=grid.forwards[:, None], ttm=grid.ttms[:, None], strike=grid.strikes,
            given_price=prices, discfactor=grid.discfactors[:, None],
            optiontype=grid.optioncodes)
        return option_chain.unpad_panel(torch.where(grid.mask, vols, torch.nan))

    @annotate(MC_CHAIN_SPAN)
    def model_mc_price_chain(self, option_chain: OptionChain, params: HestonParams,
                             nb_path: int = 100000,
                             variable_type: VariableType = VariableType.LOG_RETURN,
                             seed: Optional[int] = None,
                             **kwargs) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """MC chain prices and standard errors on the pricer's device
        (``engine='scan'``, ``'qmc'`` or ``'cuda'``/``'pallas'``;
        ``antithetic=True`` with ``'scan'``)."""
        return heston_mc_chain_pricer(
            ttms=option_chain.ttms, forwards=option_chain.forwards,
            discfactors=option_chain.discfactors, strikes_ttms=option_chain.strikes_ttms,
            optiontypes_ttms=option_chain.optiontypes_ttms, v0=params.v0,
            theta=params.theta, kappa=params.kappa, rho=params.rho, volvol=params.volvol,
            nb_path=nb_path, variable_type=variable_type, seed=seed,
            engine=kwargs.get("engine", "scan"), device=self.device,
            antithetic=kwargs.get("antithetic", False),
            qmc_replicates=kwargs.get("qmc_replicates", 8))

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

    def calibrate_model_params_to_chain(self,
                                        option_chain: OptionChain,
                                        params0: Optional[HestonParams] = None,
                                        is_vega_weighted: bool = True,
                                        is_unit_ttm_vega: bool = False,
                                        use_float32: Optional[bool] = None,
                                        **kwargs) -> HestonParams:
        """fit (v0, theta, kappa, rho, volvol) to the chain's mid vols.

        ``method='slsqp'`` (default): scipy SLSQP with the JAX package's
        bounds, the Feller inequality 2 kappa theta >= volvol^2 as a
        constraint with its analytic Jacobian, ``ftol`` 1e-8 and ``maxiter``
        200.  The objective is the vega-weighted squared error of the
        200-step bisection ivols, NaN vols dropped, and its gradient comes
        from one ``torch.autograd`` backward on the pricer's device.
        ``method='lm'``: :func:`calibrate_heston_lm`, ``nb_iters=16`` unless
        given, the whole fit one CUDA graph on a card.  Either way the
        transform grid is frozen at min(0.3, sqrt(p0[0] ttm0)), and the
        result (scipy's, or the LM's with its best cost as ``fun``) is kept
        as ``self.calibration_result``.  ``use_float32`` is accepted and
        mapped to float64.
        """
        del use_float32
        method = kwargs.pop("method", "slsqp")
        if method not in ("slsqp", "lm"):
            raise ValueError(f"method must be 'slsqp' or 'lm', got {method!r}")
        p0 = params0.to_array() if params0 is not None else HESTON_P0.copy()
        if method == "lm":
            nb_iters = kwargs.pop("nb_iters", 16)
            fit, cost = calibrate_heston_lm(
                option_chain, HestonParams(*p0), nb_iters=nb_iters,
                is_vega_weighted=is_vega_weighted, is_unit_ttm_vega=is_unit_ttm_vega,
                device=self.device)
            self.calibration_result = OptimizeResult(x=fit.to_array(), fun=cost, nit=nb_iters)
            return fit
        objective, feller, feller_jac = self._slsqp_problem(option_chain, p0, is_vega_weighted,
                                                            is_unit_ttm_vega)
        constraints = ({'type': 'ineq', 'fun': feller, 'jac': feller_jac})
        options = {'ftol': 1e-8, 'maxiter': 200}
        res = minimize(objective, p0, jac=True, method='SLSQP', constraints=constraints,
                       bounds=HESTON_BOUNDS, options=options)
        self.calibration_result = res
        v0, theta, kappa, rho, volvol = (float(v) for v in res.x)
        return HestonParams(v0=v0, theta=theta, kappa=kappa, rho=rho, volvol=volvol)

    def _slsqp_problem(self, option_chain: OptionChain, p0: np.ndarray, is_vega_weighted: bool,
                       is_unit_ttm_vega: bool):
        """(objective, feller, feller_jac) of the SLSQP fit: ``objective(x)``
        returns (loss, gradient) as (float, numpy) from one forward and one
        backward pass on the pricer's device."""
        grid, market_vols, weights, vol_scaler = _calibration_targets(
            option_chain, p0, is_vega_weighted, is_unit_ttm_vega, self.device)
        ttms_static = tuple(float(t) for t in option_chain.ttms)
        f64 = dict(dtype=torch.float64, device=self.device)

        def objective(x: np.ndarray):
            pars = torch.tensor(np.asarray(x, dtype=np.float64), requires_grad=True, **f64)
            loss = _heston_calibration_objective(pars, grid, market_vols, weights, vol_scaler,
                                                 ttms_static)
            (grad,) = torch.autograd.grad(loss, pars)
            return float(loss.detach()), grad.cpu().numpy().astype(np.float64)

        def feller(pars: np.ndarray) -> float:
            return 2.0 * pars[2] * pars[1] - pars[4] * pars[4]

        def feller_jac(p: np.ndarray) -> np.ndarray:
            return np.array([0.0, 2.0 * p[2], 2.0 * p[1], 0.0, -2.0 * p[4]])

        return objective, feller, feller_jac


# ----------------------------------------------------------------------------
# calibration
# ----------------------------------------------------------------------------

# start point and bounds of (v0, theta, kappa, rho, volvol), the JAX package's
HESTON_P0 = np.array([0.1, 0.1, 2.0, -0.2, 1.0])
HESTON_BOUNDS = ((0.01, 2.0), (0.01, 2.0), (0.1, 30.0), (-0.99, 0.99), (0.1, 5.0))


def _calibration_targets(option_chain: OptionChain, p0: np.ndarray, is_vega_weighted: bool,
                         is_unit_ttm_vega: bool, device
                         ) -> Tuple[ChainGrid, torch.Tensor, torch.Tensor, float]:
    """(grid, market vol panel, weight panel, frozen vol scaler): the panels
    are float64 tensors on ``device``, 0 on padded slots; the weights are the
    slice-normalised BSM vegas at the mid vols, or ones; the transform grid
    is frozen at min(0.3, sqrt(p0[0] ttm0))."""
    grid = option_chain.to_grid(device=device)
    mask = to_host(grid.mask)
    market_vols = _pad_panel(option_chain.get_mid_vols(), grid)
    if is_vega_weighted:
        vegas_ttms = option_chain.get_chain_vegas(is_unit_ttm_vega=is_unit_ttm_vega)
        weights = _pad_panel([v / np.sum(v) for v in vegas_ttms], grid)
    else:
        weights = np.ones_like(market_vols)
    vol_scaler = float(np.minimum(0.3, np.sqrt(p0[0] * option_chain.ttms[0])))
    return (grid, to_device(np.where(mask, market_vols, 0.0), torch.float64, device),
            to_device(np.where(mask, weights, 0.0), torch.float64, device), vol_scaler)


def _heston_calibration_objective(pars: torch.Tensor, grid: ChainGrid,
                                  market_vols: torch.Tensor, weights: torch.Tensor,
                                  vol_scaler, ttms_static: Tuple[float, ...]) -> torch.Tensor:
    """vega-weighted sum of squared implied-vol residuals of the 200-step
    bisection; NaN vols are masked before squaring (``where(isnan(r), 0, r)``
    alone would leave a 0 * NaN = NaN in the backward pass)."""
    v0, theta, kappa, rho, volvol = pars.unbind()
    prices = heston_chain_price_grid(grid, v0=v0, theta=theta, kappa=kappa, volvol=volvol,
                                     rho=rho, vol_scaler=vol_scaler, ttms_static=ttms_static)
    model_vols = bsm.infer_bsm_ivols_from_model_chain_prices(
        ttms=grid.ttms, forwards=grid.forwards, discfactors=grid.discfactors,
        strikes_ttms=grid.strikes, optiontypes_ttms=grid.optioncodes, model_prices_ttms=prices)
    nan_mask = torch.isnan(model_vols)
    clean = torch.where(nan_mask, market_vols, model_vols)
    resid = weights * torch.square(clean - market_vols)
    return torch.sum(torch.where(nan_mask, 0.0, resid))


def _heston_residuals(ttms, forwards, discfactors, strikes, optioncodes, mask, market, sqrtw,
                      vol_scaler, *, ttms_static):
    """the LM residual function of (v0, theta, kappa, rho, volvol): sqrt-
    weighted fast-IV errors (0 where the model vol is NaN) and sqrt(10) x
    the Feller gap max(volvol^2 - 2 kappa theta, 0)."""
    grid = ChainGrid(ttms=ttms, forwards=forwards, discfactors=discfactors, strikes=strikes,
                     optioncodes=optioncodes, mask=mask)
    sqrt10 = math.sqrt(10.0)

    def residuals(pars):
        v0, theta, kappa, rho, volvol = pars.unbind()
        prices = heston_chain_price_grid(grid, v0=v0, theta=theta, kappa=kappa, volvol=volvol,
                                         rho=rho, vol_scaler=vol_scaler, ttms_static=ttms_static)
        vols = bsm.infer_bsm_implied_vol_fast(
            forward=grid.forwards[:, None], ttm=grid.ttms[:, None], strike=grid.strikes,
            given_price=prices, discfactor=grid.discfactors[:, None],
            optiontype=grid.optioncodes)
        nan_mask = torch.isnan(vols)
        clean = torch.where(nan_mask, market, vols)
        r = (sqrtw * (clean - market)).reshape(-1)
        feller = torch.clamp(volvol * volvol - 2.0 * kappa * theta, min=0.0)
        return torch.cat([r, (sqrt10 * feller)[None]])

    return residuals


def _heston_lm_run(p0, ttms, forwards, discfactors, strikes, optioncodes, mask, market, sqrtw,
                   lower, upper, vol_scaler, *, ttms_static, nb_iters):
    """the whole LM fit on tensors only (so that it can be captured):
    returns (best parameters, best cost)."""
    residuals = _heston_residuals(ttms, forwards, discfactors, strikes, optioncodes, mask,
                                  market, sqrtw, vol_scaler, ttms_static=ttms_static)
    return lm_minimize(residuals, p0, lower, upper, nb_iters=nb_iters)


def calibrate_heston_lm(option_chain: OptionChain,
                        params0: HestonParams,
                        nb_iters: int = 16,
                        is_vega_weighted: bool = True,
                        is_unit_ttm_vega: bool = False,
                        device="cuda") -> Tuple[HestonParams, float]:
    """(v0, theta, kappa, rho, volvol) by Levenberg-Marquardt from
    ``params0``; returns (params, best cost).  The residuals are the
    sqrt-weighted fast-IV errors and the Feller penalty, the box the SLSQP
    fit's bounds, the transform grid frozen at min(0.3, sqrt(v0 ttm0)).  On
    a CUDA device the whole fit is one CUDA graph per (panel shape,
    ``nb_iters``, maturities), captured at its first call; inside
    ``graphs.eager()`` it runs eagerly, with the same bits.  Spans: the fit
    is one ``LM_FIT_SPAN``, its inputs one ``LM_PREPARE_SPAN``."""
    with annotate(LM_FIT_SPAN):
        with annotate(LM_PREPARE_SPAN):
            p0 = params0.to_array()
            grid, market, weights, vol_scaler = _calibration_targets(
                option_chain, p0, is_vega_weighted, is_unit_ttm_vega, device)
            up = lambda a: to_device(a, torch.float64, device)
            inputs = (up(p0), grid.ttms, grid.forwards, grid.discfactors,
                      grid.strikes, grid.optioncodes, grid.mask, market, torch.sqrt(weights),
                      up(np.array([b[0] for b in HESTON_BOUNDS])),
                      up(np.array([b[1] for b in HESTON_BOUNDS])), up(vol_scaler))
        static = dict(ttms_static=tuple(float(t) for t in option_chain.ttms),
                      nb_iters=int(nb_iters))
        run = lambda *a: _heston_lm_run(*a, **static)
        if graphs.use_graph(inputs[0]):
            key = (tuple(grid.strikes.shape), static["nb_iters"], static["ttms_static"],
                   str(inputs[0].device))
            best, cost = graphs.run_captured("heston_lm", key, run, inputs)
        else:
            best, cost = run(*inputs)
        v0, theta, kappa, rho, volvol = to_host(best).astype(np.float64)
        return (HestonParams(v0=v0, theta=theta, kappa=kappa, rho=rho, volvol=volvol),
                float(to_host(cost)))


def v0_implied(v0: float, volvol: float, ttm: float) -> float:
    """short-maturity v0 adjustment, v0 - volvol^2 ttm / 8."""
    return v0 - volvol * volvol * ttm / 8.0
