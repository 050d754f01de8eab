"""
Pricer for the log-normal beta SV model with quadratic drift — the flagship
model (Sepp & Rakhmonov, IJTAF 2024).

PyTorch counterpart of ``stochvolmodels_tpu/models/logsv/pricer.py`` for the
serving path.  Vanillas are valued by Fourier inversion of the affine
expansion (a float64 RK4 over the whole transform grid, with the ODE state
chained across maturities); Monte Carlo runs the Eq. (3.59) Euler scheme,
either eagerly in float64 (``engine='scan'``) or through the hand-written
CUDA kernel and its plain version (``engine='cuda'``), with antithetic draws
(``'scan'``), by randomized QMC (``engine='qmc'``, ``ops/qmc.py``) or over
fixed pre-drawn normal blocks; the rough lift (``use_rough_mc=True``) runs
through ``models/rough/simulation.py``.  Options on quadratic variance are
priced on the 40,000-point Psi grid (one CUDA graph a reprice on the card),
and the densities of the log-return, the quadratic variance and the vol
come from the same engine.  Calibration fits the chain's mid vols: SLSQP
through scipy with the objective's gradient from one ``torch.autograd``
backward (through the RK4 or the Monte Carlo and the implied-vol
inversion), with the vol backbone fitted to the varswap strikes
(``PARAMS_WITH_VARSWAP_FIT``), or Levenberg-Marquardt on the device
(``method='lm'``, ``fast_calibration.py``).
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
from stochvolmodels_torch.models.logsv.vol_moments import (
    backbone_etas_torch,
    fit_model_vol_backbone_to_varswaps,
)
from stochvolmodels_torch.models.rough.simulation import log_spot_full_combined_fixed
from stochvolmodels_torch.ops import bsm, graphs, mgf, qmc
from stochvolmodels_torch.ops.cuda_mc import engine_setup, simulate_logsv_terminal_kernel
from stochvolmodels_torch.ops.payoffs import compute_mc_vars_payoff, mc_vars_payoff
from stochvolmodels_torch.ops.random import (
    DEFAULT_SEED,
    antithetic_step_normals,
    generator_from_seed,
    step_normals,
)
from stochvolmodels_torch.utils.funcs import set_time_grid
from stochvolmodels_torch.utils.profiling import MC_CHAIN_SPAN, annotate

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
# the least steps per year of the Q_VAR chain's RK4: at 240 (the JAX
# package's default) the 1m and 3m slices of the QV chain diverge to 1e248
# at the README parameters; at 720 every slice is finite and stable
_QVAR_YEAR_STEPS = 720


def set_vol_scaler(sigma0: float, ttm: float) -> float:
    """transform-grid scaler; lower bound two weeks."""
    return sigma0 * np.sqrt(np.minimum(np.min(ttm), 0.5 / 12.0))


def v0_implied(atm: float, beta: float, volvol: float, theta: float,
               kappa1: float, ttm: float) -> float:
    """sigma0 from a short-maturity ATM vol (the reference's inversion)."""
    beta2 = beta * beta
    vartheta2 = beta2 + volvol * volvol
    if np.abs(beta) > 1.0:
        return atm - vartheta2 * ttm / 4.0
    numer = (-24.0 - beta2 * ttm - 2.0 * vartheta2 * ttm + 12.0 * kappa1 * ttm
             + np.sqrt(np.square(24.0 + beta2 * ttm + 2.0 * vartheta2 * ttm - 12.0 * kappa1 * ttm)
                       - 288.0 * beta * ttm * (-2.0 * atm + theta * kappa1 * ttm)))
    denumer = 12.0 * beta * ttm
    if np.abs(denumer) > 1e-10:
        return numer / denumer
    return atm - vartheta2 * ttm / 4.0


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
    So may ``vol_backbone_etas`` be a (T,) tensor (the varswap-fit
    calibration's).  The maturities (``ttms_static``) fix the step counts on
    the host.  ``variable_type=Q_VAR`` prices calls on the annualised
    quadratic variance on the Psi grid (40,000 points), from the same uniform
    RK4 at ``year_steps``.
    """
    if variable_type not in (VariableType.LOG_RETURN, VariableType.Q_VAR):
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
    ttm0 = 0.0
    prices = []
    for i, ttm in enumerate(ttms_static):
        eta = vol_backbone_etas[i]
        a_t = afe.solve_a_ode_grid(
            ttm=ttm - ttm0, theta=theta, kappa1=kappa1, kappa2=kappa2, beta=beta,
            volvol=volvol, phi_grid=phi_grid, psi_grid=psi_grid, a_t0=a_t,
            is_spot_measure=is_spot_measure, expansion_order=expansion_order,
            vol_backbone_eta=eta if isinstance(eta, torch.Tensor) else float(eta),
            year_steps=year_steps)
        log_mgf = afe.contract_log_mgf(a_t, sigma0 - theta, expansion_order)
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


def _param_vector(params: LogSvParams, device, *extra: float) -> torch.Tensor:
    """(sigma0, theta, kappa1, kappa2, beta, volvol, *extra) as a float64
    tensor on ``device``: a captured call's parameter input."""
    values = [params.sigma0, params.theta, params.kappa1, params.kappa2, params.beta,
              params.volvol, *extra]
    return torch.tensor([float(v) for v in values], dtype=torch.float64, device=device)


def _qvar_panel_from_vector(pvec, ttms, forwards, discfactors, strikes, optioncodes, mask, *,
                            etas, ttms_static, year_steps, is_spot_measure, expansion_order):
    grid = ChainGrid(ttms=ttms, forwards=forwards, discfactors=discfactors, strikes=strikes,
                     optioncodes=optioncodes, mask=mask)
    sigma0, theta, kappa1, kappa2, beta, volvol = pvec.unbind()
    return (logsv_chain_price_grid(grid, sigma0=sigma0, theta=theta, kappa1=kappa1,
                                   kappa2=kappa2, beta=beta, volvol=volvol,
                                   vol_backbone_etas=np.asarray(etas), ttms_static=ttms_static,
                                   variable_type=VariableType.Q_VAR,
                                   expansion_order=expansion_order,
                                   is_spot_measure=is_spot_measure, year_steps=year_steps),)


def qvar_price_panel(grid: ChainGrid, params: LogSvParams, ttms_static: Tuple[float, ...],
                     etas: np.ndarray, year_steps: int, is_spot_measure: bool = True,
                     expansion_order: ExpansionOrder = ExpansionOrder.SECOND) -> torch.Tensor:
    """the Q_VAR chain reprice on the grid's device: on the card one CUDA graph
    per (chain shape, maturities, etas, steps, measure, order), keyed so, its
    parameters one float64 input vector; eagerly with ``graphs.eager()`` and
    on the CPU, with the same tensor parameters (so the same bits)."""
    static = dict(etas=tuple(float(e) for e in etas), ttms_static=tuple(ttms_static),
                  year_steps=int(year_steps), is_spot_measure=bool(is_spot_measure),
                  expansion_order=expansion_order)
    inputs = (_param_vector(params, grid.device), grid.ttms, grid.forwards, grid.discfactors,
              grid.strikes, grid.optioncodes, grid.mask)
    fn = lambda *a: _qvar_panel_from_vector(*a, **static)
    if graphs.use_graph(inputs[0]):
        key = (tuple(grid.strikes.shape),) + tuple(static.values()) + (str(grid.device),)
        return graphs.run_captured("logsv_qvar_price", key, fn, inputs)[0]
    return fn(*inputs)[0]


# ----------------------------------------------------------------------------
# densities
# ----------------------------------------------------------------------------

def _pdf_from_vector(pvec: torch.Tensor, space_grid: torch.Tensor, *, ttm: float,
                     vol_scaler: float, variable_type: VariableType,
                     expansion_order: ExpansionOrder, is_spot_measure: bool):
    sigma0, theta, kappa1, kappa2, beta, volvol = pvec.unbind()
    phi_grid, psi_grid, theta_grid = mgf.get_transform_var_grid(
        variable_type=variable_type, is_spot_measure=is_spot_measure, vol_scaler=vol_scaler,
        device=pvec.device)
    _, log_mgf = afe.compute_logsv_a_mgf_grid(
        ttm=ttm, phi_grid=phi_grid, psi_grid=psi_grid, theta_grid=theta_grid, sigma0=sigma0,
        theta=theta, kappa1=kappa1, kappa2=kappa2, beta=beta, volvol=volvol,
        variable_type=variable_type, expansion_order=expansion_order,
        is_spot_measure=is_spot_measure)
    if variable_type == VariableType.LOG_RETURN:
        transform_var_grid, shift, scale = phi_grid, 0.0, 1.0
    elif variable_type == VariableType.Q_VAR:
        transform_var_grid, shift, scale = psi_grid, 0.0, 1.0 / ttm
    else:
        transform_var_grid, shift, scale = theta_grid, theta, 1.0
    pdf = mgf.pdf_with_mgf_grid(log_mgf_grid=log_mgf, transform_var_grid=transform_var_grid,
                                space_grid=space_grid, shift=shift, scale=scale)
    return (pdf / scale,)


def logsv_pdfs(params: LogSvParams,
               ttm: float,
               space_grid: np.ndarray,
               is_spot_measure: bool = True,
               expansion_order: ExpansionOrder = ExpansionOrder.SECOND,
               variable_type: VariableType = VariableType.LOG_RETURN,
               vol_scaler: Optional[float] = None,
               engine: str = "auto",
               device="cuda",
               **kwargs) -> np.ndarray:
    """the model density of the log-return, the annualised quadratic
    variance or the vol on ``space_grid`` (mass per grid cell), by transform
    inversion of :func:`afe.compute_logsv_a_mgf_grid`.

    The parameters enter as tensors, so the SIGMA and Q_VAR warmup takes the
    JAX package's bound for traced parameters (rate 40), as its jitted
    density does; on the card the whole density is one CUDA graph per
    (ttm, variable, grid size, scaler, order, measure).  ``engine`` 'auto',
    'f64' and 'df32' all run the float64 RK4.
    """
    if engine not in ("auto", "f64", "df32"):
        raise NotImplementedError(f"engine={engine}")
    if variable_type not in (VariableType.LOG_RETURN, VariableType.Q_VAR, VariableType.SIGMA):
        raise NotImplementedError(f"variable_type={variable_type}")
    if vol_scaler is None:
        vol_scaler = set_vol_scaler(sigma0=params.sigma0, ttm=ttm)
    device = torch.device(device)
    static = dict(ttm=float(ttm), vol_scaler=float(vol_scaler), variable_type=variable_type,
                  expansion_order=expansion_order, is_spot_measure=bool(is_spot_measure))
    inputs = (_param_vector(params, device),
              torch.as_tensor(np.asarray(space_grid, dtype=np.float64), device=device))
    fn = lambda *a: _pdf_from_vector(*a, **static)
    if graphs.use_graph(inputs[0]):
        key = tuple(static.values()) + (tuple(inputs[1].shape), str(device))
        pdf = graphs.run_captured("logsv_pdf", key, fn, inputs)[0]
    else:
        pdf = fn(*inputs)[0]
    return pdf.cpu().numpy()


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
                            nb_steps_per_year: int = 360,
                            antithetic: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """explicit Euler on (X, ln sigma, I) to horizon ttm, one eager step at a
    time in the dtype of ``x0``, with normals drawn from ``gen``
    (``antithetic``: path i + P/2 takes the negated draws of path i).

    The reference discretization: X uses the pre-update sigma, the
    ln-sigma drift is (kappa1 theta/sigma - kappa1) + kappa2(theta - sigma)
    + adj sigma - 0.5 vartheta^2 with adj = beta*eta under the inverse
    measure, and the quadratic variance accumulates trapezoidally.
    """
    nb_steps, dt, _ = set_time_grid(ttm=ttm, nb_steps_per_year=nb_steps_per_year)
    sdt = float(np.sqrt(dt))
    nb_path = x0.shape[0]
    draw = antithetic_step_normals if antithetic else step_normals
    x, log_sigma, sigma, qvar = x0, torch.log(sigma0), sigma0, qvar0
    for _ in range(nb_steps):
        w = draw(gen, (2, nb_path), dtype=x0.dtype) * sdt
        x, log_sigma, sigma, qvar = _euler_step(x, log_sigma, sigma, qvar, w[0], w[1], dt, theta,
                                                kappa1, kappa2, beta, volvol, vol_backbone_eta,
                                                is_spot_measure)
    return x, sigma, qvar


def _euler_step(x, log_sigma, sigma, qvar, w0, w1, dt: float, theta, kappa1, kappa2, beta,
                volvol, eta, is_spot_measure: bool):
    """one step of the Eq. (3.59) scheme on scaled increments (w0, w1)."""
    if is_spot_measure:
        alpha, adj = -1.0, 0.0
    else:
        alpha, adj = 1.0, beta * eta
    vartheta2 = beta * beta + volvol * volvol
    eta2 = eta * eta
    sigma_2dt = eta2 * sigma * sigma * dt
    x = x + alpha * 0.5 * sigma_2dt + eta * sigma * w0
    log_sigma = log_sigma + ((kappa1 * theta / sigma - kappa1) + kappa2 * (theta - sigma)
                             + adj * sigma - 0.5 * vartheta2) * dt + beta * w0 + volvol * w1
    sigma_new = torch.exp(log_sigma)
    qvar = qvar + 0.5 * (sigma_2dt + eta2 * sigma_new * sigma_new * dt)
    return x, log_sigma, sigma_new, qvar


def _qmc_core_impl(v_tot, shift_tot, v_steps, shifts, bits, x0, sigma0, qvar0, pvec, *,
                   dt: float, is_spot_measure: bool, dtype, nb_replicates: int):
    """the two passes of the QMC Euler: the raw step columns summed, then the
    steps on the increments conditioned on the stratified totals."""
    nb_steps, nb_path = v_steps.shape[0], x0.shape[0]
    sdt = float(np.sqrt(dt))
    theta, kappa1, kappa2, beta, volvol, eta = pvec.unbind()
    expand = lambda shift: qmc.expand_replicate_shifts(shift, nb_path, nb_replicates)
    s0 = s1 = torch.zeros(x0.shape, dtype=dtype, device=x0.device)
    for t in range(nb_steps):
        z0, z1 = qmc.qmc_step_normals(bits, v_steps[t], expand(shifts[t]), dtype)
        s0, s1 = s0 + z0, s1 + z1
    t0, t1 = qmc.qmc_step_normals(bits, v_tot, expand(shift_tot), dtype)
    c0 = qmc.stratified_increment_shift(t0, s0, nb_steps)
    c1 = qmc.stratified_increment_shift(t1, s1, nb_steps)
    carry = x0.dtype
    x, log_sigma, sigma, qvar = x0, torch.log(sigma0), sigma0, qvar0
    for t in range(nb_steps):
        z0, z1 = qmc.qmc_step_normals(bits, v_steps[t], expand(shifts[t]), dtype)
        x, log_sigma, sigma, qvar = (a.to(carry) for a in _euler_step(
            x, log_sigma, sigma, qvar, (z0 + c0) * sdt, (z1 + c1) * sdt, dt, theta, kappa1,
            kappa2, beta, volvol, eta, is_spot_measure))
    return x, sigma, qvar


def _simulate_logsv_terminal_qmc_core(v_tot: torch.Tensor,
                                      shift_tot: torch.Tensor,
                                      v_steps: torch.Tensor,
                                      shifts: torch.Tensor,
                                      x0: torch.Tensor,
                                      sigma0: torch.Tensor,
                                      qvar0: torch.Tensor,
                                      dt: float,
                                      theta,
                                      kappa1,
                                      kappa2,
                                      beta,
                                      volvol,
                                      vol_backbone_eta,
                                      is_spot_measure: bool = True,
                                      dtype: torch.dtype = torch.float64,
                                      nb_replicates: int = 0
                                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """the Euler scheme of :func:`simulate_logsv_terminal` on randomized
    Sobol normals: path i is Sobol point i, each step takes two columns, and
    each Brownian stream's slice total is stratified onto the slice's two
    leading dimensions.  The panels (int64 words: ``v_tot`` (2, 32),
    ``shift_tot`` (2,) or (2, R), ``v_steps`` (steps, 2, 32), ``shifts``
    (steps, 2) or (steps, 2, R)) are those of :func:`qmc.qmc_scan_panels`.
    With ``nb_replicates`` R the paths are R contiguous groups, each the same
    point set under its own shifts.  On the card the slice runs as one CUDA
    graph per (paths, steps, dt, R, measure, dtype)."""
    nb_path = x0.shape[0]
    bits = qmc.gray_bits(qmc.gray_codes(nb_path, nb_replicates, device=x0.device))
    pvec = torch.stack(afe.f64_scalars(x0.device, theta, kappa1, kappa2, beta, volvol,
                                       vol_backbone_eta))
    static = dict(dt=float(dt), is_spot_measure=bool(is_spot_measure), dtype=dtype,
                  nb_replicates=int(nb_replicates))
    inputs = tuple(a.to(x0.device) for a in (v_tot, shift_tot, v_steps, shifts)) + (
        bits, x0, sigma0, qvar0, pvec)
    fn = lambda *a: _qmc_core_impl(*a, **static)
    if graphs.use_graph(x0):
        key = (nb_path, v_steps.shape[0]) + tuple(static.values()) + (str(x0.device),)
        return graphs.run_captured("logsv_qmc", key, fn, inputs)
    return fn(*inputs)


def simulate_logsv_terminal_qmc(seed: Optional[int],
                                x0: torch.Tensor,
                                sigma0: torch.Tensor,
                                qvar0: torch.Tensor,
                                ttm: float,
                                theta,
                                kappa1,
                                kappa2,
                                beta,
                                volvol,
                                vol_backbone_eta=1.0,
                                is_spot_measure: bool = True,
                                nb_steps_per_year: int = 360,
                                dtype: torch.dtype = torch.float64,
                                dim_offset: int = 0,
                                nb_replicates: int = 0
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """terminal (x, sigma, qvar) by randomized QMC; ``dim_offset`` counts the
    Sobol dimensions of earlier slices of a chain (``qmc.qmc_dims_per_slice``
    each), so a chain continues one sequence.  The digital shifts come from a
    generator seeded with ``seed`` (None -> 24)."""
    seed = DEFAULT_SEED if seed is None else int(seed)
    nb_steps, dt, _ = set_time_grid(ttm=ttm, nb_steps_per_year=nb_steps_per_year)
    panels = qmc.qmc_scan_panels(seed, nb_steps, per_step=2, dim_offset=dim_offset,
                                 nb_replicates=nb_replicates, device=x0.device)
    return _simulate_logsv_terminal_qmc_core(
        *panels, x0, sigma0, qvar0, dt=dt, theta=theta, kappa1=kappa1, kappa2=kappa2,
        beta=beta, volvol=volvol, vol_backbone_eta=vol_backbone_eta,
        is_spot_measure=is_spot_measure, dtype=dtype, nb_replicates=nb_replicates)


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
                          device="cuda",
                          antithetic: bool = False,
                          qmc_replicates: int = 8
                          ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """chain MC with the terminal state carried across maturities.

    ``engine='cuda'`` (alias ``'pallas'``) runs each slice's path loop in
    float32 through the hand-written CUDA kernel when ``device`` is a CUDA
    device, and through its plain version on the CPU; slice ``i`` takes the
    seed ``base + 7919*i``.  ``engine='scan'`` (default) runs the eager
    Euler loop in ``dtype`` with normals from a generator seeded by ``seed``;
    ``antithetic=True`` (scan only) mirrors path i + P/2 on path i and takes
    the stderr over the pair averages.  ``engine='qmc'`` draws randomized
    Sobol normals (one sequence across the chain) in ``qmc_replicates``
    independently shifted copies, with the stderr over the replicate means
    (``qmc_replicates`` 0 or 1: one unreplicated set).  Antithetic and
    replicated runs pad ``nb_path`` up to a multiple of 2 or R.
    """
    if vol_backbone_etas is None:
        vol_backbone_etas = np.ones_like(np.asarray(ttms))
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
        x = torch.zeros(nb_pad, dtype=torch.float32, device=device)
        sigma = torch.full((nb_pad,), v0, dtype=torch.float32, device=device)
        qvar = torch.zeros(nb_pad, dtype=torch.float32, device=device)
    else:
        gen = generator_from_seed(seed, device=device)
        x = torch.zeros(nb_path, dtype=dtype, device=device)
        sigma = torch.full((nb_path,), v0, dtype=dtype, device=device)
        qvar = torch.zeros(nb_path, dtype=dtype, device=device)
    ttm0 = 0.0
    dim_offset = 0
    option_prices_ttm, option_std_ttm = [], []
    for i, ttm in enumerate(ttms):
        kw = dict(ttm=float(ttm - ttm0), theta=theta, kappa1=kappa1, kappa2=kappa2,
                  beta=beta, volvol=volvol, vol_backbone_eta=float(vol_backbone_etas[i]),
                  is_spot_measure=is_spot_measure, nb_steps_per_year=nb_steps_per_year)
        if engine == "cuda":
            x, sigma, qvar = simulate_logsv_terminal_kernel(
                seed=base_seed + 7919 * i, x0=x, sigma0=sigma, qvar0=qvar, **kw)
        elif engine == "qmc":
            x, sigma, qvar = simulate_logsv_terminal_qmc(
                seed, x, sigma, qvar, dtype=dtype, dim_offset=dim_offset,
                nb_replicates=qmc_replicates, **kw)
            dim_offset += qmc.qmc_dims_per_slice(
                set_time_grid(ttm=kw["ttm"], nb_steps_per_year=nb_steps_per_year)[0])
        else:
            x, sigma, qvar = simulate_logsv_terminal(gen=gen, x0=x, sigma0=sigma,
                                                     qvar0=qvar, antithetic=antithetic, **kw)
        ttm0 = float(ttm)
        prices, stds = compute_mc_vars_payoff(
            x0=x[:nb_path], sigma0=sigma[:nb_path], qvar0=qvar[:nb_path], ttm=ttm,
            forward=forwards[i], strikes_ttm=strikes_ttms[i],
            optiontypes_ttm=optiontypes_ttms[i], discfactor=discfactors[i],
            variable_type=variable_type, antithetic=antithetic, nb_replicates=qmc_replicates)
        option_prices_ttm.append(prices)
        option_std_ttm.append(stds)
    return option_prices_ttm, option_std_ttm


# ----------------------------------------------------------------------------
# Monte Carlo on fixed randoms (the reference's frozen-draws contract)
# ----------------------------------------------------------------------------

def simulate_logsv_terminal_fixed(W0,
                                  W1,
                                  dt: float,
                                  x0: torch.Tensor,
                                  sigma0: torch.Tensor,
                                  qvar0: torch.Tensor,
                                  theta,
                                  kappa1,
                                  kappa2,
                                  beta,
                                  volvol,
                                  vol_backbone_eta=1.0,
                                  is_spot_measure: bool = True
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """the Euler scheme over pre-drawn unscaled normal blocks ``W0``, ``W1``
    (steps, paths), numpy arrays or tensors, on the device of ``x0``.  The
    parameters are floats or 0-dim float64 tensors (they enter as tensors,
    so the MC calibration differentiates through the steps)."""
    device = x0.device
    w0s = torch.as_tensor(W0, dtype=x0.dtype, device=device)
    w1s = torch.as_tensor(W1, dtype=x0.dtype, device=device)
    theta, kappa1, kappa2, beta, volvol, eta = afe.f64_scalars(
        device, theta, kappa1, kappa2, beta, volvol, vol_backbone_eta)
    sdt = float(np.sqrt(dt))
    x, log_sigma, sigma, qvar = x0, torch.log(sigma0), sigma0, qvar0
    for w0, w1 in zip(w0s, w1s):
        x, log_sigma, sigma, qvar = _euler_step(x, log_sigma, sigma, qvar, w0 * sdt, w1 * sdt,
                                                dt, theta, kappa1, kappa2, beta, volvol, eta,
                                                is_spot_measure)
    return x, sigma, qvar


def get_randoms_for_chain_valuation(ttms: np.ndarray,
                                    nb_path: int = 100000,
                                    nb_steps_per_year: int = 360,
                                    seed: int = 10):
    """per-slice normal blocks (steps, paths) frozen across calibration
    iterations, from numpy's global RNG seeded with ``seed``, as the
    reference and the JAX package draw them: (W0s, W1s, dts)."""
    np.random.seed(seed)
    W0s, W1s, dts = [], [], []
    ttm0 = 0.0
    for ttm in ttms:
        nb_steps_, dt, _ = set_time_grid(ttm=ttm - ttm0, nb_steps_per_year=nb_steps_per_year)
        W0s.append(np.random.normal(0, 1, size=(nb_steps_, nb_path)))
        W1s.append(np.random.normal(0, 1, size=(nb_steps_, nb_path)))
        dts.append(dt)
        ttm0 = ttm
    return W0s, W1s, dts


def get_qmc_randoms_for_chain_valuation(ttms: np.ndarray,
                                        nb_path: int = 100000,
                                        nb_steps_per_year: int = 360,
                                        seed: int = 10,
                                        device="cuda"):
    """the randomized-Sobol counterpart of
    :func:`get_randoms_for_chain_valuation`: (W0s, W1s, dts) with each block
    a stratified-totals QMC panel (float64 tensors on ``device``), frozen
    given ``seed``."""
    nb_steps_list, dts = [], []
    ttm0 = 0.0
    for ttm in ttms:
        nb_steps_, dt, _ = set_time_grid(ttm=ttm - ttm0, nb_steps_per_year=nb_steps_per_year)
        nb_steps_list.append(nb_steps_)
        dts.append(dt)
        ttm0 = ttm
    blocks = qmc.qmc_normal_blocks(seed, nb_path, nb_steps_list, device=device)
    return [b[0] for b in blocks], [b[1] for b in blocks], dts


def logsv_mc_chain_pricer_fixed_randoms(ttms: np.ndarray,
                                        forwards: np.ndarray,
                                        discfactors: np.ndarray,
                                        strikes_ttms,
                                        optiontypes_ttms,
                                        W0s,
                                        W1s,
                                        dts,
                                        v0: float,
                                        theta: float,
                                        kappa1: float,
                                        kappa2: float,
                                        beta: float,
                                        volvol: float,
                                        vol_backbone_etas: Optional[np.ndarray] = None,
                                        is_spot_measure: bool = True,
                                        variable_type: VariableType = VariableType.LOG_RETURN,
                                        device="cuda"
                                        ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """chain valuation in float64 on ``device`` over fixed normal blocks
    (numpy arrays, moved to the device once a call, or tensors there)."""
    if vol_backbone_etas is None:
        vol_backbone_etas = np.ones_like(np.asarray(ttms))
    device = torch.device(device)
    W0s = [torch.as_tensor(w, dtype=torch.float64, device=device) for w in W0s]
    W1s = [torch.as_tensor(w, dtype=torch.float64, device=device) for w in W1s]
    nb_path = W0s[0].shape[1]
    x = torch.zeros(nb_path, dtype=torch.float64, device=device)
    sigma = torch.full((nb_path,), float(v0), dtype=torch.float64, device=device)
    qvar = torch.zeros(nb_path, dtype=torch.float64, device=device)
    option_prices_ttm, option_std_ttm = [], []
    for i, ttm in enumerate(ttms):
        x, sigma, qvar = simulate_logsv_terminal_fixed(
            W0=W0s[i], W1=W1s[i], dt=float(dts[i]), x0=x, sigma0=sigma, qvar0=qvar,
            theta=theta, kappa1=kappa1, kappa2=kappa2, beta=beta, volvol=volvol,
            vol_backbone_eta=float(vol_backbone_etas[i]), is_spot_measure=is_spot_measure)
        prices, stds = compute_mc_vars_payoff(
            x0=x, sigma0=sigma, qvar0=qvar, ttm=ttm, forward=forwards[i],
            strikes_ttm=strikes_ttms[i], optiontypes_ttm=optiontypes_ttms[i],
            discfactor=discfactors[i], variable_type=variable_type)
        option_prices_ttm.append(prices)
        option_std_ttm.append(stds)
    return option_prices_ttm, option_std_ttm


def get_randoms_for_rough_vol_chain_valuation(ttms: np.ndarray,
                                              nb_path: int = 100000,
                                              nb_steps_per_year: int = 360,
                                              seed: int = 10):
    """one normal block pair (steps of the longest slice, paths) shared by
    every slice of the rough chain, from numpy's global RNG, and each
    slice's time grid: (Z0, Z1, grid_ttms)."""
    np.random.seed(seed)
    grid_ttms = []
    nb_steps_ttms = np.zeros(len(ttms), dtype=int)
    for i, ttm in enumerate(ttms):
        nb_steps, _, grid_t = set_time_grid(ttm, nb_steps_per_year or 360)
        nb_steps_ttms[i] = nb_steps
        grid_ttms.append(grid_t)
    Z0 = np.random.normal(0, 1, size=(nb_steps_ttms[-1], nb_path))
    Z1 = np.random.normal(0, 1, size=(nb_steps_ttms[-1], nb_path))
    return Z0, Z1, grid_ttms


def rough_logsv_mc_chain_pricer_fixed_randoms(ttms: np.ndarray,
                                              forwards: np.ndarray,
                                              discfactors: np.ndarray,
                                              strikes_ttms,
                                              optiontypes_ttms,
                                              Z0,
                                              Z1,
                                              sigma0: float,
                                              theta: float,
                                              kappa1: float,
                                              kappa2: float,
                                              beta: float,
                                              orthog_vol: float,
                                              weights: np.ndarray,
                                              nodes: np.ndarray,
                                              timegrids,
                                              variable_type: VariableType = VariableType.LOG_RETURN,
                                              debug: bool = False,
                                              device="cuda"
                                              ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """rough chain valuation on one shared fixed block: each slice restarts
    from t = 0 on the block's first steps (as many as its time grid has)."""
    device = torch.device(device)
    z0 = torch.as_tensor(Z0, dtype=torch.float64, device=device)
    z1 = torch.as_tensor(Z1, dtype=torch.float64, device=device)
    vartheta = float(np.sqrt(beta ** 2 + orthog_vol ** 2))
    rho = float(beta / vartheta)
    weights_t = torch.as_tensor(np.asarray(weights, dtype=np.float64), device=device)[:, None]
    option_prices_ttm, option_std_ttm = [], []
    for ttm, forward, discfactor, strikes, types, timegrid in zip(
            ttms, forwards, discfactors, strikes_ttms, optiontypes_ttms, timegrids):
        nb_steps = np.asarray(timegrid).size - 1
        log_s, v, y = log_spot_full_combined_fixed(
            nodes=nodes, weights=weights, sigma0=sigma0, theta=theta, kappa1=kappa1,
            kappa2=kappa2, rho=rho, volvol=vartheta, timegrid=np.asarray(timegrid),
            Z0=z0[:nb_steps], Z1=z1[:nb_steps], device=device)
        prices, stds = compute_mc_vars_payoff(
            x0=log_s, sigma0=torch.sum(weights_t * v, dim=0), qvar0=y, ttm=ttm,
            forward=forward, strikes_ttm=strikes, optiontypes_ttm=types,
            discfactor=discfactor, variable_type=variable_type)
        option_prices_ttm.append(prices)
        option_std_ttm.append(stds)
    return option_prices_ttm, option_std_ttm


def simulate_vol_paths(ttm: float,
                       v0: float,
                       theta: float,
                       kappa1: float,
                       kappa2: float,
                       beta: float,
                       volvol: float,
                       is_spot_measure: bool = True,
                       nb_path: int = 100000,
                       nb_steps_per_year: int = 360,
                       seed: Optional[int] = None,
                       device="cuda",
                       **kwargs
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(steps + 1, paths) vol paths of the log-vol Euler scheme driven by one
    normal per step (vol of vol vartheta; the drift adds beta sigma under
    the inverse measure), and the time grid; normals from a generator seeded
    by ``seed``."""
    nb_steps, dt, grid_t = set_time_grid(ttm=ttm, nb_steps_per_year=nb_steps_per_year)
    sdt = float(np.sqrt(dt))
    adj = 0.0 if is_spot_measure else beta
    vartheta2 = beta * beta + volvol * volvol
    vartheta = float(np.sqrt(vartheta2))
    gen = generator_from_seed(seed, device=device)
    sigma = torch.full((nb_path,), float(v0), dtype=torch.float64, device=gen.device)
    log_sigma = torch.log(sigma)
    path = [sigma]
    for _ in range(nb_steps):
        w1 = step_normals(gen, (nb_path,)) * sdt
        log_sigma = log_sigma + ((kappa1 * theta / sigma - kappa1) + kappa2 * (theta - sigma)
                                 + adj * sigma - 0.5 * vartheta2) * dt + vartheta * w1
        sigma = torch.exp(log_sigma)
        path.append(sigma)
    return torch.stack(path).cpu().numpy(), grid_t


def _mc_calibration_slices(grid: ChainGrid, ttms_static: Tuple[float, ...],
                           engine: "CalibrationEngine", nb_path: int, nb_steps: int, seed: int,
                           mc_engine: str, randoms, params0: LogSvParams):
    """the MC calibration's per-slice model vols as a function of the
    parameters: ``slice_vols((sigma0, theta, kappa1, kappa2, beta, volvol),
    etas)`` yields each slice's (K,) implied vols of the MC prices.

    The normal blocks are drawn (or taken from ``randoms``) and moved to the
    grid's device once here, not once an evaluation.  MC: the chained Euler
    over per-slice (steps, paths) blocks at ``nb_steps`` steps/yr; ROUGH_MC:
    every slice restarts from t = 0 on the first steps of one block, on the
    lift of ``params0.nodes``/``weights``.
    """
    device = grid.device
    steps_dts, ttm0 = [], 0.0
    for ttm in ttms_static:
        n, dt, _ = set_time_grid(ttm=ttm - ttm0 if engine == CalibrationEngine.MC else ttm,
                                 nb_steps_per_year=nb_steps)
        steps_dts.append((n, dt))
        ttm0 = ttm
    as_dev = lambda w: torch.as_tensor(w, dtype=torch.float64, device=device)
    if engine == CalibrationEngine.MC:
        if mc_engine not in ("scan", "qmc"):
            raise NotImplementedError(f"mc_engine={mc_engine}")
        if randoms is not None:
            w0s, w1s = ([as_dev(w) for w in ws] for ws in randoms[:2])
        elif mc_engine == "qmc":
            blocks = qmc.qmc_normal_blocks(seed, nb_path, [n for n, _ in steps_dts], device=device)
            w0s, w1s = [b[0] for b in blocks], [b[1] for b in blocks]
        else:
            gen = generator_from_seed(seed, device=device)
            w0s, w1s = [], []
            for n, _ in steps_dts:
                w0s.append(step_normals(gen, (n, nb_path)))
                w1s.append(step_normals(gen, (n, nb_path)))
    else:
        if params0.nodes is None or params0.weights is None:
            raise ValueError("ROUGH_MC needs params0.nodes and params0.weights: "
                             "call params0.approximate_kernel(T) first")
        if randoms is not None:
            z0, z1 = as_dev(randoms[0]), as_dev(randoms[1])
        else:
            gen = generator_from_seed(seed, device=device)
            longest = max(n for n, _ in steps_dts)
            z0, z1 = step_normals(gen, (longest, nb_path)), step_normals(gen, (longest, nb_path))

    def invert(i, prices):
        return bsm.infer_bsm_implied_vol(forward=grid.forwards[i], ttm=grid.ttms[i],
                                         strike=grid.strikes[i], given_price=prices,
                                         discfactor=grid.discfactors[i],
                                         optiontype=grid.optioncodes[i])

    def payoff(i, x, qvar):
        prices, _ = mc_vars_payoff(x, qvar, grid.ttms[i], grid.forwards[i], grid.strikes[i],
                                   grid.optioncodes[i], discfactor=grid.discfactors[i])
        return prices

    def slice_vols(p, etas):
        sigma0, theta, kappa1, kappa2, beta, volvol = p
        if engine == CalibrationEngine.ROUGH_MC:
            vartheta = torch.sqrt(beta * beta + volvol * volvol)
            for i, (n, dt) in enumerate(steps_dts):
                log_s, _, y = log_spot_full_combined_fixed(
                    nodes=params0.nodes, weights=params0.weights, sigma0=sigma0, theta=theta,
                    kappa1=kappa1, kappa2=kappa2, rho=beta / vartheta, volvol=vartheta,
                    timegrid=np.array([0.0, dt]), Z0=z0[:n], Z1=z1[:n], device=device)
                yield invert(i, payoff(i, log_s, y))
            return
        zeros = torch.zeros(nb_path, dtype=torch.float64, device=device)
        x, sig, qv = zeros, sigma0 * torch.ones_like(zeros), zeros
        for i, (_, dt) in enumerate(steps_dts):
            x, sig, qv = simulate_logsv_terminal_fixed(
                w0s[i], w1s[i], dt, x, sig, qv, theta, kappa1, kappa2, beta, volvol,
                vol_backbone_eta=1.0 if etas is None else etas[i])
            yield invert(i, payoff(i, x, qv))

    return slice_vols


# ----------------------------------------------------------------------------
# pricer class
# ----------------------------------------------------------------------------

class LogSVPricer(ModelPricer):
    """ModelPricer for the LogSV model of Eq. (3.12); tensors live on ``device``."""

    def compute_chain_greeks(self, option_chain: OptionChain, params: LogSvParams,
                             greeks=("delta", "gamma", "vega"), **kwargs):
        """model-consistent chain greeks by forward-mode AD through the
        analytic pricer on the pricer's device (``models/greeks.py``)."""
        from stochvolmodels_torch.models.greeks import logsv_chain_greeks
        return logsv_chain_greeks(option_chain=option_chain, params=params, greeks=greeks,
                                  device=self.device, **kwargs)

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
        ``variable_type=Q_VAR`` prices calls on the annualised quadratic
        variance (:func:`qvar_price_panel`, one CUDA graph on the card) at
        720 steps/yr by default: the JAX package's 240 diverges on the QV
        chain's 1m and 3m slices.
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
        year_steps = _YEAR_STEPS[precision]
        if variable_type == VariableType.Q_VAR:
            year_steps = max(year_steps, _QVAR_YEAR_STEPS)
        year_steps = kwargs.pop("year_steps", year_steps)
        kwargs.pop("exact_engine", None)
        if vol_scaler is None:
            vol_scaler = set_vol_scaler(sigma0=params.sigma0, ttm=np.min(option_chain.ttms))
        grid = option_chain.to_grid(device=self.device)
        etas = params.get_vol_backbone_etas(ttms=option_chain.ttms)
        if variable_type == VariableType.Q_VAR:
            return grid, qvar_price_panel(grid, params, tuple(float(t) for t in option_chain.ttms),
                                          etas, year_steps, is_spot_measure=is_spot_measure,
                                          expansion_order=expansion_order)
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

    @annotate(MC_CHAIN_SPAN)
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
        steps per year.  ``engine`` ('scan', 'cuda', 'qmc'), ``antithetic``
        and ``qmc_replicates`` pass to :func:`logsv_mc_chain_pricer`.
        """
        if kwargs.get("use_rough_mc"):
            if kwargs.get("antithetic"):
                raise NotImplementedError("antithetic draws serve the LogSV Euler engine "
                                          "('scan'), not the rough lift")
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
            engine=kwargs.get("engine", "scan"), device=self.device,
            antithetic=kwargs.get("antithetic", False),
            qmc_replicates=kwargs.get("qmc_replicates", 8))

    def simulate_vol_paths(self, params: LogSvParams, ttm: float = 1.0, nb_path: int = 100000,
                           is_spot_measure: bool = True, nb_steps: Optional[int] = None,
                           year_days: int = 360, seed: Optional[int] = None,
                           **kwargs) -> Tuple[np.ndarray, np.ndarray]:
        """vol paths on the pricer's device: :func:`simulate_vol_paths` at
        ``nb_steps or ceil(year_days ttm)`` steps per year (the JAX
        package's call)."""
        nb_steps = nb_steps or int(np.ceil(year_days * ttm))
        return simulate_vol_paths(ttm=ttm, v0=params.sigma0, theta=params.theta,
                                  kappa1=params.kappa1, kappa2=params.kappa2, beta=params.beta,
                                  volvol=params.volvol, nb_path=nb_path,
                                  is_spot_measure=is_spot_measure, nb_steps_per_year=nb_steps,
                                  seed=seed, device=self.device, **kwargs)

    def simulate_terminal_values(self, params: LogSvParams, ttm: float = 1.0,
                                 nb_path: int = 100000, is_spot_measure: bool = True,
                                 seed: Optional[int] = None,
                                 **kwargs) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """terminal (x, sigma, qvar) of the float64 Euler at 360 steps/yr."""
        gen = generator_from_seed(seed, device=self.device)
        f64 = dict(dtype=torch.float64, device=self.device)
        x, sigma, qvar = simulate_logsv_terminal(
            gen=gen, x0=torch.zeros(nb_path, **f64),
            sigma0=torch.full((nb_path,), float(params.sigma0), **f64),
            qvar0=torch.zeros(nb_path, **f64), ttm=ttm, theta=params.theta,
            kappa1=params.kappa1, kappa2=params.kappa2, beta=params.beta,
            volvol=params.volvol, is_spot_measure=is_spot_measure)
        return x.cpu().numpy(), sigma.cpu().numpy(), qvar.cpu().numpy()

    def logsv_pdfs(self, params: LogSvParams, ttm: float, space_grid: np.ndarray,
                   is_spot_measure: bool = True,
                   expansion_order: ExpansionOrder = ExpansionOrder.SECOND,
                   variable_type: VariableType = VariableType.LOG_RETURN,
                   vol_scaler: Optional[float] = None, **kwargs) -> np.ndarray:
        """:func:`logsv_pdfs` on the pricer's device."""
        return logsv_pdfs(params=params, ttm=ttm, space_grid=space_grid,
                          is_spot_measure=is_spot_measure, expansion_order=expansion_order,
                          variable_type=variable_type, vol_scaler=vol_scaler, device=self.device)

    def set_vol_scaler(self, option_chain: OptionChain) -> float:
        """grid scaler from the first ATM vol, frozen across calibration
        iterations."""
        atm0 = option_chain.get_chain_atm_vols()[0]
        return set_vol_scaler(sigma0=atm0, ttm=option_chain.ttms[0])

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

        ``method='lm'``: :func:`calibrate_logsv_lm_on_device` (ANALYTIC
        PARAMS5 only), with ``nb_iters=16`` and ``year_steps=180`` unless given.

        ``calibration_engine=MC`` prices each evaluation by the Euler MC at
        ``nb_steps`` steps/yr on ``nb_path`` paths over normal blocks drawn
        once per fit (frozen across evaluations): ``mc_engine='scan'``
        (default) from a generator seeded by ``seed``, ``'qmc'`` as
        randomized-Sobol blocks; ``randoms=(W0s, W1s)`` supplies the
        per-slice (steps, paths) blocks instead.  ``ROUGH_MC`` runs the rough
        lift of ``params0.nodes``/``weights`` over one block shared by every
        slice (``randoms=(Z0, Z1)`` supplies it).  The gradient flows through
        the steps by autograd.  ``PARAMS_WITH_VARSWAP_FIT`` fits (beta,
        volvol) with the vol backbone solved from the chain's varswap
        strikes at each evaluation (differentiably), and sets the fitted
        backbone on the result.  ``use_float32`` is accepted and mapped to
        float64.
        """
        del use_float32
        method = kwargs.pop("method", "slsqp")
        if method not in ("slsqp", "lm"):
            raise ValueError(f"method must be 'slsqp' or 'lm', got {method!r}")
        mct = model_calibration_type
        if method == "lm":
            if (calibration_engine != CalibrationEngine.ANALYTIC
                    or mct != LogsvModelCalibrationType.PARAMS5):
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
            mct, constraints_type, calibration_engine=calibration_engine, nb_path=nb_path,
            nb_steps=nb_steps, seed=seed, mc_engine=kwargs.pop("mc_engine", "scan"),
            randoms=kwargs.pop("randoms", None))
        options = {"ftol": 1e-8, "maxiter": 200}
        if constraints:
            res = minimize(objective, p0, jac=True, method="SLSQP", constraints=constraints,
                           bounds=bounds, options=options)
        else:
            res = minimize(objective, p0, jac=True, method="SLSQP", bounds=bounds,
                           options=options)
        self.calibration_result = res
        sigma0, theta, kappa1, kappa2, beta, volvol = (float(v) for v in expand(res.x))
        fit = LogSvParams(sigma0=sigma0, theta=theta, kappa1=kappa1, kappa2=kappa2,
                          beta=beta, volvol=volvol, H=params0.H, nodes=params0.nodes,
                          weights=params0.weights)
        if mct == LogsvModelCalibrationType.PARAMS_WITH_VARSWAP_FIT:
            fit.set_vol_backbone(fit_model_vol_backbone_to_varswaps(
                log_sv_params=fit, varswap_strikes=option_chain.get_slice_varswap_strikes(
                    floor_with_atm_vols=True)))
        return fit

    def _slsqp_problem(self, option_chain: OptionChain, params0: LogSvParams,
                       params_min: LogSvParams, params_max: LogSvParams,
                       is_vega_weighted: bool, is_unit_ttm_vega: bool,
                       mct: LogsvModelCalibrationType, constraints_type: ConstraintsType,
                       calibration_engine: CalibrationEngine = CalibrationEngine.ANALYTIC,
                       nb_path: int = 100000, nb_steps: int = 360, seed: int = 10,
                       mc_engine: str = "scan", randoms=None):
        """(objective, p0, bounds, constraints, expand) of the SLSQP fit.

        ``objective(x)`` returns (loss, gradient) as (float, numpy) from one
        forward and one backward pass on the pricer's device; ``expand(x)``
        maps the optimizer vector to (sigma0, theta, kappa1, kappa2, beta,
        volvol); ``constraints`` are scipy's inequality dicts (empty when
        unconstrained).
        """
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
        varswap = None
        if mct == LogsvModelCalibrationType.PARAMS_WITH_VARSWAP_FIT:
            varswap = torch.as_tensor(option_chain.get_slice_varswap_strikes(
                floor_with_atm_vols=True).to_numpy(), **f64)

        def expand(pars):
            """(sigma0, theta, kappa1, kappa2, beta, volvol) of the optimizer
            vector (a numpy array or a tensor)."""
            if mct == LogsvModelCalibrationType.PARAMS4:
                return (pars[0], pars[1], params0.kappa1, params0.kappa2, pars[2], pars[3])
            if mct == LogsvModelCalibrationType.PARAMS5:
                return (pars[0], pars[1], pars[2], pars[2] / pars[1], pars[3], pars[4])
            if mct == LogsvModelCalibrationType.PARAMS6:
                return tuple(pars[i] for i in range(6))
            if mct == LogsvModelCalibrationType.PARAMS_WITH_VARSWAP_FIT:
                return (params0.sigma0, params0.theta, params0.kappa1, params0.kappa2,
                        pars[0], pars[1])
            raise NotImplementedError(f"{mct}")

        def etas_of(sigma0, theta, kappa1, kappa2, beta, volvol):
            """the backbone etas of the varswap fit (a tensor), else None."""
            if varswap is None:
                return None
            return backbone_etas_torch(sigma0, theta, kappa1, kappa2, beta, volvol,
                                       ttms=option_chain.ttms, varswap_strikes=varswap)

        def masked_residual(model_vols, market, weight):
            # mask NaN vols before squaring: where(isnan(r), 0, r) alone would
            # leave a 0 * NaN = NaN in the backward pass
            nan_mask = torch.isnan(model_vols)
            clean = torch.where(nan_mask, market, model_vols)
            resid = weight * torch.square(clean - market)
            return torch.sum(torch.where(nan_mask, 0.0, resid))

        if calibration_engine == CalibrationEngine.ANALYTIC:
            vol_scaler = self.set_vol_scaler(option_chain=option_chain)

            def loss_fn(pars: torch.Tensor) -> torch.Tensor:
                p = expand(pars)
                prices = logsv_chain_price_grid(
                    grid, *p, vol_backbone_etas=etas_of(*p), vol_scaler=vol_scaler,
                    ttms_static=ttms_static, year_steps=_SLSQP_YEAR_STEPS)
                model_vols = bsm.infer_bsm_ivols_from_model_chain_prices(
                    ttms=grid.ttms, forwards=grid.forwards, discfactors=grid.discfactors,
                    strikes_ttms=grid.strikes, optiontypes_ttms=grid.optioncodes,
                    model_prices_ttms=prices)
                return masked_residual(model_vols, market_vols, weights)
        elif calibration_engine in (CalibrationEngine.MC, CalibrationEngine.ROUGH_MC):
            slice_loss = _mc_calibration_slices(
                grid, ttms_static, calibration_engine, nb_path, nb_steps, seed, mc_engine,
                randoms, params0)

            def loss_fn(pars: torch.Tensor) -> torch.Tensor:
                p = expand(pars)
                total = pars.new_zeros(())
                for i, model_vols in enumerate(slice_loss(p, etas_of(*p))):
                    total = total + masked_residual(model_vols, market_vols[i], weights[i])
                return total
        else:
            raise NotImplementedError(f"{calibration_engine}")

        def objective(x: np.ndarray):
            pars = torch.tensor(np.asarray(x, dtype=np.float64), requires_grad=True, **f64)
            loss = loss_fn(pars)
            (grad,) = torch.autograd.grad(loss, pars)
            return float(loss.detach()), grad.cpu().numpy().astype(np.float64)

        names = {LogsvModelCalibrationType.PARAMS4: ("sigma0", "theta", "beta", "volvol"),
                 LogsvModelCalibrationType.PARAMS5: ("sigma0", "theta", "kappa1", "beta",
                                                     "volvol"),
                 LogsvModelCalibrationType.PARAMS6: ("sigma0", "theta", "kappa1", "kappa2",
                                                     "beta", "volvol"),
                 LogsvModelCalibrationType.PARAMS_WITH_VARSWAP_FIT: ("beta", "volvol")}[mct]
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


def logsv_chain_pricer(params: LogSvParams,
                       ttms: np.ndarray,
                       forwards: np.ndarray,
                       discfactors: np.ndarray,
                       strikes_ttms,
                       optiontypes_ttms,
                       is_spot_measure: bool = True,
                       expansion_order: ExpansionOrder = ExpansionOrder.SECOND,
                       variable_type: VariableType = VariableType.LOG_RETURN,
                       vol_scaler: Optional[float] = None,
                       device="cuda",
                       **kwargs) -> List[np.ndarray]:
    """functional chain pricer in the reference's signature: the ragged
    chain priced by :meth:`LogSVPricer.price_chain` on ``device``."""
    chain = OptionChain(ttms=np.asarray(ttms), forwards=np.asarray(forwards),
                        discfactors=np.asarray(discfactors), strikes_ttms=list(strikes_ttms),
                        optiontypes_ttms=list(optiontypes_ttms))
    return LogSVPricer(device=device).price_chain(
        option_chain=chain, params=params, is_spot_measure=is_spot_measure,
        expansion_order=expansion_order, variable_type=variable_type, vol_scaler=vol_scaler)
