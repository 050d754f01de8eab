"""
Hawkes jump-diffusion pricer with self- and cross-exciting jump intensities
(Liu, Packham & Sepp 2025, arXiv:2510.21297).

PyTorch counterpart of ``stochvolmodels_tpu/models/hawkes_jd.py`` for the
serving path.  The model is affine: its log-MGF solves a 3-dim complex
Riccati system, integrated by a float64 RK4 over the whole (N, 3) complex128
transform grid at once, with the ODE state chained across maturities.  The
risk-premia pricer shifts the payoff kernel by gamma and prices against the
gamma-forwards.  Monte Carlo runs intensity thinning at 1800 steps/yr,
either eagerly in float64 (``engine='scan'``) or through the hand-written
CUDA kernel ``csrc/hawkes_mc.cu`` and its plain version (``engine='cuda'``).
On a CUDA device each chain reprice (the ~10^5 small launches of the RK4)
is one captured CUDA graph.  Calibration: the 8-parameter SLSQP with
finite-difference gradients, the (sigma, gamma) risk-premia fit, and
Levenberg-Marquardt with one captured graph per iteration.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from scipy.optimize import OptimizeResult, minimize

from stochvolmodels_torch.config import VariableType
from stochvolmodels_torch.data.option_chain import ChainGrid, OptionChain
from stochvolmodels_torch.models.logsv.pricer import _pad_panel
from stochvolmodels_torch.models.model_pricer import ModelParams, ModelPricer
from stochvolmodels_torch.ops import bsm, graphs, mgf
from stochvolmodels_torch.ops.cuda_mc import engine_setup, simulate_hawkesjd_terminal_kernel
from stochvolmodels_torch.ops.lm import lm_init, lm_step
from stochvolmodels_torch.ops.payoffs import compute_mc_vars_payoff
from stochvolmodels_torch.ops.random import generator_from_seed
from stochvolmodels_torch.utils.funcs import set_time_grid, to_flat_np_array
from stochvolmodels_torch.utils.profiling import MC_CHAIN_SPAN, annotate

MAX_PHI = 500  # transform grid size
MC_STEPS_PER_YEAR = 5 * 360  # small dt for large intensities

# steps per year of the Riccati RK4 for each precision
_YEAR_STEPS = {"exact": 1440, "fast": 720}

# the dynamics of the model, as the MC path loops take them
_SIM_KEYS = ("mu", "sigma", "shift_p", "mean_p", "shift_m", "mean_m", "theta_p", "kappa_p",
             "beta1_p", "beta2_p", "theta_m", "kappa_m", "beta1_m", "beta2_m")


@dataclass
class HawkesJDParams(ModelParams):
    """2-factor Hawkes JD parameters; BTC daily-frequency defaults."""
    mu: float = 0.0
    sigma: float = 0.45
    shift_p: float = 0.06
    mean_p: float = 0.03
    shift_m: float = -0.06
    mean_m: float = -0.03
    lambda_p: float = 6.55
    theta_p: float = 6.55
    kappa_p: float = 22.29
    beta1_p: float = 76.0
    beta2_p: float = -67.58
    lambda_m: float = 8.50
    theta_m: float = 8.50
    kappa_m: float = 29.0
    beta1_m: float = 104.55
    beta2_m: float = -109.6
    risk_premia_gamma: Optional[float] = None

    def __post_init__(self):
        self.compensator_p = np.exp(self.shift_p) / (1.0 - self.mean_p) - 1.0
        self.compensator_m = np.exp(self.shift_m) / (1.0 - self.mean_m) - 1.0

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d.pop('compensator_p', None)
        d.pop('compensator_m', None)
        return d

    def print(self) -> None:
        for k, v in self.to_dict().items():
            print(f"{k}={v}")
        print('conditions')
        print(f"jump1={self.jump1_cond:0.4f} > 0")
        print(f"jump2={self.jump2_cond:0.4f} > 0")

    @property
    def exp_jump_p(self) -> float:
        return self.shift_p + self.mean_p

    @property
    def exp_jump_m(self) -> float:
        return self.shift_m + self.mean_m

    @property
    def jump1_cond(self) -> float:
        """stationarity margin of the positive-jump intensity."""
        return self.kappa_p - self.beta1_p * self.exp_jump_p - self.beta2_p * self.exp_jump_m

    @property
    def jump2_cond(self) -> float:
        """stationarity margin of the negative-jump intensity."""
        return self.kappa_m - self.beta2_m * self.exp_jump_m - self.beta1_m * self.exp_jump_p

    @property
    def jumps_var_p(self) -> float:
        return float(np.square(self.shift_p) + np.square(self.mean_p))

    @property
    def jumps_var_m(self) -> float:
        return float(np.square(self.shift_m) + np.square(self.mean_m))

    def sim_params(self) -> Dict[str, float]:
        """the dynamics the MC path loops take, by name."""
        return {k: float(getattr(self, k)) for k in _SIM_KEYS}


def set_vol_scaler(sigma0: float, ttm: float) -> float:
    """grid scaler: sigma clipped to [0.2, 0.5], times sqrt(min(ttm, 1/12))."""
    return float(np.clip(sigma0, 0.2, 0.5) * np.sqrt(np.minimum(ttm, 1.0 / 12.0)))


# ----------------------------------------------------------------------------
# Riccati ODE over the transform grid
# ----------------------------------------------------------------------------

# the 13 dynamics values and the two compensators of the Riccati system, in the
# order of the JAX package's parameter vector
_PKEYS = ('sigma', 'shift_p', 'mean_p', 'shift_m', 'mean_m', 'kappa_p', 'theta_p', 'beta1_p',
          'beta2_p', 'kappa_m', 'theta_m', 'beta1_m', 'beta2_m', 'compensator_p',
          'compensator_m')


def _ode_params(model_params: HawkesJDParams) -> Dict[str, float]:
    """the 13 dynamics values and the two compensators the Riccati system takes."""
    d = model_params.to_dict()
    p = {k: float(d[k]) for k in _PKEYS[:13]}
    p['compensator_p'] = float(model_params.compensator_p)
    p['compensator_m'] = float(model_params.compensator_m)
    return p


def _rhs_constants(phi: torch.Tensor, psi: torch.Tensor, p: Dict) -> Dict:
    """the A-free terms of the right-hand side, taken once per solve: the
    grid terms (phi (phi + 1)/2 - psi) sigma^2, phi compensator_p and phi
    compensator_m, and the parameter products kappa theta and -shift of each
    side (one kernel each per solve, not per step, when they are tensors)."""
    sigma2 = p['sigma'] * p['sigma']
    return dict(c0=(phi * (phi + 1.0) * 0.5 - psi) * sigma2, c_p=phi * p['compensator_p'],
                c_m=phi * p['compensator_m'], kt_p=p['kappa_p'] * p['theta_p'],
                kt_m=p['kappa_m'] * p['theta_m'], ms_p=-p['shift_p'], ms_m=-p['shift_m'])


def _jump_mgf_minus_one(minus_shift, mean, arg: torch.Tensor) -> torch.Tensor:
    """e^{-s a}/(1 + m a) - 1 in the cancellation-free form
    (expm1(-s a) - m a)/(1 + m a), from -s."""
    ma = arg * mean
    return (torch.expm1(arg * minus_shift) - ma) / (ma + 1.0)


def _hawkes_rhs(A: torch.Tensor, phi: torch.Tensor, consts: Dict, p: Dict) -> torch.Tensor:
    """Riccati right-hand side for the whole (N, 3) complex panel; ``consts``
    are the :func:`_rhs_constants` of the grid and the parameters."""
    a1, a2 = A[:, 1], A[:, 2]
    arg_p = phi - a1 * p['beta1_p'] - a2 * p['beta1_m']
    arg_m = phi - a1 * p['beta2_p'] - a2 * p['beta2_m']
    j_p = _jump_mgf_minus_one(consts['ms_p'], p['mean_p'], arg_p)
    j_m = _jump_mgf_minus_one(consts['ms_m'], p['mean_m'], arg_m)
    r0 = a1 * consts['kt_p'] + a2 * consts['kt_m'] + consts['c0']
    r1 = j_p - a1 * p['kappa_p'] + consts['c_p']
    r2 = j_m - a2 * p['kappa_m'] + consts['c_m']
    return torch.stack([r0, r1, r2], dim=1)


def solve_a_ode_grid(phi_grid: torch.Tensor,
                     ttm: float,
                     model_params: HawkesJDParams,
                     psi_grid: Optional[torch.Tensor] = None,
                     a_t0: Optional[torch.Tensor] = None,
                     nb_steps: Optional[int] = None,
                     year_steps: int = 1440
                     ) -> torch.Tensor:
    """batched RK4 of the Riccati system over the complex128 Phi grid (N,),
    from ``a_t0`` (default 0) over ``ttm`` in max(ceil(year_steps ttm), 16)
    steps; returns A(ttm), (N, 3) complex128 on the grid's device."""
    n_grid = phi_grid.shape[0]
    if psi_grid is None:
        psi_grid = torch.zeros_like(phi_grid)
    if a_t0 is None:
        a_t0 = torch.zeros((n_grid, 3), dtype=phi_grid.dtype, device=phi_grid.device)
    if nb_steps is None:
        nb_steps = _nb_steps(year_steps, float(ttm))
    dt = float(ttm) / nb_steps
    return _solve_a_ode_grid_p(phi_grid, psi_grid, a_t0, nb_steps, dt, _ode_params(model_params))


def _solve_a_ode_grid_p(phi_grid: torch.Tensor, psi_grid: torch.Tensor, a_t0: torch.Tensor,
                        nb_steps: int, dt: float, p: Dict) -> torch.Tensor:
    """RK4 core over a params dict, one eager step at a time.  The values of
    ``p`` are Python floats or 0-dim float64 tensors on the grid's device
    (calibration differentiates through them, a CUDA graph takes them as
    inputs); both give the same bits.  ``dt`` is a host number."""
    consts = _rhs_constants(phi_grid, psi_grid, p)
    rhs = lambda A: _hawkes_rhs(A, phi_grid, consts, p)
    A = a_t0
    for _ in range(nb_steps):
        k1 = rhs(A)
        k2 = rhs(A + k1 * (0.5 * dt))
        k3 = rhs(A + k2 * (0.5 * dt))
        k4 = rhs(A + k3 * dt)
        A = A + (k1 + k2 * 2.0 + k3 * 2.0 + k4) * (dt / 6.0)
    return A


def _nb_steps(year_steps: int, ttm: float) -> int:
    """RK4 steps over ``ttm``: ceil(year_steps ttm), at least 16."""
    return max(int(np.ceil(year_steps * ttm)), 16)


def compute_hawkes_a_mgf_grid(ttm: float,
                              phi_grid: torch.Tensor,
                              model_params: HawkesJDParams,
                              psi_grid: Optional[torch.Tensor] = None,
                              a_t0: Optional[torch.Tensor] = None,
                              year_steps: int = 1440
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A(tau), log MGF = A0 + A1 lambda_p + A2 lambda_m)."""
    a_t1 = solve_a_ode_grid(phi_grid=phi_grid, psi_grid=psi_grid, ttm=ttm,
                            model_params=model_params, a_t0=a_t0, year_steps=year_steps)
    log_mgf = (a_t1[:, 0] + a_t1[:, 1] * float(model_params.lambda_p)
               + a_t1[:, 2] * float(model_params.lambda_m))
    return a_t1, log_mgf


# ----------------------------------------------------------------------------
# chain pricers on the padded panel: parameters as floats or 0-dim tensors
# ----------------------------------------------------------------------------

def _hawkes_chain_price_panel(p: Dict, grid: ChainGrid, *, ttms_static: Tuple[float, ...],
                              lambda_p, lambda_m, vol_scaler, year_steps: int,
                              solve_f32: bool = False, is_spot_measure: bool = True
                              ) -> torch.Tensor:
    """(n_ttm, max_strikes) float64 prices of the padded panel from a params
    dict ``p`` (the 15 :data:`_PKEYS` values), with the Riccati state chained
    across the static maturities.  The values of ``p``, ``lambda_p``,
    ``lambda_m`` and ``vol_scaler`` are Python floats or 0-dim float64
    tensors on the grid's device.  ``solve_f32`` (the JAX package's
    float32 Riccati scans) is accepted and mapped to float64."""
    del solve_f32
    phi_grid, psi_grid, _ = mgf.get_transform_var_grid(max_phi=MAX_PHI, vol_scaler=vol_scaler,
                                                       device=grid.device)
    a_t = torch.zeros((phi_grid.shape[0], 3), dtype=phi_grid.dtype, device=grid.device)
    ttm0 = 0.0
    prices = []
    for i, ttm in enumerate(ttms_static):
        dttm = ttm - ttm0
        nb_steps = _nb_steps(year_steps, dttm)
        a_t = _solve_a_ode_grid_p(phi_grid, psi_grid, a_t, nb_steps, dttm / nb_steps, p)
        log_mgf = a_t[:, 0] + a_t[:, 1] * lambda_p + a_t[:, 2] * lambda_m
        prices.append(mgf.vanilla_prices_with_mgf_grid(
            log_mgf_grid=log_mgf, phi_grid=phi_grid, forwards=grid.forwards[i],
            strikes=grid.strikes[i], optiontypes=grid.optioncodes[i],
            discfactors=grid.discfactors[i], is_spot_measure=is_spot_measure))
        ttm0 = ttm
    return torch.stack(prices, dim=0)


def _hawkes_chain_vols_panel(p: Dict, grid: ChainGrid, **kw) -> torch.Tensor:
    """the price panel inverted by the fast implied vol (bisection + Newton)."""
    price_panel = _hawkes_chain_price_panel(p, grid, **kw)
    return bsm.infer_bsm_implied_vol_fast(
        forward=grid.forwards[:, None], ttm=grid.ttms[:, None], strike=grid.strikes,
        given_price=price_panel, discfactor=grid.discfactors[:, None],
        optiontype=grid.optioncodes)


def _forwards_under_risk(p: Dict, lambda_p, lambda_m, gamma: torch.Tensor,
                         forwards: torch.Tensor, ttms_static: Tuple[float, ...],
                         year_steps: int = 1440) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normalizers, gamma-forwards), (n_ttm,) tensors on ``gamma``'s device,
    from the real MGF at -gamma and -gamma - 1: each maturity is solved from
    0, the two points together as one 2-point grid.  ``gamma`` is a 0-dim
    float64 tensor; nothing leaves the device."""
    zero = torch.zeros_like(gamma)
    phi = torch.complex(torch.stack([-gamma, -gamma - 1.0]), torch.stack([zero, zero]))
    psi = torch.zeros_like(phi)
    a0 = torch.zeros((2, 3), dtype=phi.dtype, device=phi.device)
    normalizers, gamma_forwards = [], []
    for i, ttm in enumerate(ttms_static):
        nb_steps = _nb_steps(year_steps, ttm)
        a_t = _solve_a_ode_grid_p(phi, psi, a0, nb_steps, ttm / nb_steps, p)
        lm0, lm1 = (a_t[:, 0] + a_t[:, 1] * lambda_p + a_t[:, 2] * lambda_m).real.unbind()
        normalizer = torch.exp(lm0).reciprocal()
        normalizers.append(normalizer)
        gamma_forwards.append(forwards[i] * torch.exp(lm1) * normalizer)
    return torch.stack(normalizers), torch.stack(gamma_forwards)


def _hawkes_chain_price_panel_with_risk_premia(p: Dict, grid: ChainGrid, *,
                                               ttms_static: Tuple[float, ...], lambda_p,
                                               lambda_m, gamma: torch.Tensor, vol_scaler,
                                               year_steps: int, is_spot_measure: bool = True
                                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(risk-premia-gamma price panel, gamma-forwards) from a params dict;
    ``gamma`` is a 0-dim float64 tensor on the grid's device."""
    normalizers, gamma_forwards = _forwards_under_risk(p, lambda_p, lambda_m, gamma,
                                                       grid.forwards, ttms_static)
    phi_grid, psi_grid, _ = mgf.get_transform_var_grid(max_phi=MAX_PHI, vol_scaler=vol_scaler,
                                                       real_phi=-0.5 - gamma, device=grid.device)
    a_t = torch.zeros((phi_grid.shape[0], 3), dtype=phi_grid.dtype, device=grid.device)
    ttm0 = 0.0
    prices = []
    for i, ttm in enumerate(ttms_static):
        dttm = ttm - ttm0
        nb_steps = _nb_steps(year_steps, dttm)
        a_t = _solve_a_ode_grid_p(phi_grid, psi_grid, a_t, nb_steps, dttm / nb_steps, p)
        log_mgf = a_t[:, 0] + a_t[:, 1] * lambda_p + a_t[:, 2] * lambda_m
        prices.append(mgf.slice_pricer_with_mgf_grid_with_gamma(
            log_mgf_grid=log_mgf, phi_grid=phi_grid, risk_premia_gamma=gamma, ttm=ttm,
            forward=grid.forwards[i], normalizer=normalizers[i],
            gamma_forward=gamma_forwards[i], strikes=grid.strikes[i],
            optiontypes=grid.optioncodes[i], is_spot_measure=is_spot_measure))
        ttm0 = ttm
    return torch.stack(prices, dim=0), gamma_forwards


def _param_vector(model_params: HawkesJDParams, vol_scaler: float, device) -> torch.Tensor:
    """the reprice's parameters as one float64 tensor on ``device`` (one copy
    from the host): the :data:`_PKEYS` values, lambda_p, lambda_m, the vol
    scaler and gamma (0 when unset)."""
    p = _ode_params(model_params)
    gamma = model_params.risk_premia_gamma
    values = [p[k] for k in _PKEYS] + [float(model_params.lambda_p), float(model_params.lambda_m),
                                       float(vol_scaler), 0.0 if gamma is None else float(gamma)]
    return torch.tensor(values, dtype=torch.float64, device=device)


def _unpack(vector: torch.Tensor):
    """(params dict, lambda_p, lambda_m, vol scaler, gamma) of a
    :func:`_param_vector`, as 0-dim tensors."""
    values = vector.unbind()
    return (dict(zip(_PKEYS, values)),) + tuple(values[len(_PKEYS):])


def _panel_from_vector(vector, ttms, forwards, discfactors, strikes, optioncodes, mask, *,
                       ttms_static, year_steps, is_spot_measure, risk_premia):
    """the reprice on tensors only (so that it can be captured): (prices,)
    or, under the risk-premia measure, (prices, gamma-forwards)."""
    grid = ChainGrid(ttms=ttms, forwards=forwards, discfactors=discfactors, strikes=strikes,
                     optioncodes=optioncodes, mask=mask)
    p, lambda_p, lambda_m, vol_scaler, gamma = _unpack(vector)
    kw = dict(ttms_static=ttms_static, lambda_p=lambda_p, lambda_m=lambda_m,
              vol_scaler=vol_scaler, year_steps=year_steps, is_spot_measure=is_spot_measure)
    if risk_premia:
        return _hawkes_chain_price_panel_with_risk_premia(p, grid, gamma=gamma, **kw)
    return (_hawkes_chain_price_panel(p, grid, **kw),)


def _price_panel(grid: ChainGrid, model_params: HawkesJDParams, vol_scaler: float,
                 ttms_static: Tuple[float, ...], year_steps: int, is_spot_measure: bool
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(price panel, gamma-forwards or None): the risk-premia reprice when
    ``model_params.risk_premia_gamma`` is set.  On a CUDA device the whole
    reprice is one CUDA graph per (panel shape, maturities, ``year_steps``,
    measure, plain or risk-premia), captured at its first call; the
    parameters and the vol scaler are its tensor inputs."""
    static = dict(ttms_static=tuple(float(t) for t in ttms_static), year_steps=int(year_steps),
                  is_spot_measure=bool(is_spot_measure),
                  risk_premia=model_params.risk_premia_gamma is not None)
    inputs = (_param_vector(model_params, vol_scaler, grid.device), grid.ttms, grid.forwards,
              grid.discfactors, grid.strikes, grid.optioncodes, grid.mask)
    fn = lambda *a: _panel_from_vector(*a, **static)
    if graphs.use_graph(inputs[0]):
        key = (tuple(grid.strikes.shape),) + tuple(static.values()) + (str(grid.device),)
        out = graphs.run_captured("hawkes_price", key, fn, inputs)
    else:
        out = fn(*inputs)
    return out[0], (out[1] if static["risk_premia"] else None)


def hawkesjd_chain_pricer(grid: ChainGrid,
                          model_params: HawkesJDParams,
                          is_spot_measure: bool = True,
                          vol_scaler: Optional[float] = None,
                          year_steps: int = 1440,
                          *,
                          ttms_static: Tuple[float, ...]) -> torch.Tensor:
    """Fourier prices of the padded chain panel on the grid's device; returns
    (n_ttm, max_strikes) float64 prices.  Each slice advances the previous
    slice's Riccati state A by ``ttm_i - ttm_{i-1}`` (the grid's maturities,
    given on the host as ``ttms_static``).  One CUDA graph on a card."""
    if vol_scaler is None:
        vol_scaler = set_vol_scaler(sigma0=model_params.sigma, ttm=np.min(ttms_static))
    plain = HawkesJDParams(**{**model_params.to_dict(), "risk_premia_gamma": None})
    return _price_panel(grid, plain, vol_scaler, ttms_static, year_steps, is_spot_measure)[0]


def hawkesjd_forwards_under_risk_kernel(model_params: HawkesJDParams,
                                        risk_premia_gamma: float,
                                        ttms: np.ndarray,
                                        forwards: np.ndarray,
                                        device="cuda"
                                        ) -> Tuple[np.ndarray, np.ndarray]:
    """normalizers and gamma-forwards from the real MGF at -gamma and
    -gamma - 1, each maturity solved from 0 at 1440 steps/yr, as numpy; the
    two points are solved together as one 2-point grid, on the device."""
    params = HawkesJDParams(**{**model_params.to_dict(), "risk_premia_gamma": risk_premia_gamma})
    p, lambda_p, lambda_m, _, gamma = _unpack(_param_vector(params, 0.0, device))
    normalizers, gamma_forwards = _forwards_under_risk(
        p, lambda_p, lambda_m, gamma,
        torch.as_tensor(np.asarray(forwards, dtype=np.float64), device=device),
        tuple(float(t) for t in ttms))
    return normalizers.cpu().numpy(), gamma_forwards.cpu().numpy()


def hawkesjd_chain_pricer_with_risk_premia(grid: ChainGrid,
                                           model_params: HawkesJDParams,
                                           is_spot_measure: bool = True,
                                           vol_scaler: Optional[float] = None,
                                           year_steps: int = 1440,
                                           *,
                                           ttms_static: Tuple[float, ...]) -> torch.Tensor:
    """risk-premia-gamma prices of the padded chain panel on the grid's
    device.  The K^(1+gamma) payoff kernel is dimensionally consistent on
    forward-normalised chains only (strikes ~ 1; see
    ``OptionChain.to_forward_normalised_strikes``).  At gamma = 0 it reduces
    to the standard pricer.  One CUDA graph on a card, the gamma-forwards'
    Riccati solves included."""
    if model_params.risk_premia_gamma is None:
        raise ValueError("the risk-premia pricer needs model_params.risk_premia_gamma")
    if vol_scaler is None:
        vol_scaler = set_vol_scaler(sigma0=model_params.sigma, ttm=np.min(ttms_static))
    return _price_panel(grid, model_params, vol_scaler, ttms_static, year_steps,
                        is_spot_measure)[0]


# ----------------------------------------------------------------------------
# Monte Carlo with intensity thinning
# ----------------------------------------------------------------------------

def simulate_hawkesjd_terminal(gen: torch.Generator,
                               ttm: float,
                               x0: torch.Tensor,
                               lambda_p0: torch.Tensor,
                               lambda_m0: torch.Tensor,
                               mu: float,
                               sigma: float,
                               shift_p: float,
                               mean_p: float,
                               shift_m: float,
                               mean_m: float,
                               theta_p: float,
                               kappa_p: float,
                               beta1_p: float,
                               beta2_p: float,
                               theta_m: float,
                               kappa_m: float,
                               beta1_m: float,
                               beta2_m: float,
                               nb_steps_per_year: int = MC_STEPS_PER_YEAR
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Euler with thinning to the horizon ``ttm``, one eager step at a time in
    the dtype of ``x0``: a jump fires when lambda > -ln(U)/dt, U clamped at
    1e-16.  Each step draws, from ``gen`` in this order, the normal, the two
    thinning uniforms and the two exponential jump sizes."""
    nb_steps, dt, _ = set_time_grid(ttm=ttm, nb_steps_per_year=nb_steps_per_year)
    sdt = float(np.sqrt(dt))
    nb_path = x0.shape[0]
    compensator_p_dt = dt * (np.exp(shift_p) / (1.0 - mean_p) - 1.0)
    compensator_m_dt = dt * (np.exp(shift_m) / (1.0 - mean_m) - 1.0)
    drift_dt = (mu - 0.5 * sigma * sigma) * dt
    draw = dict(generator=gen, dtype=x0.dtype, device=x0.device)
    thin = lambda: -torch.log(torch.clamp(torch.rand(nb_path, **draw), min=1e-16)) / dt
    expo = lambda: torch.empty(nb_path, dtype=x0.dtype, device=x0.device).exponential_(
        generator=gen)
    x, lam_p, lam_m = x0, lambda_p0, lambda_m0
    for _ in range(nb_steps):
        w0 = torch.randn(nb_path, **draw) * sdt
        u_p, u_m = thin(), thin()
        j_p = shift_p + expo() * mean_p
        j_m = shift_m - expo() * (-mean_m)
        diffusion = drift_dt - compensator_p_dt * lam_p - compensator_m_dt * lam_m + sigma * w0
        jump_p = torch.where(lam_p > u_p, j_p, 0.0)
        jump_m = torch.where(lam_m > u_m, j_m, 0.0)
        x = x + diffusion + jump_p + jump_m
        load_p = beta1_p * jump_p + beta2_p * jump_m
        load_m = beta1_m * jump_p + beta2_m * jump_m
        lam_p = lam_p + kappa_p * (theta_p - lam_p) * dt + load_p
        lam_m = lam_m + kappa_m * (theta_m - lam_m) * dt + load_m
    return x, lam_p, lam_m


def hawkesjd_mc_chain_pricer(ttms: np.ndarray,
                             forwards: np.ndarray,
                             discfactors: np.ndarray,
                             strikes_ttms,
                             optiontypes_ttms,
                             lambda_p: float,
                             lambda_m: float,
                             mu: float,
                             sigma: float,
                             shift_p: float,
                             mean_p: float,
                             shift_m: float,
                             mean_m: float,
                             theta_p: float,
                             kappa_p: float,
                             beta1_p: float,
                             beta2_p: float,
                             theta_m: float,
                             kappa_m: float,
                             beta1_m: float,
                             beta2_m: float,
                             nb_path: int = 100000,
                             variable_type: VariableType = VariableType.LOG_RETURN,
                             seed: Optional[int] = None,
                             engine: str = "scan",
                             device="cuda"
                             ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """chain MC with the state (x, lambda_p, lambda_m) carried across
    maturities; returns ragged (prices, stderrs).

    ``engine='cuda'`` (alias ``'pallas'``) runs each slice in float32
    through the hand-written CUDA kernel on a CUDA ``device`` and through its
    plain version on the CPU; slice ``i`` takes the seed ``base + 7919*i``.
    ``engine='scan'`` (default) runs the float64 eager loop with draws from a
    generator seeded by ``seed``.
    """
    if engine == "pallas":
        engine = "cuda"
    if engine not in ("scan", "cuda"):
        raise NotImplementedError(f"engine={engine}")
    device = torch.device(device)
    sim_params = dict(mu=mu, sigma=sigma, shift_p=shift_p, mean_p=mean_p, shift_m=shift_m,
                      mean_m=mean_m, theta_p=theta_p, kappa_p=kappa_p, beta1_p=beta1_p,
                      beta2_p=beta2_p, theta_m=theta_m, kappa_m=kappa_m, beta1_m=beta1_m,
                      beta2_m=beta2_m)
    if engine == "cuda":
        nb_pad, base_seed = engine_setup(seed, nb_path)
        dtype = torch.float32
    else:
        nb_pad, gen = nb_path, generator_from_seed(seed, device=device)
        dtype = torch.float64
    x = torch.zeros(nb_pad, dtype=dtype, device=device)
    lam_p = torch.full((nb_pad,), float(lambda_p), dtype=dtype, device=device)
    lam_m = torch.full((nb_pad,), float(lambda_m), dtype=dtype, device=device)
    ttm0 = 0.0
    option_prices_ttm, option_std_ttm = [], []
    for i, ttm in enumerate(ttms):
        if engine == "cuda":
            x, lam_p, lam_m = simulate_hawkesjd_terminal_kernel(
                seed=base_seed + 7919 * i, x0=x, lambda_p0=lam_p, lambda_m0=lam_m,
                ttm=float(ttm - ttm0), **sim_params)
        else:
            x, lam_p, lam_m = simulate_hawkesjd_terminal(
                gen=gen, ttm=float(ttm - ttm0), x0=x, lambda_p0=lam_p, lambda_m0=lam_m,
                **sim_params)
        ttm0 = float(ttm)
        xp = x[:nb_path]
        prices, stds = compute_mc_vars_payoff(
            x0=xp, sigma0=xp, qvar0=xp, ttm=ttm, forward=forwards[i],
            strikes_ttm=strikes_ttms[i], optiontypes_ttm=optiontypes_ttms[i],
            discfactor=discfactors[i], variable_type=variable_type)
        option_prices_ttm.append(prices)
        option_std_ttm.append(stds)
    return option_prices_ttm, option_std_ttm


# ----------------------------------------------------------------------------
# pricer class
# ----------------------------------------------------------------------------

class HawkesJDPricer(ModelPricer):
    """ModelPricer for the Hawkes jump-diffusion model; tensors live on
    ``device``."""

    def price_chain(self, option_chain: OptionChain, params: HawkesJDParams,
                    is_spot_measure: bool = True,
                    variable_type: VariableType = VariableType.LOG_RETURN,
                    vol_scaler: Optional[float] = None,
                    precision: str = "exact",
                    **kwargs) -> List[np.ndarray]:
        """analytic chain prices in float64; the risk-premia pricer when
        ``params.risk_premia_gamma`` is set.

        ``precision='exact'`` (default) runs the Riccati RK4 at 1440
        steps/yr.  ``'fast'`` (mixed precision in the JAX package, standard
        measure only) runs the same float64 path at 720 steps/yr; with a
        gamma it runs the exact path, as in the JAX package.  ``year_steps=``
        overrides.  On a CUDA device the reprice is one CUDA graph.
        """
        _, prices, _ = self._price_panel(option_chain, params, is_spot_measure=is_spot_measure,
                                         variable_type=variable_type, vol_scaler=vol_scaler,
                                         precision=precision, **kwargs)
        return option_chain.unpad_panel(prices)

    def _price_panel(self, option_chain: OptionChain, params: HawkesJDParams,
                     is_spot_measure: bool = True,
                     variable_type: VariableType = VariableType.LOG_RETURN,
                     vol_scaler: Optional[float] = None,
                     precision: str = "exact",
                     **kwargs) -> Tuple[ChainGrid, torch.Tensor, Optional[torch.Tensor]]:
        """(grid, padded price panel, gamma-forwards or None) of
        :meth:`price_chain`."""
        if precision not in _YEAR_STEPS:
            raise NotImplementedError(f"precision={precision}")
        if variable_type != VariableType.LOG_RETURN:
            raise NotImplementedError(f"variable_type={variable_type}")
        default_steps = _YEAR_STEPS[precision if params.risk_premia_gamma is None else "exact"]
        year_steps = kwargs.pop("year_steps", default_steps)
        if vol_scaler is None:
            vol_scaler = set_vol_scaler(sigma0=params.sigma, ttm=np.min(option_chain.ttms))
        grid = option_chain.to_grid(device=self.device)
        prices, gamma_forwards = _price_panel(
            grid, params, float(vol_scaler), tuple(float(t) for t in option_chain.ttms),
            year_steps, is_spot_measure)
        return grid, prices, gamma_forwards

    def compute_chain_prices_with_vols(self, option_chain: OptionChain,
                                       params: HawkesJDParams, **kwargs
                                       ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """prices and implied vols (the 200-step bisection); under the risk
        kernel the vols are implied against the gamma-forwards of the same
        reprice."""
        _, prices, gamma_forwards = self._price_panel(option_chain, params, **kwargs)
        model_prices = option_chain.unpad_panel(prices)
        model_forwards = None if gamma_forwards is None else gamma_forwards.cpu().numpy()
        model_ivols = option_chain.compute_model_ivols_from_chain_data(
            model_prices=model_prices, forwards=model_forwards, device=self.device)
        return model_prices, model_ivols

    def compute_model_ivols_for_chain(self, option_chain: OptionChain, params: HawkesJDParams,
                                      precision: str = "exact", **kwargs) -> List[np.ndarray]:
        """model implied vols for the chain.

        ``precision='exact'`` prices at 1440 steps/yr and inverts by the
        200-step bisection (two CUDA graphs on a card).  ``'fast'`` with no
        gamma prices at 720 steps/yr (float64) and inverts by the fast
        implied vol (bisection + Newton), NaN on padded slots, as the JAX
        package's fused fast path does; with a gamma it runs the exact path.
        """
        if precision != "fast" or params.risk_premia_gamma is not None:
            return super().compute_model_ivols_for_chain(
                option_chain=option_chain, params=params, precision=precision, **kwargs)
        grid, prices, _ = self._price_panel(option_chain, params, precision=precision, **kwargs)
        vols = bsm.infer_bsm_implied_vol_fast(
            forward=grid.forwards[:, None], ttm=grid.ttms[:, None], strike=grid.strikes,
            given_price=prices, discfactor=grid.discfactors[:, None],
            optiontype=grid.optioncodes)
        return option_chain.unpad_panel(torch.where(grid.mask, vols, torch.nan))

    @annotate(MC_CHAIN_SPAN)
    def model_mc_price_chain(self, option_chain: OptionChain, params: HawkesJDParams,
                             nb_path: int = 100000, seed: Optional[int] = None,
                             variable_type: VariableType = VariableType.LOG_RETURN,
                             **kwargs) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """MC chain prices and standard errors at 1800 steps/yr on the
        pricer's device (``engine='scan'`` or ``'cuda'``/``'pallas'``)."""
        return hawkesjd_mc_chain_pricer(
            ttms=option_chain.ttms, forwards=option_chain.forwards,
            discfactors=option_chain.discfactors, strikes_ttms=option_chain.strikes_ttms,
            optiontypes_ttms=option_chain.optiontypes_ttms, nb_path=nb_path, seed=seed,
            variable_type=variable_type, engine=kwargs.get("engine", "scan"),
            device=self.device, lambda_p=params.lambda_p, lambda_m=params.lambda_m,
            **params.sim_params())

    def simulate_terminal_values(self, params: HawkesJDParams, ttm: float = 1.0,
                                 nb_path: int = 100000, seed: Optional[int] = None, **kwargs
                                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """terminal (x, lambda_p, lambda_m) of the float64 eager engine, as numpy."""
        f64 = dict(dtype=torch.float64, device=self.device)
        x, lam_p, lam_m = simulate_hawkesjd_terminal(
            gen=generator_from_seed(seed, device=self.device), ttm=ttm,
            x0=torch.zeros(nb_path, **f64),
            lambda_p0=torch.full((nb_path,), float(params.lambda_p), **f64),
            lambda_m0=torch.full((nb_path,), float(params.lambda_m), **f64),
            **params.sim_params())
        return x.cpu().numpy(), lam_p.cpu().numpy(), lam_m.cpu().numpy()

    def calibrate_model_params_to_chain(self,
                                        option_chain: OptionChain,
                                        params0: HawkesJDParams,
                                        is_vega_weighted: bool = True,
                                        is_unit_ttm_vega: bool = False,
                                        **kwargs) -> HawkesJDParams:
        """8-parameter SLSQP of [sigma, mean_p, mean_m, theta_p, theta_m,
        kappa, beta_p, beta_m] with the stationarity constraint jump1_cond +
        jump2_cond >= 0, as in the JAX package: scipy's finite-difference
        gradients, ``ftol`` 1e-8, ``maxiter`` 100.  Each objective
        evaluation is the exact reprice (1440 steps/yr) and the 200-step
        bisection at the vol scaler frozen from ``params0``: two CUDA graph
        launches on a card.  NaN vols drop out of the vega-weighted sum.
        scipy's result is kept as ``self.calibration_result``.

        ``method='lm'`` runs :func:`calibrate_hawkesjd_lm_on_device`
        (``nb_iters=16``, ``year_steps=720`` unless given) and keeps its best
        cost as ``self.calibration_result.fun``; any other method raises
        ``ValueError``.
        """
        method = kwargs.pop('method', 'slsqp')
        if method == 'lm':
            nb_iters = kwargs.pop('nb_iters', 16)
            fit, cost = calibrate_hawkesjd_lm_on_device(
                option_chain=option_chain, params0=params0, is_vega_weighted=is_vega_weighted,
                nb_iters=nb_iters, year_steps=kwargs.pop('year_steps', 720),
                use_float32=kwargs.pop('use_float32', None), device=self.device)
            self.calibration_result = OptimizeResult(fun=cost, nit=nb_iters)
            return fit
        if method != 'slsqp':
            raise ValueError(f"method must be 'slsqp' or 'lm', got {method!r}")
        objective, jump_cond, p0, bounds, unpack_pars = self._slsqp_problem(
            option_chain, params0, is_vega_weighted, is_unit_ttm_vega)
        constraints = ({'type': 'ineq', 'fun': jump_cond})
        options = {'ftol': 1e-8, 'maxiter': 100}
        res = minimize(objective, p0, args=None, method='SLSQP', constraints=constraints,
                       bounds=bounds, options=options)
        self.calibration_result = res
        return unpack_pars(pars=res.x)

    def _slsqp_problem(self, option_chain: OptionChain, params0: HawkesJDParams,
                       is_vega_weighted: bool, is_unit_ttm_vega: bool):
        """(objective, jump_cond, p0, bounds, unpack_pars) of the 8-parameter
        SLSQP fit, as the JAX package builds them."""
        _, y = option_chain.get_chain_data_as_xy()
        market_vols = to_flat_np_array(y)
        if is_vega_weighted:
            vegas_ttms = option_chain.get_chain_vegas(is_unit_ttm_vega=is_unit_ttm_vega)
            weights = to_flat_np_array([v / np.sum(v) for v in vegas_ttms])
        else:
            weights = np.ones_like(market_vols)
        p0 = np.array([params0.sigma, params0.mean_p, params0.mean_m, params0.theta_p,
                       params0.theta_m, 0.5 * (params0.kappa_p + params0.kappa_m),
                       0.5 * (params0.beta1_p - params0.beta2_p),
                       0.5 * (params0.beta2_p - params0.beta2_m)])
        bounds = ((0.10, 2.0), (0.01, 0.99), (-0.99, -0.01), (0.01, 100.0), (0.01, 100.0),
                  (1.0, 100.0), (1.0, 100.0), (1.0, 100.0))
        vol_scaler = set_vol_scaler(sigma0=params0.sigma, ttm=np.min(option_chain.ttms))

        def unpack_pars(pars: np.ndarray) -> HawkesJDParams:
            sigma, mean_p, mean_m, theta_p, theta_m, kappa, beta_p, beta_m = pars
            return HawkesJDParams(mu=0.0, sigma=sigma, shift_p=params0.shift_p, mean_p=mean_p,
                                  shift_m=params0.shift_m, mean_m=mean_m,
                                  lambda_p=params0.lambda_p, theta_p=theta_p, kappa_p=kappa,
                                  beta1_p=beta_p, beta2_p=-beta_p, lambda_m=params0.lambda_m,
                                  theta_m=theta_m, kappa_m=kappa, beta1_m=beta_m,
                                  beta2_m=-beta_m)

        def objective(pars: np.ndarray, args=None) -> float:
            model_vols = self.compute_model_ivols_for_chain(
                option_chain=option_chain, params=unpack_pars(pars=pars), vol_scaler=vol_scaler)
            return float(np.nansum(weights * np.square(to_flat_np_array(model_vols)
                                                       - market_vols)))

        def jump_cond(pars: np.ndarray) -> float:
            params = unpack_pars(pars=pars)
            return params.jump1_cond + params.jump2_cond

        return objective, jump_cond, p0, bounds, unpack_pars

    def calibrate_risk_premia_gamma_to_chain(self,
                                             option_chain: OptionChain,
                                             params0: HawkesJDParams,
                                             is_vega_weighted: bool = True,
                                             is_unit_ttm_vega: bool = False,
                                             maxiter: int = 100,
                                             print_iter: bool = False,
                                             **kwargs) -> HawkesJDParams:
        """2-parameter (sigma, gamma / 8) risk-premia fit by SLSQP with
        scipy's finite differences (``eps`` 0.025), weights x 10000, as in
        the JAX package.  Each objective evaluation is the risk-premia
        reprice (one CUDA graph on a card, the gamma-forwards included) and
        the 200-step bisection against the gamma-forwards.

        As in the JAX package, the fit writes sigma and gamma into
        ``params0`` itself at every evaluation and returns ``params0``.
        scipy's result is kept as ``self.calibration_result``.
        """
        objective, p0, bounds, unpack_pars = self._gamma_problem(
            option_chain, params0, is_vega_weighted, is_unit_ttm_vega, print_iter)
        options = {'ftol': 1e-16, 'maxiter': maxiter, 'eps': 0.025}
        res = minimize(objective, p0, args=None, method='SLSQP', bounds=bounds,
                       options=options, tol=1e-16)
        self.calibration_result = res
        return unpack_pars(pars=res.x)

    def _gamma_problem(self, option_chain: OptionChain, params0: HawkesJDParams,
                       is_vega_weighted: bool, is_unit_ttm_vega: bool, print_iter: bool):
        """(objective, p0, bounds, unpack_pars) of the risk-premia fit;
        ``unpack_pars`` writes into ``params0`` and returns it."""
        _, y = option_chain.get_chain_data_as_xy()
        market_vols = to_flat_np_array(y)
        if is_vega_weighted:
            vegas_ttms = option_chain.get_chain_vegas(is_unit_ttm_vega=is_unit_ttm_vega)
            weights = 10000.0 * to_flat_np_array([v / np.sum(v) for v in vegas_ttms])
        else:
            weights = 10000.0 * np.ones_like(market_vols)
        gamma_scaler = 8.0
        p0 = np.array([params0.sigma, params0.risk_premia_gamma / gamma_scaler])
        bounds = ((0.01, 1.5), (-1.0, 1.0))

        def unpack_pars(pars: np.ndarray) -> HawkesJDParams:
            model_params = params0
            model_params.sigma = pars[0]
            model_params.risk_premia_gamma = gamma_scaler * pars[1]
            if print_iter:
                print(f"unpack_pars: sigma={pars[0]}, gamma={model_params.risk_premia_gamma}")
            return model_params

        def objective(pars: np.ndarray, args=None) -> float:
            model_vols = self.compute_model_ivols_for_chain(
                option_chain=option_chain, params=unpack_pars(pars=pars))
            return float(np.nansum(weights * np.square(to_flat_np_array(model_vols)
                                                       - market_vols)))

        return objective, p0, bounds, unpack_pars


# ----------------------------------------------------------------------------
# Levenberg-Marquardt calibration on the device
# ----------------------------------------------------------------------------

HAWKES_LM_LOWER = np.array([0.10, 0.01, -0.99, 0.01, 0.01, 1.0, 1.0, 1.0])
HAWKES_LM_UPPER = np.array([2.0, 0.99, -0.01, 100.0, 100.0, 100.0, 100.0, 100.0])


def _pars8_to_dict(pars: torch.Tensor, shift_p, shift_m) -> Dict[str, torch.Tensor]:
    """the params dict of the 8-parameter vector [sigma, mean_p, mean_m,
    theta_p, theta_m, kappa, beta_p, beta_m] (the SLSQP fit's reduction:
    kappa_p = kappa_m = kappa, beta2_p = -beta_p, beta2_m = -beta_m)."""
    sigma, mean_p, mean_m, theta_p, theta_m, kappa, beta_p, beta_m = pars.unbind()
    return dict(sigma=sigma, shift_p=shift_p, mean_p=mean_p, shift_m=shift_m, mean_m=mean_m,
                kappa_p=kappa, theta_p=theta_p, beta1_p=beta_p, beta2_p=-beta_p, kappa_m=kappa,
                theta_m=theta_m, beta1_m=beta_m, beta2_m=-beta_m,
                compensator_p=torch.exp(shift_p) / (1.0 - mean_p) - 1.0,
                compensator_m=torch.exp(shift_m) / (1.0 - mean_m) - 1.0)


def _hawkes_lm_residuals(ttms, forwards, discfactors, strikes, optioncodes, mask, market, sqrtw,
                         consts, *, ttms_static, year_steps):
    """the LM residual function of the 8-parameter vector: sqrt-weighted
    fast-IV errors (0 where the model vol is NaN) and sqrt(10) x the
    stationarity gap max(-(jump1_cond + jump2_cond), 0).  ``consts`` =
    [shift_p, shift_m, lambda_p, lambda_m, vol_scaler]."""
    grid = ChainGrid(ttms=ttms, forwards=forwards, discfactors=discfactors, strikes=strikes,
                     optioncodes=optioncodes, mask=mask)
    shift_p, shift_m, lambda_p, lambda_m, vol_scaler = consts.unbind()
    sqrt10 = math.sqrt(10.0)

    def residuals(pars):
        vols = _hawkes_chain_vols_panel(
            _pars8_to_dict(pars, shift_p, shift_m), grid, ttms_static=ttms_static,
            lambda_p=lambda_p, lambda_m=lambda_m, vol_scaler=vol_scaler, year_steps=year_steps)
        nan_mask = torch.isnan(vols)
        clean = torch.where(nan_mask, market, vols)
        r = (sqrtw * (clean - market)).reshape(-1)
        exp_jp = shift_p + pars[1]
        exp_jm = shift_m + pars[2]
        j1 = pars[5] - pars[6] * exp_jp + pars[6] * exp_jm
        j2 = pars[5] - pars[7] * exp_jp + pars[7] * exp_jm
        penalty = torch.clamp(-(j1 + j2), min=0.0)
        return torch.cat([r, (sqrt10 * penalty)[None]])

    return residuals


def _hawkes_lm_init(p0, *problem, ttms_static, year_steps):
    """the LM state at ``p0`` (so that it can be captured)."""
    return lm_init(_hawkes_lm_residuals(*problem[:-2], ttms_static=ttms_static,
                                        year_steps=year_steps), p0)


def _hawkes_lm_step(pars, lam, best_pars, best_cost, *problem, ttms_static, year_steps):
    """one LM iteration on tensors only (so that it can be captured)."""
    residuals = _hawkes_lm_residuals(*problem[:-2], ttms_static=ttms_static,
                                     year_steps=year_steps)
    return lm_step(residuals, (pars, lam, best_pars, best_cost), problem[-2], problem[-1])


def _hawkes_lm_run(p0, *problem, ttms_static, year_steps, nb_iters):
    """the whole LM fit, (best parameters, best cost): the initial state,
    then ``nb_iters`` steps.  On a CUDA device the initial state and the
    step are each one CUDA graph per (panel shape, maturities,
    ``year_steps``), and the step's graph is replayed ``nb_iters`` times.
    ``problem`` = (ttms, forwards, discfactors, strikes, optioncodes, mask,
    market, sqrtw, consts, lower, upper)."""
    static = dict(ttms_static=ttms_static, year_steps=year_steps)
    init = lambda *a: _hawkes_lm_init(*a, **static)
    step = lambda *a: _hawkes_lm_step(*a, **static)
    if graphs.use_graph(p0):
        key = (tuple(problem[3].shape), ttms_static, year_steps, str(p0.device))
        state = graphs.run_captured("hawkes_lm_init", key, init, (p0,) + problem)
        for _ in range(nb_iters):
            state = graphs.run_captured("hawkes_lm_step", key, step, state + problem)
    else:
        state = init(p0, *problem)
        for _ in range(nb_iters):
            state = step(*state, *problem)
    return state[2], state[3]


def calibrate_hawkesjd_lm_on_device(option_chain: OptionChain,
                                    params0: HawkesJDParams,
                                    nb_iters: int = 16,
                                    year_steps: int = 720,
                                    use_float32: Optional[bool] = None,
                                    is_vega_weighted: bool = True,
                                    device="cuda",
                                    ) -> Tuple[HawkesJDParams, float]:
    """8-parameter Hawkes calibration by Levenberg-Marquardt on the device;
    returns (params, final weighted cost).

    Each iteration prices the chain (the Riccati RK4 chained across
    maturities at ``year_steps``), inverts by the fast implied vol and
    takes the 8-column Jacobian by one ``jacfwd`` pass; the stationarity
    condition is a sqrt(10)-scaled one-sided penalty residual, the box
    :data:`HAWKES_LM_LOWER`/:data:`HAWKES_LM_UPPER` a projection.  On a CUDA
    device one iteration is one CUDA graph, replayed ``nb_iters`` times (a
    graph of the whole fit would hold millions of nodes).  ``use_float32`` is
    accepted for signature parity and mapped to float64.
    """
    del use_float32
    f64 = dict(dtype=torch.float64, device=device)
    grid = option_chain.to_grid(device=device)
    market_panel = _pad_panel(option_chain.get_mid_vols(), grid)
    if is_vega_weighted:
        weights_panel = _pad_panel([v / np.sum(v) for v in option_chain.get_chain_vegas()], grid)
    else:
        weights_panel = np.ones_like(market_panel)
    mask = grid.mask.cpu().numpy()
    p0 = np.array([params0.sigma, params0.mean_p, params0.mean_m, params0.theta_p,
                   params0.theta_m, 0.5 * (params0.kappa_p + params0.kappa_m),
                   params0.beta1_p, params0.beta1_m])
    vol_scaler = set_vol_scaler(sigma0=params0.sigma, ttm=np.min(option_chain.ttms))
    consts = [params0.shift_p, params0.shift_m, params0.lambda_p, params0.lambda_m, vol_scaler]
    problem = (grid.ttms, grid.forwards, grid.discfactors, grid.strikes, grid.optioncodes,
               grid.mask, torch.as_tensor(np.where(mask, market_panel, 0.0), **f64),
               torch.as_tensor(np.sqrt(np.where(mask, weights_panel, 0.0)), **f64),
               torch.as_tensor(np.asarray(consts, dtype=np.float64), **f64),
               torch.as_tensor(HAWKES_LM_LOWER, **f64), torch.as_tensor(HAWKES_LM_UPPER, **f64))
    best, cost = _hawkes_lm_run(torch.as_tensor(p0, **f64), *problem,
                                ttms_static=tuple(float(t) for t in option_chain.ttms),
                                year_steps=int(year_steps), nb_iters=int(nb_iters))
    b = best.cpu().numpy().astype(np.float64)
    fit = HawkesJDParams(mu=0.0, sigma=b[0], shift_p=params0.shift_p, mean_p=b[1],
                         shift_m=params0.shift_m, mean_m=b[2], lambda_p=params0.lambda_p,
                         theta_p=b[3], kappa_p=b[5], beta1_p=b[6], beta2_p=-b[6],
                         lambda_m=params0.lambda_m, theta_m=b[4], kappa_m=b[5], beta1_m=b[7],
                         beta2_m=-b[7])
    return fit, float(cost)
